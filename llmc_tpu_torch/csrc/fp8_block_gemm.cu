// fp8_block_gemm: the blockwise-scaled FP8 GEMM on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/fp8_gemm.py::_kernel_fp8 (the Pallas TPU kernel,
// pallas_call at :73).  Same function, with scale blocks of bs columns and
// bs weight rows, kb = k / bs:
//   y[m,n] = sum_kb ( sum_{k in kb} x[m,k] * w[n,k] ) * xs[m,kb] * ws[n/bs,kb]
// x, w are e4m3 codes, every product is exact in f32, each bs-wide block
// is summed in f32, scaled by its two f32 scales, and added to an f32
// running sum.
//
// Layout.  x [M, K] e4m3; xs [M, K/bs] f32; w [N, K] e4m3; ws
// [ceil(N/bs), K/bs] f32 (the checkpoint's weight_scale_inv); all as
// stored, but for two row strides: w's rows are ldw >= K bytes apart, and
// x is converted into rows of ldx f16, ldx a multiple of 8.  TMA reads w
// where ldw and w's address are multiples of 16 (its global stride's
// unit; weight_cast_to_fp8 pads a row of any K to one with zero codes when
// it packs the weight); else (a checkpoint's codes, or a padded cast moved
// by .to(), which drops the padding) the producer warp loads each weight
// tile itself into the layout TMA would give.  bs is a multiple of 64 that
// divides K, or K itself (then K takes any value: the last unit's columns
// past K are zero in both operands).  N takes any value: the weight rows
// past N are zero, and the epilogue writes none.  A block is
// bu = ceil(bs / 64) units of the K loop.  A step takes SU units: two where
// bs is a multiple of 128, else one (a template argument: no branch between
// the wgmma instructions of a step).  Every step starts a fresh partial
// (scale-d 0) and promotes it, acc += part * xs[m,kb] * ws[n/bs,kb], with
// its block's scales.  A block of 256 columns or more is thus promoted in
// pieces of 128, with the same scales: the same function, summed in shorter
// f32 pieces.  bs is a multiple of 16, so each 16-row group of the CTA's 128
// weight rows lies in one row of ws (bs = 64 puts two rows of ws under a
// CTA); a whole-K block of a K that is no multiple of 16 can end inside a
// 16-row group, and there each thread reads its two rows' ws values before
// the K loop.
//
// What bounds it on an H100: below about M = 600 the weight stream, one
// byte a weight — the card's memory rate; above it the tensor cores.  It
// runs on the skeleton of wgmma_common.cuh with B1's loop: wgmma.mma_async
// m64nTk16 f16 x f16 -> f32 in the RS form, the e4m3 weight codes decoded
// in registers to f16 (exact: e4m3 is a subset of f16; one cvt per two
// codes) as A, and x as B from shared memory by TMA, converted to f16 once
// per call by a first kernel (e4m3_to_f16_kernel, 3 bytes an element).
// xs is [M, K/bs], strided by token, which TMA cannot take (a row stride
// of 4 K / bs bytes need not be a multiple of 16): the producer warp's
// lanes copy a step's T values by cp.async into a box beside the stage of
// the step's first unit, with the step's ws value of each 16-row group in
// a second box, and the copies arrive on the stage's barrier as they land.
// The producer never waits on a load, and neither loop divides (the block
// counts come from the host).
//
// Why not the fp8 tensor cores: wgmma m64nTk32 e4m3 x e4m3 -> f32 keeps
// too few bits inside one instruction's sum (DeepSeek-V3's report reads
// about 14 on an H800).  That design, both operands e4m3 by TMA in the SS
// form, was faster and read off the float64 oracle by more than
// chip_smoke.py's 1e-5 even with every k32 step promoted (PERF.md).
// chip_smoke.py holds the kernel against that oracle on random data and
// on a block whose products span 20 bits (fp8_adder_probe).

#include <cuda_fp8.h>

#include <type_traits>

#include "wgmma_common.cuh"

namespace {

using namespace wg;

// two e4m3 codes (the low byte first) -> f16x2, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v & 0xFFFFu), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// x [n16 x 16] e4m3 -> f16, 16 codes a thread
__global__ void __launch_bounds__(256) e4m3_to_f16_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ y, size_t n16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n16) return;
  const uint4 v = x[i];
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = e4m3x2_to_f16x2(w[k]);
    o[2 * k + 1] = e4m3x2_to_f16x2(w[k] >> 16);
  }
  y[2 * i] = make_uint4(o[0], o[1], o[2], o[3]);
  y[2 * i + 1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// x [M, K] e4m3 -> y [M, ldy] f16, an element a thread, zeros past K (a K
// whose rows are no whole 16-byte pieces)
__global__ void __launch_bounds__(256) e4m3_rows_to_f16_kernel(
    const uint8_t* __restrict__ x, uint16_t* __restrict__ y, int M, int K,
    int ldy) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * ldy) return;
  const int m = (int)(i / ldy), k = (int)(i % ldy);
  y[i] = k < K ? __nv_cvt_fp8_to_halfraw(x[(size_t)m * K + k], __NV_E4M3).x
               : 0;
}

// The weight tile [ROWS x UNIT] of rows n0.. and columns k0.. of w (rows
// ldw bytes apart) into dst as TMA would store it under the 64-byte
// swizzle (16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3)), zeros
// past N and K, by the 32 lanes of a warp in loads of V bytes (V divides
// ldw, K and w's address)
template <int V>
__device__ __forceinline__ void load_w_tile(uint8_t* dst,
                                            const uint8_t* __restrict__ w,
                                            int ldw, int N, int K, int n0,
                                            int k0, int lane) {
  using P = typename std::conditional<
      V == 8, uint2,
      typename std::conditional<
          V == 4, uint32_t,
          typename std::conditional<V == 2, uint16_t,
                                    uint8_t>::type>::type>::type;
  constexpr int PR = UNIT / V;  // pieces a row
#pragma unroll 4
  for (int i = lane; i < ROWS * PR; i += 32) {
    const int r = i / PR, c = (i % PR) * V;
    P v{};
    if (n0 + r < N && k0 + c < K)
      v = *reinterpret_cast<const P*>(w + (size_t)(n0 + r) * ldw + k0 + c);
    *reinterpret_cast<P*>(dst + r * UNIT + (((c >> 4) ^ ((r >> 1) & 3)) << 4) +
                          (c & 15)) = v;
  }
}

// 4-byte asynchronous copy global -> shared
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

template <int T, bool OUT_F32, int SU>
__global__ void __launch_bounds__(NTHREADS, 1) fp8_block_gemm_kernel(
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx, const float* __restrict__ xs,
    const float* __restrict__ ws, void* __restrict__ out,
    float* __restrict__ partial, const uint8_t* __restrict__ wp, int ldw,
    int wv, int M, int N, int K, int bs, int kb, int bu,
    int blocks_per_split) {
  // a stage: the weight tile [128 x 64 e4m3] and the x box [T x 64 f16];
  // beside the ring two boxes a stage: the step's T token scales and the
  // ws value of each 16-row group of the CTA's weight rows
  using L = Layout<T, 1, 2>;
  constexpr int S = L::STAGES;
  constexpr int BOX = L::SUM_BOX / 4;  // floats a box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* xsb = reinterpret_cast<float*>(smem + L::RING);  // [S][2] boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  // output tiles with the weight-row tiles fastest
  const int nt = (N + ROWS - 1) / ROWS;
  const int m0 = (blockIdx.x / nt) * T, n0 = (blockIdx.x % nt) * ROWS;
  // kb blocks of bu units, from the host: no division in the loops
  const int units = (K + UNIT - 1) / UNIT;
  const int b0 = blockIdx.z * blocks_per_split, u0 = b0 * bu;
  const int nu = max(0, min(units, u0 + blocks_per_split * bu) - u0);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      // the TMA thread's arrival with the bytes, then all 32 producer
      // lanes' as their scales land
      mbar_init(&full[i], 1 + 32);
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: lane 0 issues the TMA loads (where wp is given, the
    // lanes first store the weight tile themselves, before lane 0's
    // arrival); with a step's first unit
    // the lanes copy the step's token scales (rows past M repeat row M - 1:
    // their outputs are never stored) and lanes 0-7 the ws value of their
    // 16-row group (clamped past N) by cp.async, which arrives on the
    // stage's barrier as they land: the warp never waits on a load
    const int lane = tid - CONSUMERS;
    const float* wsrow =
        ws + (size_t)(min(n0 + 16 * (lane & 7), N - 1) / bs) * kb;
    int blk = b0, left = bu;  // the block of unit u0 + i, its units left
    for (int i = 0; i < nu; ++i) {
      const int st = i % S, u = u0 + i;
      mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
      uint8_t* buf = smem + st * L::STAGE;
      if (wp != nullptr) {
        if (wv == 8)
          load_w_tile<8>(buf, wp, ldw, N, K, n0, u * UNIT, lane);
        else if (wv == 4)
          load_w_tile<4>(buf, wp, ldw, N, K, n0, u * UNIT, lane);
        else if (wv == 2)
          load_w_tile<2>(buf, wp, ldw, N, K, n0, u * UNIT, lane);
        else
          load_w_tile<1>(buf, wp, ldw, N, K, n0, u * UNIT, lane);
        __syncwarp();
      }
      if (lane == 0) {
        mbar_expect_tx(&full[st], wp ? L::STAGE - L::W_BYTES : L::STAGE);
        if (wp == nullptr) tma_load_2d(buf, &tw, &full[st], u * UNIT, n0);
        tma_load_2d(buf + L::W_BYTES, &tx, &full[st], u * UNIT, m0);
      }
      if (i % SU == 0) {
        for (int tok = lane; tok < T; tok += 32)
          cp_async4(xsb + 2 * st * BOX + tok,
                    xs + (size_t)min(m0 + tok, M - 1) * kb + blk);
        if (lane < 8) cp_async4(xsb + (2 * st + 1) * BOX + lane, wsrow + blk);
      }
      cp_async_arrive(&full[st]);
      if (--left == 0) {
        left = bu;
        ++blk;
      }
    }
  } else {
    // consumer warpgroups: 64 weight rows each
    const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wgi * 64 + warp * 16 + g;  // tile rows r0 and r0 + 8
    // the fresh partial covers TN tokens at a time, NSUB sub-tiles of T
    constexpr int TN = T < 64 ? T : 64, NSUB = T / TN;
    float acc[T / 2], part[TN / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;
    // a block of bs rows that is no multiple of 16 (bs = K, one block in
    // K) can end inside a 16-row group: then the thread's two rows take
    // their own ws value, the same for the whole K loop
    const bool row_ws = bs % 16 != 0;
    const float ws_lo =
        row_ws ? __ldg(ws + (size_t)(min(n0 + r0, N - 1) / bs) * kb) : 0.f;
    const float ws_hi =
        row_ws ? __ldg(ws + (size_t)(min(n0 + r0 + 8, N - 1) / bs) * kb) : 0.f;

    for (int i = 0; i < nu; i += SU) {
#pragma unroll
      for (int q = 0; q < SU; ++q)
        mbar_wait(&full[(i + q) % S], ((i + q) / S) & 1);
      // A fragment of k16 step ks: {row g, g+8} x {k 2t.., k 2t+8..}, the
      // codes at bytes 2t, 2t+1 and 2t+8, 2t+9 of the step
      uint32_t a[4 * SU][4];
#pragma unroll
      for (int q = 0; q < SU; ++q)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const uint32_t v = frag_bytes(smem + ((i + q) % S) * L::STAGE,
                                          r0 + 8 * rh, ks, t);
            a[4 * q + ks][rh] = e4m3x2_to_f16x2(v);
            a[4 * q + ks][2 + rh] = e4m3x2_to_f16x2(v >> 16);
          }
      // the step's token scales and its ws value for the thread's rows, in
      // the stage of its first unit
      const float* xsv = xsb + 2 * (i % S) * BOX;
      const float wsv = xsv[BOX + (r0 >> 4)];
      const float wlo = row_ws ? ws_lo : wsv, whi = row_ws ? ws_hi : wsv;
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < SU; ++q) {
          // x rows sub * TN.. of the box: 128 bytes a row
          const uint64_t d = desc_k<128>(smem + ((i + q) % S) * L::STAGE +
                                         L::W_BYTES + sub * TN * 128);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_f16_rs<TN>(part, a[4 * q + ks], d + 2 * ks, q + ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        // promote the step's sum: acc += part * xs * ws, in f32
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const float2 xv = *reinterpret_cast<const float2*>(
              xsv + sub * TN + 8 * j + 2 * t);
          const float w0 = xv.x * wlo, w1 = xv.y * wlo;
          const float w2 = xv.x * whi, w3 = xv.y * whi;
          const int c = sub * (TN / 2) + 4 * j;
          acc[c + 0] = fmaf(part[4 * j + 0], w0, acc[c + 0]);
          acc[c + 1] = fmaf(part[4 * j + 1], w1, acc[c + 1]);
          acc[c + 2] = fmaf(part[4 * j + 2], w2, acc[c + 2]);
          acc[c + 3] = fmaf(part[4 * j + 3], w3, acc[c + 3]);
        }
      }
      fence_regs(a);
#pragma unroll
      for (int q = 0; q < SU; ++q) release_stage(&empty[(i + q) % S], lane);
    }
    store_tile<T, OUT_F32>(acc, smem, out, partial, nullptr, M, N, m0, n0,
                           blockIdx.z, r0, t);
  }
}

template <int T, bool OUT_F32>
int launch(const void* x, const void* xs, const void* w, const void* ws,
           void* x16, void* out, void* partial, int M, int N, int K, int bs,
           int ldw, int ldx, int splits, cudaStream_t st) {
  const int bu = (bs + UNIT - 1) / UNIT;  // units a block
  // two units a step where a block holds whole steps (bs a multiple of
  // 128), else one
  const bool two = bs % 128 == 0;
  auto kern = two ? fp8_block_gemm_kernel<T, OUT_F32, 2>
                  : fp8_block_gemm_kernel<T, OUT_F32, 1>;
  const int smem_bytes = Layout<T, 1, 2>::SMEM;
  static bool attr[2] = {false, false};
  if (!attr[two]) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
    attr[two] = true;
  }
  // TMA reads w where its row stride and address are 16-byte multiples;
  // else the kernel loads it in pieces of wv bytes
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const bool by_tma = ldw % 16 == 0 && wa % 16 == 0;
  int wv = 8;
  while ((ldw | K | static_cast<int>(wa & 7)) & (wv - 1)) wv >>= 1;
  CUtensorMap tw = {}, tx;
  int e = by_tma ? encode_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K,
                             ROWS, UNIT, CU_TENSOR_MAP_SWIZZLE_64B, ldw)
                 : 0;
  if (e == 0)
    e = encode_2d(&tx, x16, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, M, K, T, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B, ldx * 2);
  if (e != 0) return e;
  if (K % 16 == 0 && ldx == K) {
    const size_t n16 = (size_t)M * K / 16;
    e4m3_to_f16_kernel<<<(unsigned)((n16 + 255) / 256), 256, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(x16), n16);
  } else {
    const size_t n = (size_t)M * ldx;
    e4m3_rows_to_f16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<uint16_t*>(x16), M, K,
        ldx);
  }
  const int kb = K / bs;
  const int bps = (kb + splits - 1) / splits;  // blocks a split
  const dim3 grid(((M + T - 1) / T) * ((N + ROWS - 1) / ROWS), 1, splits);
  kern<<<grid, NTHREADS, smem_bytes, st>>>(
      tw, tx, static_cast<const float*>(xs), static_cast<const float*>(ws),
      out, splits > 1 ? static_cast<float*>(partial) : nullptr,
      by_tma ? nullptr : static_cast<const uint8_t*>(w), ldw, wv, M, N, K, bs,
      kb, bu, bps);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, nullptr, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tok_tile in {8, 16, 32, 64, 128}; block: a multiple of 64 that divides
// K, or K; N >= 1; w's rows ldw >= K bytes apart (by TMA where ldw and w
// are 16-byte aligned, else by the kernel's own loads); x16:
// [M, ldx] f16 scratch (x converted; ldx a multiple of 8, >= K); splits
// >= 1 K-splits of whole blocks (partial: [splits, M, N] f32 scratch when
// splits > 1).
extern "C" int llmc_fp8_block_gemm(const void* x, const void* xs,
                                   const void* w, const void* ws, void* x16,
                                   void* out, void* partial, int M, int N,
                                   int K, int block, int ldw, int ldx,
                                   int out_f32, int tok_tile, int splits,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % block || (block % UNIT && block != K) || ldw < K || ldx % 8 ||
      ldx < K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_f32)
    return LLMC_DISPATCH_T(tok_tile, true, launch, x, xs, w, ws, x16, out,
                           partial, M, N, K, block, ldw, ldx, splits, st);
  return LLMC_DISPATCH_T(tok_tile, false, launch, x, xs, w, ws, x16, out,
                         partial, M, N, K, block, ldw, ldx, splits, st);
}
