// fp8_block_gemm: the blockwise-scaled FP8 GEMM on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/fp8_gemm.py::_kernel_fp8 (the Pallas TPU kernel,
// pallas_call at :73).  Same function, with kb = k / 128:
//   y[m,n] = sum_kb ( sum_{k in kb} x[m,k] * w[n,k] ) * xs[m,kb] * ws[n/128,kb]
// x, w are e4m3 codes, every product is exact in f32, each 128-wide block
// is summed in f32, scaled by its two f32 scales, and added to an f32
// running sum.
//
// Layout.  x [M, K] e4m3; xs [M, K/128] f32; w [N, K] e4m3; ws
// [ceil(N/128), K/128] f32 (the checkpoint's weight_scale_inv); all as
// stored.  K % 128 == 0; N takes any value: TMA zero-fills the weight rows
// past N, and the epilogue writes none.  A CTA's 128 weight rows lie in one
// row of ws, and a step of 128 columns (two 64-column units) is one scale
// block: per step the CTA needs one ws value and one xs value a token.
//
// What bounds it on an H100: below about M = 600 the weight stream, one
// byte a weight — the card's memory rate; above it the tensor cores.  It
// runs on the skeleton of wgmma_common.cuh with B1's loop: wgmma.mma_async
// m64nTk16 f16 x f16 -> f32 in the RS form, the e4m3 weight codes decoded
// in registers to f16 (exact: e4m3 is a subset of f16; one cvt per two
// codes) as A, and x as B from shared memory by TMA, converted to f16 once
// per call by a first kernel (e4m3_to_f16_kernel, 3 bytes an element).
// Each scale block's eight k16 steps start from a fresh partial (scale-d 0
// on the first), and acc += part * (xs[m,kb] * ws[n/128,kb]) runs in f32
// registers.  xs is [M, K/128], strided by token, which TMA cannot take (a
// row stride of 4 K / 128 bytes need not be a multiple of 16): the producer
// warp's lanes load each block's T values with plain loads into the stage,
// beside the TMA boxes, and arrive on the stage's barrier after them.
//
// Why not the fp8 tensor cores: wgmma m64nTk32 e4m3 x e4m3 -> f32 keeps
// too few bits inside one instruction's sum (DeepSeek-V3's report reads
// about 14 on an H800).  That design, both operands e4m3 by TMA in the SS
// form, was faster and read off the float64 oracle by more than
// chip_smoke.py's 1e-5 even with every k32 step promoted (PERF.md).
// chip_smoke.py holds the kernel against that oracle on random data and
// on a block whose products span 20 bits (fp8_adder_probe).

#include <cuda_fp8.h>

#include "wgmma_common.cuh"

namespace {

using namespace wg;

constexpr int BLK = 128;  // scale block: K columns a step, weight rows a CTA

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

template <int T, bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 1) fp8_block_gemm_kernel(
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx, const float* __restrict__ xs,
    const float* __restrict__ ws, void* __restrict__ out,
    float* __restrict__ partial, int M, int N, int K, int units_per_split) {
  // a stage: the weight tile [128 x 64 e4m3] and the x box [T x 64 f16]
  using L = Layout<T, 1, 1>;
  constexpr int S = L::STAGES;
  constexpr int BOX = L::SUM_BOX / 4;  // floats a box of token scales
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* xsb = reinterpret_cast<float*>(smem + L::RING);  // [S] boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  // output tiles with the weight-row tiles fastest
  const int nt = (N + ROWS - 1) / ROWS;
  const int m0 = (blockIdx.x / nt) * T, n0 = (blockIdx.x % nt) * ROWS;
  const int kb = K / BLK, units = K / UNIT;
  const int u0 = blockIdx.z * units_per_split;  // even: whole blocks
  const int nu = max(0, min(units, u0 + units_per_split) - u0);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      // the TMA thread's arrival with the bytes, then all 32 producer
      // lanes' after their token scales
      mbar_init(&full[i], 1 + 32);
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: lane 0 issues the TMA loads; with a block's first
    // unit every lane stores the block's token scales
    const int lane = tid - CONSUMERS;
    for (int i = 0; i < nu; ++i) {
      const int st = i % S, u = u0 + i;
      mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
      uint8_t* buf = smem + st * L::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[st], L::STAGE);
        tma_load_2d(buf, &tw, &full[st], u * UNIT, n0);
        tma_load_2d(buf + L::W_BYTES, &tx, &full[st], u * UNIT, m0);
      }
      if (i % 2 == 0)
        for (int tok = lane; tok < T; tok += 32) {
          const int m = m0 + tok;
          xsb[st * BOX + tok] =
              m < M ? __ldg(xs + (size_t)m * kb + u / 2) : 0.f;
        }
      mbar_arrive(&full[st]);
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
    const float* wsrow = ws + (size_t)(n0 / BLK) * kb;

    // one scale block a step: two units
    for (int i = 0; i < nu; i += 2) {
      const float wsv = __ldg(wsrow + (u0 + i) / 2);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        mbar_wait(&full[(i + q) % S], ((i + q) / S) & 1);
      // A fragment of k16 step ks: {row g, g+8} x {k 2t.., k 2t+8..}, the
      // codes at bytes 2t, 2t+1 and 2t+8, 2t+9 of the step
      uint32_t a[8][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const uint32_t v = frag_bytes(smem + ((i + q) % S) * L::STAGE,
                                          r0 + 8 * rh, ks, t);
            a[4 * q + ks][rh] = e4m3x2_to_f16x2(v);
            a[4 * q + ks][2 + rh] = e4m3x2_to_f16x2(v >> 16);
          }
      const float* xsv = xsb + (i % S) * BOX;  // the block's token scales
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 2; ++q) {
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
        // promote the block's sum: acc += part * xs * ws, in f32
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const float2 xv = *reinterpret_cast<const float2*>(
              xsv + sub * TN + 8 * j + 2 * t);
          const float w0 = xv.x * wsv, w1 = xv.y * wsv;
          const int c = sub * (TN / 2) + 4 * j;
          acc[c + 0] = fmaf(part[4 * j + 0], w0, acc[c + 0]);
          acc[c + 1] = fmaf(part[4 * j + 1], w1, acc[c + 1]);
          acc[c + 2] = fmaf(part[4 * j + 2], w0, acc[c + 2]);
          acc[c + 3] = fmaf(part[4 * j + 3], w1, acc[c + 3]);
        }
      }
      fence_regs(a);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        release_stage(&empty[(i + q) % S], lane);
    }
    store_tile<T, OUT_F32>(acc, smem, out, partial, nullptr, M, N, m0, n0,
                           blockIdx.z, r0, t);
  }
}

template <int T, bool OUT_F32>
int launch(const void* x, const void* xs, const void* w, const void* ws,
           void* x16, void* out, void* partial, int M, int N, int K,
           int splits, cudaStream_t st) {
  using L = Layout<T, 1, 1>;
  auto kern = fp8_block_gemm_kernel<T, OUT_F32>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L::SMEM);
    attr = true;
  }
  CUtensorMap tw, tx;
  int e = encode_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, ROWS,
                    UNIT, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = encode_2d(&tx, x16, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, M, K, T, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  const size_t n16 = (size_t)M * K / 16;
  e4m3_to_f16_kernel<<<(unsigned)((n16 + 255) / 256), 256, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(x16), n16);
  const int kb = K / BLK;
  const int ups = (kb + splits - 1) / splits * 2;  // units: whole blocks
  const dim3 grid(((M + T - 1) / T) * ((N + ROWS - 1) / ROWS), 1, splits);
  kern<<<grid, NTHREADS, L::SMEM, st>>>(
      tw, tx, static_cast<const float*>(xs), static_cast<const float*>(ws),
      out, splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, ups);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, nullptr, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tok_tile in {8, 16, 32, 64, 128}; K a multiple of 128, N >= 1; x16: [M, K]
// f16 scratch (x converted); splits >= 1 K-splits (partial: [splits, M, N]
// f32 scratch when splits > 1).
extern "C" int llmc_fp8_block_gemm(const void* x, const void* xs,
                                   const void* w, const void* ws, void* x16,
                                   void* out, void* partial, int M, int N,
                                   int K, int out_f32, int tok_tile,
                                   int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_T(tok_tile, true, launch, x, xs, w, ws, x16, out,
                           partial, M, N, K, splits, st);
  return LLMC_DISPATCH_T(tok_tile, false, launch, x, xs, w, ws, x16, out,
                         partial, M, N, K, splits, st);
}
