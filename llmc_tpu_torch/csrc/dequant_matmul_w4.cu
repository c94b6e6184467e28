// w4_dequant_matmul: y = x @ dequant(packed)^T for W4A16 group-pair
// packed weights, on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/dequant_matmul.py::_kernel_w4 (the Pallas TPU
// kernel, pallas_call at :426) together with the zero / excess-8
// correction y = y+ - XS @ zs that its wrapper applies outside the kernel
// (:439-455).  The function is the same; the block structure is not.
//
// Layout.  packed [N, K/2] uint8: for each pair of scale groups (2p, 2p+1)
// byte column p*gs + c holds the code of input column 2p*gs + c in its low
// nibble and (2p+1)*gs + c in its high nibble (unsigned, symmetric codes
// stored excess-8).  With one group (K == gs) the "pair" is the two
// halves of the group, both under scale 0.  s, zs [ng, N] f32 (pre_t:
// zs = s * z_eff).  gsl is the K span of one nibble half: gs, or K/2
// with one group; a multiple of 64 (group size 64 and up).
//
// Per output element, over the steps c of each half group h (a step: the
// 128 columns of a half group of 128 or more, else its 64):
//   y[m,n] = sum_{h,c} ( s[g(h),n] * sum_{k in c} x[m,k] * u[n,k]
//                        - (sum_{k in c} x[m,k]) * zs[g(h),n] )
// with u the nibble 0..15, exact in bf16.  The scale multiplies a fresh f32
// partial sum (wgmma with scale-d 0), never the weight (code*s rounded to
// bf16 would depart from the reference).  The row sums of x over each
// step, which the zero term needs, are taken once per call by a small
// first kernel (x_piece_sums, a fixed order) into sums [K/step, Mp] f32,
// and come with each step's first stage by TMA.
//
// What bounds it on an H100: at decode (M <= 128) the packed weight stream
// (K/2 bytes a column plus 8 bytes of s/zs a group), the card's memory
// rate; at prefill (M = 4096) the bf16 tensor-core rate.  The design before
// this one (dequant_matmul_w4_mma.cu, kept as a probe) reached neither: its
// 64-row mma.sync tile read the weight through L2 once per 64 tokens, and
// each of its eight warps loaded the whole x tile into registers.  This one
// runs on the skeleton of wgmma_common.cuh: the token count is wgmma's N,
// so the weight is read once per T <= 128 tokens (once in all at decode);
// the x tile reaches the tensor cores from shared memory by TMA and never
// through registers; the nibbles are decoded in registers straight into
// wgmma's A fragments.  What holds it back now is the CUDA-core work
// around the tensor cores, not data movement: on gate_up at M=4096 it read
// 2.36-2.42 ms as built, 2.18 with no decode, 1.89 with no wgmma
// (tools/wgmma_variants.py, PERF.md).  Two accumulators a thread (running sum,
// fresh partial) fit the 168 registers only with the partial in sub-tiles
// of 64 tokens and one nibble half at a time.

#include "wgmma_common.cuh"

namespace {

using namespace wg;

// nibbles (bytes of v, each 0..15) picked by `sel` into the low halves of
// two bf16 -> bf16x2 {u0, u1} exactly: bf16(128 + u) is 0x4300 | u
__device__ __forceinline__ uint32_t nib_pair(uint32_t v, uint32_t sel) {
  uint32_t r = __byte_perm(v, 0, sel) | 0x43004300u;
  const uint32_t k128 = 0x43004300u;
  __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
              *reinterpret_cast<const __nv_bfloat162*>(&k128));
  return *reinterpret_cast<uint32_t*>(&d);
}

// sums[p, m] = sum of x[m, cols p .. cols p + cols - 1] in column order,
// f32, over pieces of cols = 64 * units columns
__global__ void __launch_bounds__(256) x_piece_sums_kernel(
    const __nv_bfloat16* __restrict__ x, float* __restrict__ sums, int M,
    int K, int Mp, int units) {
  const int cols = UNIT * units, pieces = K / cols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * pieces) return;
  const int m = i / pieces, p = i - m * pieces;
  const uint4* src =
      reinterpret_cast<const uint4*>(x + (size_t)m * K + (size_t)p * cols);
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < cols / 8; ++c) {
    const uint4 v = src[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc += __uint_as_float(w[k] << 16);
      acc += __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  sums[(size_t)p * Mp + m] = acc;
}

template <int T, int P, bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 1) w4_dequant_matmul_kernel(
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap ts, const float* __restrict__ s,
    const float* __restrict__ zs, void* __restrict__ out,
    float* __restrict__ partial, int M, int N, int K, int gsl, int single,
    int units_per_split) {
  using L = Layout<T, 2, 2>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sums = smem + L::RING;  // [S][2] boxes of T f32
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  // output tiles with the weight-row tiles fastest
  const int nt = (N + ROWS - 1) / ROWS;
  const int m0 = (blockIdx.x / nt) * T, n0 = (blockIdx.x % nt) * ROWS;
  const int units = (K / 2) / UNIT;
  const int u0 = blockIdx.z * units_per_split;
  const int nu = max(0, min(units, u0 + units_per_split) - u0);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: one thread issues the loads
    if (tid == CONSUMERS) {
      for (int i = 0; i < nu; ++i) {
        const int st = i % S;
        mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        uint8_t* buf = smem + st * L::STAGE;
        const int b = (u0 + i) * UNIT, p = b / gsl, c = b - p * gsl;
        mbar_expect_tx(&full[st], i % P == 0 ? L::TX : L::STAGE);
        tma_load_2d(buf, &tw, &full[st], b, n0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (2 * p + h) * gsl + c;  // x column of half h
          tma_load_2d(buf + L::W_BYTES + h * L::X_BYTES, &tx, &full[st], col,
                      m0);
          if (i % P == 0)  // the step's row sums, with its first unit
            tma_load_2d(sums + (st * 2 + h) * L::SUM_BOX, &ts, &full[st], m0,
                        col / (P * UNIT));
        }
      }
    }
  } else {
    // consumer warpgroups: 64 weight rows each
    const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wgi * 64 + warp * 16 + g;  // tile rows r0 and r0 + 8
    const int nl = n0 + r0, nh = nl + 8;
    // the fresh partial covers TN tokens at a time, NSUB sub-tiles of T
    constexpr int TN = T < 64 ? T : 64, NSUB = T / TN;
    float acc[T / 2], part[TN / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;

    // P units (64-column pieces of both halves) a step, all in one group
    // pair: one fresh partial and one epilogue a half and step.  The halves
    // run one after the other (not unrolled), so that only one half's A
    // fragments are live: at 168 registers a thread the two accumulators
    // leave no room for more.
    for (int i = 0; i < nu; i += P) {
      const int p = ((u0 + i) * UNIT) / gsl;
#pragma unroll
      for (int q = 0; q < P; ++q)
        mbar_wait(&full[(i + q) % S], ((i + q) / S) & 1);
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        // A fragment of k16 step ks: {row g, g+8} x {k 2t.., k 2t+8..},
        // from bytes 2t, 2t+1, 2t+8, 2t+9, nibble half h
        uint32_t a[P * 4][4];
#pragma unroll
        for (int q = 0; q < P; ++q)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const uint32_t v =
                  (frag_bytes(smem + ((i + q) % S) * L::STAGE, r0 + 8 * rh,
                              ks, t) >> (4 * h)) & 0x0F0F0F0Fu;
              a[4 * q + ks][rh] = nib_pair(v, 0x4140);
              a[4 * q + ks][2 + rh] = nib_pair(v, 0x4342);
            }
        const size_t o = (size_t)(single ? 0 : 2 * p + h) * N;
        const float s0 = nl < N ? __ldg(s + o + nl) : 0.f;
        const float z0 = nl < N ? __ldg(zs + o + nl) : 0.f;
        const float s1 = nh < N ? __ldg(s + o + nh) : 0.f;
        const float z1 = nh < N ? __ldg(zs + o + nh) : 0.f;
#pragma unroll
        for (int sub = 0; sub < NSUB; ++sub) {
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < P; ++q) {
            // x rows sub * TN.. of the box: 128 bytes a row
            const uint64_t d =
                desc_k<128>(smem + ((i + q) % S) * L::STAGE + L::W_BYTES +
                            h * L::X_BYTES + sub * TN * 128);
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_rs<TN>(part, a[4 * q + ks], d + 2 * ks, q + ks > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
          // scale the fresh partial, subtract the step's zero term
#pragma unroll
          for (int j = 0; j < TN / 8; ++j) {
            // the step's row sums come with its first unit's stage
            const float2 xv = *reinterpret_cast<const float2*>(
                sums + ((i % S) * 2 + h) * L::SUM_BOX +
                4 * (sub * TN + 8 * j + 2 * t));
            const int c = sub * (TN / 2) + 4 * j;
            acc[c + 0] += s0 * part[4 * j + 0] - xv.x * z0;
            acc[c + 1] += s0 * part[4 * j + 1] - xv.y * z0;
            acc[c + 2] += s1 * part[4 * j + 2] - xv.x * z1;
            acc[c + 3] += s1 * part[4 * j + 3] - xv.y * z1;
          }
        }
        fence_regs(a);
      }
#pragma unroll
      for (int q = 0; q < P; ++q)
        release_stage(&empty[(i + q) % S], lane);
    }
    store_tile<T, OUT_F32>(acc, smem, out, partial, nullptr, M, N, m0, n0,
                           blockIdx.z, r0, t);
  }
}

template <int T, bool OUT_F32>
int launch(const void* x, const void* packed, const void* s, const void* zs,
           void* sums, void* out, void* partial, int M, int N, int K,
           int gsl, int single, int splits, cudaStream_t st) {
  using L = Layout<T, 2, 2>;
  // two 64-column pieces an epilogue where a half group holds two
  auto kern = gsl % (2 * UNIT) == 0 ? w4_dequant_matmul_kernel<T, 2, OUT_F32>
                                    : w4_dequant_matmul_kernel<T, 1, OUT_F32>;
  const int P = gsl % (2 * UNIT) == 0 ? 2 : 1;
  static bool attr[2] = {false, false};
  if (!attr[P - 1]) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L::SMEM);
    attr[P - 1] = true;
  }
  const int Mp = (M + 3) / 4 * 4;  // sums rows: 16-byte strides
  CUtensorMap tw, tx, ts;
  int e = encode_2d(&tw, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K / 2,
                    ROWS, UNIT, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = encode_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K,
                  T, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)  // row sums over the pieces of a step (P units)
    e = encode_2d(&ts, sums, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  K / (P * UNIT), Mp, 1, T, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  const int pieces = M * (K / (P * UNIT));
  x_piece_sums_kernel<<<(pieces + 255) / 256, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(sums), M, K,
      Mp, P);
  const int units = (K / 2) / UNIT;
  const int steps = units / P;  // K steps of P units
  const int ups = (steps + splits - 1) / splits * P;
  const dim3 grid(((M + T - 1) / T) * ((N + ROWS - 1) / ROWS), 1, splits);
  kern<<<grid, NTHREADS, L::SMEM, st>>>(
      tw, tx, ts, static_cast<const float*>(s), static_cast<const float*>(zs),
      out, splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, gsl,
      single, ups);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, nullptr, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tok_tile in {8, 16, 32, 64, 128}; gsl a multiple of 64; splits >= 1
// K-splits (partial: [splits, M, N] f32 scratch when splits > 1); sums:
// [K/64, Mp] f32 scratch, Mp = M rounded up to a multiple of 4.
extern "C" int llmc_w4_dequant_matmul(const void* x, const void* packed,
                                      const void* s, const void* zs,
                                      void* sums, void* out, void* partial,
                                      int M, int N, int K, int gsl,
                                      int single, int out_f32, int tok_tile,
                                      int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_T(tok_tile, true, launch, x, packed, s, zs, sums,
                           out, partial, M, N, K, gsl, single, splits, st);
  return LLMC_DISPATCH_T(tok_tile, false, launch, x, packed, s, zs, sums,
                         out, partial, M, N, K, gsl, single, splits, st);
}
