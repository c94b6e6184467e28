// w4a8_dequant_matmul: y = sx * (xq @ dequant(packed)^T) for W4A8 — int8
// per-token activation codes against group-pair packed 4-bit weights — on
// Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/dequant_matmul.py::_kernel_w4a8 (the Pallas TPU
// kernel, pallas_call at :426) together with what its wrapper applies
// outside the kernel: the zero / excess-8 correction y = y+ - XS @ zs over
// the per-group sums of the int8 codes (:445-452) and the per-token scale
// (:453-454).  The activations arrive quantized by quant_act_token.cu (xq
// int8 [M, K], sx f32 [M], and the int32 sums of xq over each 64-column
// piece), as the reference quantizes before its kernel (:399).
//
// Layout of packed, s and zs: as in dequant_matmul_w4.cu (group pairs,
// unsigned nibbles, s / zs [ng, N] f32 with zs = s * z_eff; gsl the K span
// of one nibble half, a multiple of 64).
//
// Per output element, over the steps c of each half group h (a step: 128
// columns of a half group of 128 or more, else its 64):
//   y[m,n] = sx[m] * sum_{h,c} ( s[g(h),n] * sum_{k in c} xq[m,k] * u[n,k]
//                                - (sum_{k in c} xq[m,k]) * zs[g(h),n] )
// Both inner sums are int32 and exact (|xq| <= 127, u <= 15, 128 columns:
// at most 243 840).  They are taken per step because every group has its
// own f32 scale: one int32 sum over all of K would lose them.  The int32
// sums are converted to f32 (exact below 2^24) and only then scaled, so
// the kernel differs from an integer oracle by the order of at most K / 64
// f32 terms.  The per-token scale multiplies in the epilogue, or in the
// split-K sum: either way after every term, in a fixed order.
//
// What bounds it on an H100: at decode (M <= 128) the packed weight
// stream, K / 2 bytes a column plus 8 bytes of s / zs a group — the card's
// memory rate; at M = 4096 the int8 tensor-core rate.  It runs on the
// skeleton of wgmma_common.cuh: wgmma.mma_async m64nTk32 s8 x s8 -> s32 in
// the RS form, the decoded nibbles in registers as A and the xq boxes
// (64 int8 a row, 64-byte swizzle) from shared memory as B.  An 8-bit A
// register holds four consecutive K bytes of one row, so one 32-bit load
// of packed bytes gives half 0's register as w & 0x0F0F0F0F and half 1's
// as (w >> 4) & 0x0F0F0F0F: no conversion (B1 converts every code to
// bf16).  The row sums of xq come with each unit's stage by TMA from the
// quantizer's sums tensor.  The int32 partial beside the f32 accumulator
// fits the 168 registers a thread only in 64-token sub-tiles, one nibble
// half at a time, as in B1.

#include "wgmma_common.cuh"

namespace {

using namespace wg;

// Bytes 4t .. 4t+3 of 16-byte chunk `chunk` of row r of a [128 x 64 B]
// tile stored under the 64-byte swizzle (chunk c of row r at chunk
// c ^ ((r >> 1) & 3)).  Over a warp, rows g = 0..7 at t = 0..3 fall in 32
// distinct banks.
__device__ __forceinline__ uint32_t frag_word(const uint8_t* w, int r,
                                              int chunk, int t) {
  return *reinterpret_cast<const uint32_t*>(
      w + r * UNIT + ((chunk ^ ((r >> 1) & 3)) << 4) + 4 * t);
}

template <int T, int P, bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 1) w4a8_dequant_matmul_kernel(
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap ts, const float* __restrict__ s,
    const float* __restrict__ zs, const float* __restrict__ sx,
    void* __restrict__ out, float* __restrict__ partial, int M, int N, int K,
    int gsl, int single, int units_per_split) {
  using L = Layout<T, 2, 2, 64>;
  constexpr int S = L::STAGES;
  constexpr int BOX = L::SUM_BOX / 4;  // ints a sums box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int* sums = reinterpret_cast<const int*>(smem + L::RING);  // [S][2]
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
        mbar_expect_tx(&full[st], L::TX);
        tma_load_2d(buf, &tw, &full[st], b, n0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (2 * p + h) * gsl + c;  // x column of half h
          tma_load_2d(buf + L::W_BYTES + h * L::X_BYTES, &tx, &full[st], col,
                      m0);
          // the T row sums of xq over these 64 columns
          tma_load_2d(smem + L::RING + (st * 2 + h) * L::SUM_BOX, &ts,
                      &full[st], m0, col / UNIT);
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
    float acc[T / 2];
    int part[TN / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;

    // P units (64-column pieces of both halves) a step, all in one group
    // pair: one fresh partial and one epilogue a half and step, the halves
    // one after the other (not unrolled) so that only one half's A
    // fragments are live.
    for (int i = 0; i < nu; i += P) {
      const int p = ((u0 + i) * UNIT) / gsl;
#pragma unroll
      for (int q = 0; q < P; ++q)
        mbar_wait(&full[(i + q) % S], ((i + q) / S) & 1);
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        // A fragment of k32 step ks: {row g, g+8} x {k 4t.., k 16+4t..}:
        // nibble half h of packed bytes 32 ks + 4t .. and 32 ks + 16 + 4t ..
        uint32_t a[P * 2][4];
#pragma unroll
        for (int q = 0; q < P; ++q)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const uint8_t* w = smem + ((i + q) % S) * L::STAGE;
              a[2 * q + ks][rh] =
                  (frag_word(w, r0 + 8 * rh, 2 * ks, t) >> (4 * h)) &
                  0x0F0F0F0Fu;
              a[2 * q + ks][2 + rh] =
                  (frag_word(w, r0 + 8 * rh, 2 * ks + 1, t) >> (4 * h)) &
                  0x0F0F0F0Fu;
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
            // x rows sub * TN.. of the box: 64 bytes a row
            const uint64_t d =
                desc_k<64>(smem + ((i + q) % S) * L::STAGE + L::W_BYTES +
                           h * L::X_BYTES + sub * TN * 64);
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
              wgmma_s8_rs<TN>(part, a[2 * q + ks], d + 2 * ks, q + ks > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
          // scale the fresh partial, subtract the step's zero term
#pragma unroll
          for (int j = 0; j < TN / 8; ++j) {
            const int tok = sub * TN + 8 * j + 2 * t;
            int2 xs = make_int2(0, 0);
#pragma unroll
            for (int q = 0; q < P; ++q) {
              const int2 v = *reinterpret_cast<const int2*>(
                  sums + (((i + q) % S) * 2 + h) * BOX + tok);
              xs.x += v.x;
              xs.y += v.y;
            }
            const float x0 = static_cast<float>(xs.x);
            const float x1 = static_cast<float>(xs.y);
            const int c = sub * (TN / 2) + 4 * j;
            acc[c + 0] += s0 * static_cast<float>(part[4 * j + 0]) - x0 * z0;
            acc[c + 1] += s0 * static_cast<float>(part[4 * j + 1]) - x1 * z0;
            acc[c + 2] += s1 * static_cast<float>(part[4 * j + 2]) - x0 * z1;
            acc[c + 3] += s1 * static_cast<float>(part[4 * j + 3]) - x1 * z1;
          }
        }
        fence_regs(a);
      }
#pragma unroll
      for (int q = 0; q < P; ++q)
        release_stage(&empty[(i + q) % S], lane);
    }
    store_tile<T, OUT_F32>(acc, smem, out, partial, sx, M, N, m0, n0,
                           blockIdx.z, r0, t);
  }
}

template <int T, bool OUT_F32>
int launch(const void* xq, const void* packed, const void* s, const void* zs,
           const void* sums, const void* sx, void* out, void* partial, int M,
           int N, int K, int gsl, int single, int splits, cudaStream_t st) {
  using L = Layout<T, 2, 2, 64>;
  // two 64-column pieces a step where a half group holds two
  const int P = gsl % (2 * UNIT) == 0 ? 2 : 1;
  auto kern = P == 2 ? w4a8_dequant_matmul_kernel<T, 2, OUT_F32>
                     : w4a8_dequant_matmul_kernel<T, 1, OUT_F32>;
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
    e = encode_2d(&tx, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, T, UNIT,
                  CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)  // int32 sums [K / 64, Mp]: one box of T tokens a piece
    e = encode_2d(&ts, sums, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, K / UNIT, Mp,
                  1, T, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  const int units = (K / 2) / UNIT;
  const int steps = units / P;  // K steps of P units
  const int ups = (steps + splits - 1) / splits * P;
  const dim3 grid(((M + T - 1) / T) * ((N + ROWS - 1) / ROWS), 1, splits);
  const float* sxp = static_cast<const float*>(sx);
  kern<<<grid, NTHREADS, L::SMEM, st>>>(
      tw, tx, ts, static_cast<const float*>(s), static_cast<const float*>(zs),
      sxp, out, splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K,
      gsl, single, ups);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, sxp, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq: int8 codes [M, K]; sums: int32 [K/64, Mp] (Mp = M rounded up to a
// multiple of 4), the sums of xq over each 64-column piece; sx: f32 [M];
// tok_tile in {8, 16, 32, 64, 128}; gsl a multiple of 64; splits >= 1
// K-splits (partial: [splits, M, N] f32 scratch when splits > 1).
extern "C" int llmc_w4a8_dequant_matmul(const void* xq, const void* packed,
                                        const void* s, const void* zs,
                                        const void* sums, const void* sx,
                                        void* out, void* partial, int M,
                                        int N, int K, int gsl, int single,
                                        int out_f32, int tok_tile,
                                        int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_T(tok_tile, true, launch, xq, packed, s, zs, sums,
                           sx, out, partial, M, N, K, gsl, single, splits,
                           st);
  return LLMC_DISPATCH_T(tok_tile, false, launch, xq, packed, s, zs, sums, sx,
                         out, partial, M, N, K, gsl, single, splits, st);
}
