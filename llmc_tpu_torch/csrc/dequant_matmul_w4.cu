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
// with one group.
//
// Per output element, over the KC-column chunks c of each half-group h:
//   y[m,n] = sum_{h,c} ( s[g(h),n] * sum_{k in c} x[m,k] * u[n,k]
//                        - (sum_{k in c} x[m,k]) * zs[g(h),n] )
// with u the nibble 0..15, exact in bf16.  The scale multiplies an f32
// partial sum, never the weight (code*s rounded to bf16 would depart
// from the reference); the row sums of x for the zero term come from
// one more mma of the x tile against a B fragment of ones.
//
// What bounds it on an H100: at M = 1..128 (decode) the packed weight
// stream (K/2 bytes per output column plus 8 bytes of s/zs per group) —
// the card's memory rate; at M = 4096 (prefill) the bf16 tensor-core
// rate.  Design:
// - 256 threads per CTA on a BM x 128 output tile, BM in {16, 32, 64}
//   chosen by the caller from M, so decode computes no padding rows;
// - the K loop (it replaces the TPU's sequential k grid axis: Hopper CTAs
//   run in no order) walks the group pairs in KC-column chunks through a
//   ring of STAGES shared-memory buffers filled by 16-byte cp.async
//   copies, so three chunks stream in during each chunk's math;
// - the 8 warps lie side by side along N, each holding every row of the
//   tile, so one decoded B fragment feeds BM / 16 mma; nibbles decode to
//   bf16 by the 0x4300|v - 128 trick; A fragments come by ldmatrix;
//   mma.sync m16n8k16 bf16 -> f32;
// - when the tile grid is too small to fill the card, K is split over
//   `splits` CTAs that write f32 partials, summed in a fixed order by a
//   second kernel (deterministic).
// Not yet: wgmma, TMA, warp specialisation, a load-time repack of the
// nibbles.  A 128-row tile spilled at 255 registers.

#include "gemm_common.cuh"

namespace {

template <int BM>
struct Tile {
  // the 8 warps side by side along N, each over all BM rows
  static constexpr int WN = BN / 8;
  static constexpr int MI = BM / 16, NJ = WN / 8;
  static constexpr int XS = 2 * KC + 8;  // x smem row stride, bf16 elements
  static constexpr int WS = KC + 16;     // packed smem row stride, bytes
  static constexpr int X_BYTES = BM * XS * 2;
  static constexpr int W_BYTES = BN * WS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "alignment");
};

__device__ __forceinline__ uint32_t nib2bf16x2(uint32_t a, uint32_t b) {
  // a, b in 0..15 -> bf16x2 {a, b} exactly: bf16(128 + v) is 0x4300 | v
  uint32_t r = 0x43004300u | a | (b << 16);
  const uint32_t k128 = 0x43004300u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&k128));
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 {1.0, 1.0}

template <int BM, bool OUT_F32>
__global__ void __launch_bounds__(NT, min_blocks<BM>()) w4_dequant_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ s, const float* __restrict__ zs,
    void* __restrict__ out, float* __restrict__ partial, int M, int N,
    int K, int gsl, int single, int pairs_per_split) {
  using T = Tile<BM>;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp * T::WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int half_k = K / 2;  // packed row length, bytes
  const int npairs = half_k / gsl;
  const int p_begin = blockIdx.z * pairs_per_split;
  const int p_end = min(npairs, p_begin + pairs_per_split);
  const int cpp = gsl / KC;  // chunks per pair
  const int n_chunks = (p_end - p_begin) * cpp;

  auto stage_x = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * T::STAGE);
  };
  auto stage_w = [&](int st) { return smem + st * T::STAGE + T::X_BYTES; };

  auto load_chunk = [&](int st, int i) {
    const int p = p_begin + i / cpp, c = i % cpp;
    __nv_bfloat16* sx = stage_x(st);
    uint8_t* sw = stage_w(st);
    constexpr int XV = KC / 8;  // 16-byte vectors per half row
    for (int v = tid; v < BM * 2 * XV; v += NT) {
      const int r = v / (2 * XV), rem = v % (2 * XV);
      const int h = rem / XV, col = (rem % XV) * 8;
      const int m = m0 + r;
      const __nv_bfloat16* src =
          x + (size_t)min(m, M - 1) * K + (size_t)(2 * p + h) * gsl +
          c * KC + col;
      cp_async16(&sx[r * T::XS + h * KC + col], src, m < M);
    }
    constexpr int WV = KC / 16;
    for (int v = tid; v < BN * WV; v += NT) {
      const int r = v / WV, col = (v % WV) * 16;
      const int n = n0 + r;
      const uint8_t* src =
          w + (size_t)min(n, N - 1) * half_k + p * gsl + c * KC + col;
      cp_async16(&sw[r * T::WS + col], src, n < N);
    }
  };

  float acc[T::MI][T::NJ][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < T::NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  // ring of STAGES buffers: chunks i+1 .. i+STAGES-1 stream in while
  // chunk i is multiplied
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_chunks) load_chunk(j, j);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i landed; every warp is done with chunk i-1
    if (i + STAGES - 1 < n_chunks)
      load_chunk((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_async_commit();

    const __nv_bfloat16* sx = stage_x(st);
    const uint8_t* sw = stage_w(st);

    const int p = p_begin + i / cpp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // part: this half's partial products; xrow: the row sums of x over
      // the chunk, from one more mma against a B of ones (every column
      // of xrow holds the row's sum)
      float part[T::MI][T::NJ][4], xrow[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xrow[mi][e] = 0.f;
#pragma unroll
        for (int nj = 0; nj < T::NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[T::MI][4];
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          ldmatrix_x4(a[mi], &sx[(mi * 16 + (lane & 15)) * T::XS +
                                 h * KC + kk + 8 * (lane >> 4)]);
          mma16816(xrow[mi], a[mi], kOnes, kOnes);
        }
#pragma unroll
        for (int nj = 0; nj < T::NJ; ++nj) {
          const uint8_t* wb = &sw[(wn + nj * 8 + g) * T::WS + kk + 2 * t];
          uint32_t u0 = *reinterpret_cast<const uint16_t*>(wb);
          uint32_t u1 = *reinterpret_cast<const uint16_t*>(wb + 8);
          if (h) {
            u0 >>= 4;
            u1 >>= 4;
          }
          const uint32_t b0 = nib2bf16x2(u0 & 0xF, (u0 >> 8) & 0xF);
          const uint32_t b1 = nib2bf16x2(u1 & 0xF, (u1 >> 8) & 0xF);
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi)
            mma16816(part[mi][nj], a[mi], b0, b1);
        }
      }
      // scale the partial sum, subtract the chunk's zero term
      const int sg = single ? 0 : 2 * p + h;
      float sv[T::NJ][2], zv[T::NJ][2];
#pragma unroll
      for (int nj = 0; nj < T::NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + nj * 8 + 2 * t + e;
          sv[nj][e] = n < N ? s[(size_t)sg * N + n] : 0.f;
          zv[nj][e] = n < N ? zs[(size_t)sg * N + n] : 0.f;
        }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < T::NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][nj][e] += sv[nj][e & 1] * part[mi][nj][e] -
                              xrow[mi][e & 2] * zv[nj][e & 1];
    }
  }

  write_tile<T::MI, T::NJ, OUT_F32>(acc, out, partial, nullptr, M, N, m0,
                                     n0 + wn, lane, blockIdx.z);
}

template <int BM, bool OUT_F32>
int launch(const void* x, const void* packed, const void* s, const void* zs,
           void* out, void* partial, int M, int N, int K, int gsl,
           int single, int splits, cudaStream_t st) {
  using T = Tile<BM>;
  auto kern = w4_dequant_matmul_kernel<BM, OUT_F32>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         T::SMEM);
    attr = true;
  }
  const int npairs = (K / 2) / gsl;
  const int pps = (npairs + splits - 1) / splits;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, NT, T::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(s),
      static_cast<const float*>(zs), out,
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, gsl,
      single, pps);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, nullptr, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bm in {16, 32, 64}; gsl a multiple of 128 (KC); splits >= 1
// K-splits (partial: [splits, M, N] f32 scratch when splits > 1).
extern "C" int llmc_w4_dequant_matmul(const void* x, const void* packed,
                                      const void* s, const void* zs,
                                      void* out, void* partial, int M, int N,
                                      int K, int gsl, int single, int out_f32,
                                      int bm, int splits,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_BM(bm, true, launch, x, packed, s, zs, out, partial,
                            M, N, K, gsl, single, splits, st);
  return LLMC_DISPATCH_BM(bm, false, launch, x, packed, s, zs, out, partial,
                          M, N, K, gsl, single, splits, st);
}
