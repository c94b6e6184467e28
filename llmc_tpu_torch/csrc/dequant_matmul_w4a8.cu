// w4a8_dequant_matmul: y = sx * (xq @ dequant(packed)^T) for W4A8 — int8
// per-token activation codes against group-pair packed 4-bit weights — on
// Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/dequant_matmul.py::_kernel_w4a8 (the Pallas TPU
// kernel, pallas_call at :426) together with what its wrapper applies
// outside the kernel: the zero / excess-8 correction y = y+ - XS @ zs over
// the per-group sums of the int8 codes (:445-452) and the per-token scale
// (:453-454).  The activations arrive already quantized (xq int8 [M, K],
// sx f32 [M, 1]), as the reference quantizes before its kernel (:399).
//
// Layout of packed, s and zs: as in dequant_matmul_w4.cu (group pairs,
// unsigned nibbles, s / zs [ng, N] f32 with zs = s * z_eff; gsl the K span
// of one nibble half).
//
// Per output element, over the KC-column chunks c of each half group h:
//   y[m,n] = sx[m] * sum_{h,c} ( s[g(h),n] * sum_{k in c} xq[m,k] * u[n,k]
//                                - (sum_{k in c} xq[m,k]) * zs[g(h),n] )
// Both inner sums are int32 and exact (|xq| <= 127, u <= 15, 128 columns:
// at most 243 840).  They are taken per chunk of a half group because
// every group has its own f32 scale: one int32 sum over all of K would
// lose them.  The int32 sums are converted to f32 (exact below 2^24) and
// only then scaled, so the kernel differs from an integer oracle by the
// order of at most K / 128 f32 terms.  The row sums of xq for the zero term
// come from one more mma of the x tile against a B fragment of ones, so
// they are exact int32 too: no reduced-precision dot is involved.
//
// What bounds it on an H100: at decode (M <= 128) the packed weight stream,
// K / 2 bytes per output column — the card's memory rate; at M = 4096 the
// int8 tensor-core rate.  Design: dequant_matmul_w4.cu's, with the x tile
// at half the bytes: 256 threads on a BM x 128 output tile, BM in
// {16, 32, 64} from M; a ring of STAGES cp.async buffers over KC-column
// chunks; the 8 warps side by side along N; a nibble decodes to int8 with
// one shift and one mask of a 32-bit word (four codes at once); A fragments
// by ldmatrix; mma.sync m16n8k32 s8 x s8 -> s32; split-K over CTAs below
// one wave, summed in a fixed order by a second kernel that also applies
// sx.  Not yet: wgmma, TMA, a load-time repack.

#include "gemm_common.cuh"

namespace {

template <int BM>
struct Tile {
  static constexpr int WN = BN / 8;
  static constexpr int MI = BM / 16, NJ = WN / 8;
  static constexpr int XS = 2 * KC + 16;  // x smem row stride, bytes
  static constexpr int WS = KC + 16;      // packed smem row stride, bytes
  static constexpr int X_BYTES = BM * XS;
  static constexpr int W_BYTES = BN * WS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "alignment");
};

constexpr uint32_t kOnesS8 = 0x01010101u;  // int8x4 {1, 1, 1, 1}

template <int BM, bool OUT_F32>
__global__ void __launch_bounds__(NT, min_blocks<BM>())
w4a8_dequant_matmul_kernel(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ s, const float* __restrict__ zs,
    const float* __restrict__ sx, void* __restrict__ out,
    float* __restrict__ partial, int M, int N, int K, int gsl, int single,
    int pairs_per_split) {
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
    return reinterpret_cast<int8_t*>(smem + st * T::STAGE);
  };
  auto stage_w = [&](int st) { return smem + st * T::STAGE + T::X_BYTES; };

  auto load_chunk = [&](int st, int i) {
    const int p = p_begin + i / cpp, c = i % cpp;
    int8_t* sxm = stage_x(st);
    uint8_t* sw = stage_w(st);
    constexpr int XV = KC / 16;  // 16-byte vectors per half row
    for (int v = tid; v < BM * 2 * XV; v += NT) {
      const int r = v / (2 * XV), rem = v % (2 * XV);
      const int h = rem / XV, col = (rem % XV) * 16;
      const int m = m0 + r;
      const int8_t* src = x + (size_t)min(m, M - 1) * K +
                          (size_t)(2 * p + h) * gsl + c * KC + col;
      cp_async16(&sxm[r * T::XS + h * KC + col], src, m < M);
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

    const int8_t* sxm = stage_x(st);
    const uint8_t* sw = stage_w(st);

    const int p = p_begin + i / cpp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // part: this half's int32 partial products; xrow: the int32 row
      // sums of xq over the chunk (every column of xrow holds the sum)
      int part[T::MI][T::NJ][4], xrow[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xrow[mi][e] = 0;
#pragma unroll
        for (int nj = 0; nj < T::NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0;
      }
#pragma unroll
      for (int kk = 0; kk < KC; kk += 32) {
        uint32_t a[T::MI][4];
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          ldmatrix_x4(a[mi], &sxm[(mi * 16 + (lane & 15)) * T::XS + h * KC +
                                  kk + 16 * (lane >> 4)]);
          mma16832_s8(xrow[mi], a[mi], kOnesS8, kOnesS8);
        }
#pragma unroll
        for (int nj = 0; nj < T::NJ; ++nj) {
          // B fragment: column n = g, k = 4t .. 4t+3 and 16+4t .. 16+4t+3;
          // byte k of the row holds half 0 in its low nibble, half 1 in
          // its high nibble
          const uint8_t* wb = &sw[(wn + nj * 8 + g) * T::WS + kk + 4 * t];
          uint32_t u0 = *reinterpret_cast<const uint32_t*>(wb);
          uint32_t u1 = *reinterpret_cast<const uint32_t*>(wb + 16);
          if (h) {
            u0 >>= 4;
            u1 >>= 4;
          }
          const uint32_t b0 = u0 & 0x0F0F0F0Fu, b1 = u1 & 0x0F0F0F0Fu;
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi)
            mma16832_s8(part[mi][nj], a[mi], b0, b1);
        }
      }
      // to f32 (exact), scale the partial sum, subtract the zero term
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
            acc[mi][nj][e] += sv[nj][e & 1] * (float)part[mi][nj][e] -
                              (float)xrow[mi][e & 2] * zv[nj][e & 1];
    }
  }

  write_tile<T::MI, T::NJ, OUT_F32>(acc, out, partial, sx, M, N, m0, n0 + wn,
                                     lane, blockIdx.z);
}

template <int BM, bool OUT_F32>
int launch(const void* x, const void* packed, const void* s, const void* zs,
           const void* sx, void* out, void* partial, int M, int N, int K,
           int gsl, int single, int splits, cudaStream_t st) {
  using T = Tile<BM>;
  auto kern = w4a8_dequant_matmul_kernel<BM, OUT_F32>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         T::SMEM);
    attr = true;
  }
  const int npairs = (K / 2) / gsl;
  const int pps = (npairs + splits - 1) / splits;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const float* sxp = static_cast<const float*>(sx);
  kern<<<grid, NT, T::SMEM, st>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(s), static_cast<const float*>(zs), sxp, out,
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, gsl,
      single, pps);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, sxp, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: int8 codes [M, K]; sx: f32 [M]; bm in {16, 32, 64}; gsl a multiple of
// 128 (KC); splits >= 1 K-splits (partial: [splits, M, N] f32 scratch when
// splits > 1).
extern "C" int llmc_w4a8_dequant_matmul(const void* x, const void* packed,
                                        const void* s, const void* zs,
                                        const void* sx, void* out,
                                        void* partial, int M, int N, int K,
                                        int gsl, int single, int out_f32,
                                        int bm, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_BM(bm, true, launch, x, packed, s, zs, sx, out,
                            partial, M, N, K, gsl, single, splits, st);
  return LLMC_DISPATCH_BM(bm, false, launch, x, packed, s, zs, sx, out,
                          partial, M, N, K, gsl, single, splits, st);
}
