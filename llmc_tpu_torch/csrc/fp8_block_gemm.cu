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
// [N/128, K/128] f32 (the checkpoint's weight_scale_inv); all as stored:
// the wrapper runs no torch op before the launch.  K % 128 == 0 and
// N % 128 == 0, so an output tile of BN = 128 columns lies in one row of
// ws and a chunk of KC = 128 columns is one scale block: per chunk the CTA
// needs one ws value and one xs value per row.
//
// What bounds it on an H100: below about M = 600 the weight stream, one
// byte per weight — the card's memory rate; above it the FP8 tensor-core
// rate.  Design: the W8 kernel's (dequant_matmul_w8.cu) — 256 threads on a
// BM x 128 tile, BM in {16, 32, 64} from M, a ring of STAGES cp.async
// buffers over 128-column chunks of x and w, 8 warps side by side along N,
// A fragments by ldmatrix, rows beyond M zero-filled and never written,
// split-K below one wave summed in a fixed order.  The TPU kernel's
// sequential K grid axis with a VMEM accumulator is the chunk loop here; a
// FRESH accumulator fragment per chunk takes the block's sum, and
// acc += part * xs * ws runs in f32 registers.
//
// The block's sum is mma.sync.m16n8k32 e4m3 x e4m3 -> f32, the tensor
// cores' own FP8 path, with no conversion; chip_smoke.py holds it against a
// float64 oracle, on random data and on a block whose products span 20
// bits.  Not yet: wgmma, TMA, a warp layout in which each warp does not
// read the whole A tile (eight warps side by side along N read it eight
// times from shared memory).

#include "gemm_common.cuh"

namespace {

// 16 x 32 e4m3 (row) times 32 x 8 e4m3 (col) into 16 x 8 f32
__device__ __forceinline__ void mma16832_e4m3(float* c, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM>
struct Tile {
  static constexpr int WN = BN / 8;
  static constexpr int MI = BM / 16, NJ = WN / 8;
  static constexpr int RS = KC + 16;  // smem row stride of x and w, bytes
  static constexpr int X_BYTES = BM * RS;
  static constexpr int W_BYTES = BN * RS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "alignment");
};

template <int BM, bool OUT_F32>
__global__ void __launch_bounds__(NT, min_blocks<BM>())
fp8_block_gemm_kernel(const uint8_t* __restrict__ x,
                      const float* __restrict__ xs,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ ws, void* __restrict__ out,
                      float* __restrict__ partial, int M, int N, int K,
                      int chunks_per_split) {
  using T = Tile<BM>;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp * T::WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = K / KC;  // scale blocks along K
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(kb, c_begin + chunks_per_split);
  const int n_chunks = c_end - c_begin;

  auto stage_x = [&](int st) { return smem + st * T::STAGE; };
  auto stage_w = [&](int st) { return smem + st * T::STAGE + T::X_BYTES; };

  auto load_chunk = [&](int st, int i) {
    const size_t k0 = (size_t)(c_begin + i) * KC;
    uint8_t* sx = stage_x(st);
    uint8_t* sw = stage_w(st);
    constexpr int V = KC / 16;  // 16-byte vectors per row
    for (int v = tid; v < BM * V; v += NT) {
      const int r = v / V, col = (v % V) * 16;
      const int m = m0 + r;
      cp_async16(&sx[r * T::RS + col],
                 x + (size_t)min(m, M - 1) * K + k0 + col, m < M);
    }
    for (int v = tid; v < BN * V; v += NT) {
      const int r = v / V, col = (v % V) * 16;
      const int n = n0 + r;
      cp_async16(&sw[r * T::RS + col],
                 w + (size_t)min(n, N - 1) * K + k0 + col, n < N);
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

    const uint8_t* sx = stage_x(st);
    const uint8_t* sw = stage_w(st);

    // this block's scales: one of the weight for the whole tile, one of
    // the activation per row of the fragment (rows g and g + 8)
    const int c = c_begin + i;
    const float wsv = ws[(size_t)blockIdx.x * kb + c];
    float xsv[T::MI][2];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + mi * 16 + g + 8 * r;
        xsv[mi][r] = m < M ? xs[(size_t)m * kb + c] : 0.f;
      }

    float part[T::MI][T::NJ][4];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < T::NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;

#pragma unroll
    for (int kk = 0; kk < KC; kk += 32) {
      // rows g, g + 8 at bytes 4t..4t+3 (a[0], a[1]) and 16+4t.. (a[2], a[3])
      uint32_t a[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        ldmatrix_x4(a[mi], &sx[(mi * 16 + (lane & 15)) * T::RS + kk +
                               16 * (lane >> 4)]);
#pragma unroll
      for (int nj = 0; nj < T::NJ; ++nj) {
        // column n = g at bytes 4t..4t+3 and 16+4t..
        const uint8_t* wb = &sw[(wn + nj * 8 + g) * T::RS + kk + 4 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wb + 16);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
          mma16832_e4m3(part[mi][nj], a[mi], b0, b1);
      }
    }

    // acc += part * xs[m, kb] * ws[n / 128, kb], in f32
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < T::NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][nj][e] += __fmul_rn(__fmul_rn(part[mi][nj][e],
                                                xsv[mi][e >> 1]), wsv);
  }

  write_tile<T::MI, T::NJ, OUT_F32>(acc, out, partial, nullptr, M, N, m0,
                                     n0 + wn, lane, blockIdx.z);
}

template <int BM, bool OUT_F32>
int launch(const void* x, const void* xs, const void* w, const void* ws,
           void* out, void* partial, int M, int N, int K, int splits,
           cudaStream_t st) {
  using T = Tile<BM>;
  auto kern = fp8_block_gemm_kernel<BM, OUT_F32>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         T::SMEM);
    attr = true;
  }
  const int kb = K / KC;
  const int cps = (kb + splits - 1) / splits;
  const dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, NT, T::SMEM, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(ws), out,
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, cps);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, nullptr, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bm in {16, 32, 64}; N and K multiples of 128; splits >= 1 K-splits
// (partial: [splits, M, N] f32 scratch when splits > 1).
extern "C" int llmc_fp8_block_gemm(const void* x, const void* xs,
                                   const void* w, const void* ws, void* out,
                                   void* partial, int M, int N, int K,
                                   int out_f32, int bm, int splits,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_BM(bm, true, launch, x, xs, w, ws, out, partial, M,
                            N, K, splits, st);
  return LLMC_DISPATCH_BM(bm, false, launch, x, xs, w, ws, out, partial, M, N,
                          K, splits, st);
}
