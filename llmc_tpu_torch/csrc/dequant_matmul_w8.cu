// w8_dequant_matmul: y = x @ dequant(codes)^T for W8A16 — bf16 activations
// against per-group int8 weight codes — on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/dequant_matmul.py::_kernel_w8 (the Pallas TPU
// kernel, pallas_call at :467).  Same function: per scale group,
//   w[n,k] = bf16( (f32(code[n,k]) - z[g,n]) * s[g,n] )
//   y[m,n] = sum_k bf16(x[m,k]) * w[n,k]          (f32 accumulation)
// The rounding of the dequantized weight to bf16 is part of the function,
// so the scale multiplies the weight BEFORE the dot here; it must not move
// to after the dot (dequant_matmul_w4.cu may do that: its codes are exact
// in bf16, these products are not).
//
// Layout.  x [M, K] bf16; codes [N, K] int8 (signed); s, z [N, ng] f32, as
// the packer stores them (z absent when has_z == 0); gs the group size, a
// multiple of KC = 128, so every chunk lies in one group.  A warp reads
// one (s, z) per output column and chunk, 4 bytes of a 32-byte sector
// whose other groups the following chunks find in the cache.
//
// What bounds it on an H100: at decode (M <= 128) the weight stream, K
// bytes per output column — the card's memory rate; at M = 4096 the bf16
// tensor-core rate, and before that this kernel's own dequantization: four
// instructions per weight on the CUDA cores, done once per CTA and reused
// by BM / 16 mma.  Design: 256 threads on a BM x 128 output tile, BM in
// {16, 32, 64} from M; a ring of STAGES cp.async buffers over KC-column
// chunks of x and codes; the 8 warps side by side along N, each over all
// BM rows, so a B fragment is dequantized once and feeds BM / 16 mma.sync
// m16n8k16 bf16 -> f32; A fragments by ldmatrix; split-K over CTAs below
// one wave, summed in a fixed order by a second kernel.  Not yet: wgmma,
// TMA, a wider row tile to amortise the dequantization at prefill.

#include "gemm_common.cuh"

namespace {

template <int BM>
struct Tile {
  static constexpr int WN = BN / 8;
  static constexpr int MI = BM / 16, NJ = WN / 8;
  static constexpr int XS = KC + 8;   // x smem row stride, bf16 elements
  static constexpr int WS = KC + 16;  // codes smem row stride, bytes
  static constexpr int X_BYTES = BM * XS * 2;
  static constexpr int W_BYTES = BN * WS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "alignment");
};

// two int8 codes (the low two bytes of u) -> bf16x2 of (code - z) * s
__device__ __forceinline__ uint32_t dequant2(uint32_t u, float s, float z) {
  const float c0 = (float)(int8_t)(u & 0xFF);
  const float c1 = (float)(int8_t)((u >> 8) & 0xFF);
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(c0 - z, s),
                                                 __fmul_rn(c1 - z, s));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BM, bool OUT_F32>
__global__ void __launch_bounds__(NT, min_blocks<BM>())
w8_dequant_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ s, const float* __restrict__ z,
    void* __restrict__ out, float* __restrict__ partial, int M, int N, int K,
    int gs, int has_z, int chunks_per_split) {
  using T = Tile<BM>;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp * T::WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int total = K / KC, ng = K / gs;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(total, c_begin + chunks_per_split);
  const int n_chunks = c_end - c_begin;

  auto stage_x = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * T::STAGE);
  };
  auto stage_w = [&](int st) { return smem + st * T::STAGE + T::X_BYTES; };

  auto load_chunk = [&](int st, int i) {
    const size_t k0 = (size_t)(c_begin + i) * KC;
    __nv_bfloat16* sx = stage_x(st);
    uint8_t* sw = stage_w(st);
    constexpr int XV = KC / 8;  // 16-byte vectors per x row
    for (int v = tid; v < BM * XV; v += NT) {
      const int r = v / XV, col = (v % XV) * 8;
      const int m = m0 + r;
      cp_async16(&sx[r * T::XS + col],
                 x + (size_t)min(m, M - 1) * K + k0 + col, m < M);
    }
    constexpr int WV = KC / 16;  // 16-byte vectors per codes row
    for (int v = tid; v < BN * WV; v += NT) {
      const int r = v / WV, col = (v % WV) * 16;
      const int n = n0 + r;
      cp_async16(&sw[r * T::WS + col],
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

    const __nv_bfloat16* sx = stage_x(st);
    const uint8_t* sw = stage_w(st);

    // this chunk's scale group: one (s, z) per output column of the warp
    const int sg = ((c_begin + i) * KC) / gs;
    float sv[T::NJ], zv[T::NJ];
#pragma unroll
    for (int nj = 0; nj < T::NJ; ++nj) {
      const int n = n0 + wn + nj * 8 + g;
      sv[nj] = n < N ? s[(size_t)n * ng + sg] : 0.f;
      zv[nj] = (has_z && n < N) ? z[(size_t)n * ng + sg] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        ldmatrix_x4(a[mi], &sx[(mi * 16 + (lane & 15)) * T::XS + kk +
                               8 * (lane >> 4)]);
#pragma unroll
      for (int nj = 0; nj < T::NJ; ++nj) {
        // B fragment: column n = g, k = 2t, 2t+1 and 2t+8, 2t+9
        const uint8_t* wb = &sw[(wn + nj * 8 + g) * T::WS + kk + 2 * t];
        const uint32_t b0 = dequant2(
            *reinterpret_cast<const uint16_t*>(wb), sv[nj], zv[nj]);
        const uint32_t b1 = dequant2(
            *reinterpret_cast<const uint16_t*>(wb + 8), sv[nj], zv[nj]);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
          mma16816(acc[mi][nj], a[mi], b0, b1);
      }
    }
  }

  write_tile<T::MI, T::NJ, OUT_F32>(acc, out, partial, nullptr, M, N, m0,
                                     n0 + wn, lane, blockIdx.z);
}

template <int BM, bool OUT_F32>
int launch(const void* x, const void* codes, const void* s, const void* z,
           void* out, void* partial, int M, int N, int K, int gs, int has_z,
           int splits, cudaStream_t st) {
  using T = Tile<BM>;
  auto kern = w8_dequant_matmul_kernel<BM, OUT_F32>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         T::SMEM);
    attr = true;
  }
  const int total = K / KC;
  const int cps = (total + splits - 1) / splits;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, NT, T::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(s), static_cast<const float*>(z), out,
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, gs, has_z,
      cps);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, nullptr, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bm in {16, 32, 64}; gs a multiple of 128 (KC) that divides K; splits >= 1
// K-splits (partial: [splits, M, N] f32 scratch when splits > 1).
extern "C" int llmc_w8_dequant_matmul(const void* x, const void* codes,
                                      const void* s, const void* z, void* out,
                                      void* partial, int M, int N, int K,
                                      int gs, int has_z, int out_f32, int bm,
                                      int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_BM(bm, true, launch, x, codes, s, z, out, partial, M,
                            N, K, gs, has_z, splits, st);
  return LLMC_DISPATCH_BM(bm, false, launch, x, codes, s, z, out, partial, M,
                          N, K, gs, has_z, splits, st);
}
