// w8_dequant_matmul: y = x @ dequant(codes)^T for W8A16 — bf16 activations
// against per-group int8 weight codes — on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/dequant_matmul.py::_kernel_w8 (the Pallas TPU
// kernel, pallas_call at :467).  Same function: per scale group,
//   w[n,k] = bf16( (f32(code[n,k]) - z[g,n]) * s[g,n] )
//   y[m,n] = sum_k bf16(x[m,k]) * w[n,k]          (f32 accumulation)
// The rounding of the dequantized weight to bf16 is part of the function,
// so the scale multiplies the weight BEFORE the dot here, in the decode of
// wgmma's A fragment; it must not move to after the dot
// (dequant_matmul_w4.cu may do that: its codes are exact in bf16, these
// products are not).
//
// Layout.  x [M, K] bf16; codes [N, K] int8 (signed); s, z [N, ng] f32, as
// the packer stores them (z absent when has_z == 0); gs the group size, a
// multiple of 32 that divides K, so each 32-column half of a 64-column
// unit lies in one group: a unit spans one group, or two where gs is no
// multiple of 64 (G2, which looks the scales up for each half).
//
// What bounds it on an H100: at decode (M <= 128) the weight stream, K
// bytes per output column — the card's memory rate; at M = 4096 the bf16
// tensor-core rate, and before it this kernel's dequantization: four to
// five instructions a weight on the CUDA cores (a byte_perm to an f32
// magic number, the exact subtractions, the scale, half a bf16x2 pack),
// done once per CTA and T tokens.  The design before this one (a 64-row
// mma.sync tile, 8 warps along N each loading the whole x tile) reached
// neither bound.  This one runs on the skeleton of wgmma_common.cuh: the
// token count is wgmma's N, so the weight is read and dequantized once per
// T <= 128 tokens; x reaches the tensor cores from shared memory by TMA;
// the codes are dequantized in registers straight into wgmma's A fragment,
// the next unit's while the tensor cores run the current one.  The
// dequantization still binds it: on gate_up at M=4096 it read 2.23-2.52 ms
// as built, 1.35 with no dequantization, 1.59-1.63 with no wgmma
// (tools/wgmma_variants.py, PERF.md).

#include "wgmma_common.cuh"

namespace {

using namespace wg;

// two int8 codes of w2 (bytes picked by sel0, sel1; every byte of w2 is
// code + 128) -> bf16x2 of bf16((code - z) * s), or bf16(code * s) for a
// weight without zeros.  0x4B0000cc is the f32 2^23 + cc, so the code comes
// out exact.
template <bool HAS_Z>
__device__ __forceinline__ uint32_t dequant2(uint32_t w2, uint32_t sel0,
                                             uint32_t sel1, float s, float z) {
  float c0 = __fsub_rn(__uint_as_float(__byte_perm(w2, 0x4B000000u, sel0)),
                       8388736.f);
  float c1 = __fsub_rn(__uint_as_float(__byte_perm(w2, 0x4B000000u, sel1)),
                       8388736.f);
  if (HAS_Z) {
    c0 = __fsub_rn(c0, z);
    c1 = __fsub_rn(c1, z);
  }
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fmul_rn(c0, s), __fmul_rn(c1, s));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int T, bool HAS_Z, bool G2, bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 1) w8_dequant_matmul_kernel(
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx, const float* __restrict__ s,
    const float* __restrict__ z, void* __restrict__ out,
    float* __restrict__ partial, int M, int N, int K, int gs,
    int units_per_split) {
  using L = Layout<T, 1, 0>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  // output tiles with the weight-row tiles fastest
  const int nt = (N + ROWS - 1) / ROWS;
  const int m0 = (blockIdx.x / nt) * T, n0 = (blockIdx.x % nt) * ROWS;
  const int units = K / UNIT, ng = K / gs;
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
    if (tid == CONSUMERS) {
      for (int i = 0; i < nu; ++i) {
        const int st = i % S;
        mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        uint8_t* buf = smem + st * L::STAGE;
        const int k0 = (u0 + i) * UNIT;
        mbar_expect_tx(&full[st], L::STAGE);
        tma_load_2d(buf, &tw, &full[st], k0, n0);
        tma_load_2d(buf + L::W_BYTES, &tx, &full[st], k0, m0);
      }
    }
  } else {
    const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wgi * 64 + warp * 16 + g;  // tile rows r0 and r0 + 8
    const int nr[2] = {n0 + r0, n0 + r0 + 8};
    float acc[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;

    // the scales of unit i's group (of each 32-column half's group: G2),
    // loaded a unit ahead of its decode
    constexpr int G = G2 ? 2 : 1;
    auto scales = [&](float(&dst)[G][4], int i) {
#pragma unroll
      for (int hf = 0; hf < G; ++hf) {
        const int sg = ((u0 + i) * UNIT + 32 * hf) / gs;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const size_t o = (size_t)nr[rh] * ng + sg;
          dst[hf][rh] = nr[rh] < N ? __ldg(s + o) : 0.f;
          dst[hf][2 + rh] = (HAS_Z && nr[rh] < N) ? __ldg(z + o) : 0.f;
        }
      }
    };
    float sc[G][4], sc_next[G][4];
    // A fragments of unit i (k16 step ks: {row g, g+8} x {k 2t..,
    // k 2t+8..}), dequantized while the tensor cores work on unit i - 1
    auto decode = [&](uint32_t(&a)[4][4], int i) {
      if (i + 1 < nu) scales(sc_next, i + 1);
      const int st = i % S;
      mbar_wait(&full[st], (i / S) & 1);
      const uint8_t* buf = smem + st * L::STAGE;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float* c = sc[G2 ? ks >> 1 : 0];  // k16 step ks's group
          const uint32_t w2 =
              frag_bytes(buf, r0 + 8 * rh, ks, t) ^ 0x80808080u;
          a[ks][rh] = dequant2<HAS_Z>(w2, 0x7540, 0x7541, c[rh], c[2 + rh]);
          a[ks][2 + rh] =
              dequant2<HAS_Z>(w2, 0x7542, 0x7543, c[rh], c[2 + rh]);
        }
#pragma unroll
      for (int hf = 0; hf < G; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[hf][e] = sc_next[hf][e];
    };
    // issue unit i's wgmma on fragments a; then, with it in flight, wait
    // for unit i - 1, release its stage, and decode unit i + 1 into b
    auto step = [&](uint32_t(&a)[4][4], uint32_t(&b)[4][4], int i) {
      const uint64_t d = desc_k<128>(smem + (i % S) * L::STAGE + L::W_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_rs<T>(acc, a[ks], d + 2 * ks, 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(b);
      if (i > 0) release_stage(&empty[(i - 1) % S], lane);
      if (i + 1 < nu) decode(b, i + 1);
    };
    uint32_t a0[4][4], a1[4][4];
    if (nu > 0) scales(sc, 0);
    if (nu > 0) decode(a0, 0);
    for (int i = 0; i < nu; i += 2) {
      step(a0, a1, i);
      if (i + 1 < nu) step(a1, a0, i + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a0);
    fence_regs(a1);
    if (nu > 0) release_stage(&empty[(nu - 1) % S], lane);
    store_tile<T, OUT_F32>(acc, smem, out, partial, nullptr, M, N, m0, n0,
                           blockIdx.z, r0, t);
  }
}

template <int T, bool OUT_F32>
int launch(const void* x, const void* codes, const void* s, const void* z,
           void* out, void* partial, int M, int N, int K, int gs, int has_z,
           int splits, cudaStream_t st) {
  using L = Layout<T, 1, 0>;
  // a unit can span two groups; where it cannot, one scale lookup a unit
  // reads faster (tools/wgmma_variants.py's two_group_lookup, PERF.md)
  const bool g2 = gs % UNIT != 0;
  auto kern = has_z ? (g2 ? w8_dequant_matmul_kernel<T, true, true, OUT_F32>
                          : w8_dequant_matmul_kernel<T, true, false, OUT_F32>)
                    : (g2 ? w8_dequant_matmul_kernel<T, false, true, OUT_F32>
                          : w8_dequant_matmul_kernel<T, false, false, OUT_F32>);
  const int which = 2 * (has_z != 0) + g2;
  static bool attr[4] = {false, false, false, false};
  if (!attr[which]) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L::SMEM);
    attr[which] = true;
  }
  CUtensorMap tw, tx;
  int e = encode_2d(&tw, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K,
                    ROWS, UNIT, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = encode_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K,
                  T, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  const int units = K / UNIT;
  const int ups = (units + splits - 1) / splits;
  const dim3 grid(((M + T - 1) / T) * ((N + ROWS - 1) / ROWS), 1, splits);
  kern<<<grid, NTHREADS, L::SMEM, st>>>(
      tw, tx, static_cast<const float*>(s), static_cast<const float*>(z), out,
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, gs, ups);
  if (splits > 1)
    launch_split_sum<OUT_F32>(partial, out, nullptr, splits, M, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tok_tile in {8, 16, 32, 64, 128}; gs a multiple of 32 that divides K, K
// a multiple of 64;
// splits >= 1 K-splits (partial: [splits, M, N] f32 scratch when
// splits > 1).
extern "C" int llmc_w8_dequant_matmul(const void* x, const void* codes,
                                      const void* s, const void* z, void* out,
                                      void* partial, int M, int N, int K,
                                      int gs, int has_z, int out_f32,
                                      int tok_tile, int splits,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return LLMC_DISPATCH_T(tok_tile, true, launch, x, codes, s, z, out,
                           partial, M, N, K, gs, has_z, splits, st);
  return LLMC_DISPATCH_T(tok_tile, false, launch, x, codes, s, z, out,
                         partial, M, N, K, gs, has_z, splits, st);
}
