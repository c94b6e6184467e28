// Pieces shared by the mma.sync GEMM kernels (the probes of probe_gemm.cu
// and B1's old design in dequant_matmul_w4_mma.cu): the cp.async ring's
// primitives, the tensor-core fragments, the output write and the split-K
// sum.  The wgmma kernels (wgmma_common.cuh: B1, B3, B4, B6) use only the
// split-K sum.  Everything sits in an anonymous namespace, so
// each source gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;    // output columns per CTA
constexpr int NT = 256;    // 8 warps, side by side along N
constexpr int STAGES = 4;  // chunks in flight (cp.async ring)
constexpr int KC = 128;    // K columns per chunk (of each half group for W4;
                           // one scale block for FP8)

// CTAs per SM the register budget is set for (shared memory allows it)
template <int BM>
constexpr int min_blocks() { return BM <= 16 ? 2 : 1; }

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 x 32 int8 (row) times 32 x 8 int8 (col) into 16 x 8 int32
__device__ __forceinline__ void mma16832_s8(int* c, const uint32_t* a,
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of one mma (16 rows x 32 bytes, row-major in shared memory:
// 16 bf16 of m16n8k16, or 32 int8 of m16n8k32): lane l gives the address
// of row l % 16 at byte 16 * (l / 16)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Write the accumulators of one warp's BM x 16 slice: the output (bf16 or
// f32, each row times row_scale[m] when given), or this split's f32
// partial.  acc[mi][nj][e] is the m16n8 C fragment: rows g and g + 8,
// columns 2t and 2t + 1.
template <int MI, int NJ, bool OUT_F32>
__device__ __forceinline__ void write_tile(
    const float (&acc)[MI][NJ][4], void* __restrict__ out,
    float* __restrict__ partial, const float* __restrict__ row_scale, int M,
    int N, int m0, int n0w, int lane, int split) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + mi * 16 + g + 8 * r;
        const int n = n0w + nj * 8 + 2 * t;
        if (m >= M || n >= N) continue;  // N is even: n + 1 < N too
        float v0 = acc[mi][nj][2 * r], v1 = acc[mi][nj][2 * r + 1];
        const size_t o = (size_t)m * N + n;
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(partial + (size_t)split * M * N + o) =
              make_float2(v0, v1);
          continue;
        }
        if (row_scale != nullptr) {
          v0 *= row_scale[m];
          v1 *= row_scale[m];
        }
        if (OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                             o) = __floats2bfloat162_rn(v0, v1);
        }
      }
}

// Sum the split-K partials [splits, M*N] in split order into the output
// (deterministic), each row times row_scale[m] when given.  A thread takes
// two neighbouring elements (as float2 where M*N and N are even).
template <bool OUT_F32>
__global__ void __launch_bounds__(256) split_sum_kernel(
    const float* __restrict__ partial, void* __restrict__ out,
    const float* __restrict__ row_scale, int splits, size_t mn, int N) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2;
  if (i >= mn) return;
  if (mn % 2 || N % 2) {  // an odd N: one element at a time
    for (size_t e = i; e < i + 2 && e < mn; ++e) {
      float a = partial[e];
      for (int z = 1; z < splits; ++z) a += partial[z * mn + e];
      if (row_scale != nullptr) a *= row_scale[e / N];
      if (OUT_F32)
        static_cast<float*>(out)[e] = a;
      else
        static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(a);
    }
    return;
  }
  float2 a = *reinterpret_cast<const float2*>(partial + i);
  for (int z = 1; z < splits; ++z) {
    const float2 b = *reinterpret_cast<const float2*>(partial + z * mn + i);
    a.x += b.x;
    a.y += b.y;
  }
  if (row_scale != nullptr) {  // N is even: i and i + 1 lie in one row
    const float r = row_scale[i / N];
    a.x *= r;
    a.y *= r;
  }
  if (OUT_F32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = a;
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       i) = __floats2bfloat162_rn(a.x, a.y);
}

template <bool OUT_F32>
void launch_split_sum(const void* partial, void* out, const float* row_scale,
                      int splits, int M, int N, cudaStream_t st) {
  const size_t mn = (size_t)M * N;
  // a thread takes two elements: (mn + 1) / 2 threads cover an odd mn too
  const unsigned blocks = (unsigned)(((mn + 1) / 2 + 255) / 256);
  split_sum_kernel<OUT_F32><<<blocks, 256, 0, st>>>(
      static_cast<const float*>(partial), out, row_scale, splits, mn, N);
}

// launch<BM, OUT_F32>(args...) for the caller's row tile
#define LLMC_DISPATCH_BM(bm, OUT_F32, launch_fn, ...)       \
  ((bm) == 16   ? launch_fn<16, OUT_F32>(__VA_ARGS__)       \
   : (bm) == 32 ? launch_fn<32, OUT_F32>(__VA_ARGS__)       \
                : launch_fn<64, OUT_F32>(__VA_ARGS__))

}  // namespace
