// What the two decode-attention kernels share: flash_decode.cu (B2, one
// slot a CTA) and batch_decode.cu (B5, a block of slots a CTA).  Both
// compute, for slot b and query head h,
//   ctx[b,h] = sum_{j <= pos[b]} softmax_j(q[b,h] . k[j]) v[j]
// over the [L, B, Smax, KVH, hd] cache at `layer`, and both read it the
// same way: a producer thread keeps chunks of C positions of one kv head
// in flight by TMA over a 2-D view of the cache (a row is one position of
// one kv head, hd elements; rows (layer * B + b) * Smax + j), and four
// consumer warps score them out of shared memory.  The cache is one of
// four kinds: KIND 0 int8 codes with per-(position, kv head) f32 scales,
// KIND 1 bf16 values, KIND 2 f32 values (a float32 model's cache), KIND 3
// fp16 values (read as they lie, converted in registers as bf16 is).
//
// Here: the chunk and thread counts, the bulk copy of the query rows, the
// conversion of a thread's channels of a row to f32, the merge of two
// online-softmax states, the tensor-map cache, and the split-K epilogue:
// a split that is not alone writes its (acc, m, l) to an f32 workspace,
// and the last CTA of a (slot, kv head, head group) to arrive (an atomic
// arrival counter, which it resets) merges the splits in split order, so
// that a rerun gives the same bits.
//
// The head dim.  Both kernels are templates on HDM, the largest row they
// lay out (128 or 256), and work on rows of hp channels in shared memory:
// hd rounded up to a power of two, at least 16 (kernel_hd).  Where hd is a
// power of two, hp = hd and TMA reads the rows as before.  Else a row's
// start is no multiple of 16 bytes in general (hd 72 of int8: 72 bytes),
// which a TMA box does not take: the kernel copies the valid rows by
// 4-byte cp.async into rows of hp channels whose tail it zeroed once, and
// the tail meets q's zeros in the scores and fills accumulator channels
// that are never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <mutex>

#include "wgmma_common.cuh"  // mbarriers, TMA, tensor-map encoding

namespace {
namespace dc {

constexpr int C = 64;           // positions a chunk (a TMA box's rows)
constexpr int NCW = 4;          // consumer warps
constexpr int NC = NCW * 32;    // consumer threads
constexpr int NTH = NC + 32;    // and one producer warp
constexpr int HD_LIMIT = 256;   // the largest head dim: HDM = 256
constexpr float LOG2E = 1.4426950408889634f;

template <int KIND>
struct Elem {
  static constexpr int ESZ = KIND == 0 ? 1 : KIND == 2 ? 4 : 2;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory by the bulk
// copy engine, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(wg::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(wg::smem_u32(bar))
      : "memory");
}

// 4 bytes from global to shared memory by cp.async
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies land
// (the barrier counts it among its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          wg::smem_u32(bar))
      : "memory");
}

// 2^23 + 128 + code, as a float, minus 2^23 + 128: the int8 code, exactly
__device__ __forceinline__ float code_at(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + k)) -
         8388736.f;
}

// 4 int8 codes (one word) -> floats
__device__ __forceinline__ void unpack_i8(uint32_t w, float* f) {
  const uint32_t b = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = code_at(b, k);
}

// 2 bf16 values (one word) -> floats
__device__ __forceinline__ void unpack_bf16(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}

// 2 fp16 values (one word) -> floats
__device__ __forceinline__ void unpack_f16(uint32_t w, float* f) {
  const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w));
  f[0] = v.x;
  f[1] = v.y;
}

// The row a kernel lays out for head dim hd: hd rounded up to a power of
// two, at least 16.
__host__ __device__ inline int kernel_hd(int hd) {
  int hp = 16;
  while (hp < hd) hp *= 2;
  return hp;
}

// Whether the kernels take head dim hd: at most HD_LIMIT, and q's rows of
// whole float4s (a cache row of 4-byte words for cp.async too).
__host__ __device__ inline bool kernel_takes_hd(int hd) {
  return hd >= 1 && hd <= HD_LIMIT && hd % 4 == 0;
}

// A thread of the CUDA-core loops covers CPR channels of a row, LPR
// threads a row: CPR = HDM / LPR.  It reads them in pieces of 16 bytes (PE
// elements), the LPR threads of a row one piece each side by side: element
// i of the thread is channel Row::channel(cg, i).
constexpr int LPR = 8;

template <int KIND, int CPR>
struct Row {
  static constexpr int ESZ = Elem<KIND>::ESZ;
  static constexpr int PE = 16 / ESZ;  // elements a piece
  static constexpr int NP = CPR / PE;  // pieces a thread

  static __device__ __forceinline__ int channel(int cg, int i) {
    return (i / PE) * (LPR * PE) + cg * PE + i % PE;
  }

  // the thread's CPR values of the row at `row` (bytes), zeros where its
  // channels lie past hd (hd the laid-out row: a piece is whole or out)
  static __device__ __forceinline__ void values(const uint8_t* row, int cg,
                                                int hd, float* f) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = p * LPR * PE + cg * PE;
      float* fp = f + p * PE;
      if (c >= hd) {
#pragma unroll
        for (int i = 0; i < PE; ++i) fp[i] = 0.f;
        continue;
      }
      const uint4 u = *reinterpret_cast<const uint4*>(row + c * ESZ);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (KIND == 0)
          unpack_i8(w[k], fp + 4 * k);
        else if constexpr (KIND == 1)
          unpack_bf16(w[k], fp + 2 * k);
        else if constexpr (KIND == 3)
          unpack_f16(w[k], fp + 2 * k);
        else
          fp[k] = __uint_as_float(w[k]);
      }
    }
  }
};

// Merge the online-softmax state (m, l, acc[CPR]) of this lane with the
// lane `d` apart (the same channels of another row slice).  m is in base 2.
template <int CPR>
__device__ __forceinline__ void merge_lanes(float& m, float& l, float* acc,
                                            int d) {
  const float mo = __shfl_xor_sync(0xffffffffu, m, d);
  const float lo = __shfl_xor_sync(0xffffffffu, l, d);
  const float M = fmaxf(m, mo);
  const float e = m == -INFINITY ? 0.f : exp2f(m - M);
  const float eo = mo == -INFINITY ? 0.f : exp2f(mo - M);
  l = l * e + lo * eo;
#pragma unroll
  for (int c = 0; c < CPR; ++c)
    acc[c] = acc[c] * e + __shfl_xor_sync(0xffffffffu, acc[c], d) * eo;
  m = M;
}

// ---- split-K epilogue --------------------------------------------------
//
// Workspace: [B, KVH, S, G, hd + 2] f32, per (slot, kv head, split, head)
// the unnormalised acc[hd], then m (base 2) and l.  Arrival counters: one
// int32 per (slot, kv head, head group), zero between launches.

// Whether this CTA is the last of the `active` splits of its (slot, kv
// head, head group) to arrive; every consumer thread calls it once its
// workspace rows are written, and all of them get the answer.  `flag` is
// a shared int.
__device__ __forceinline__ bool last_to_arrive(int* counter, int active,
                                               int* flag) {
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == active - 1;
  consumers_sync();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// The same for a split that one warp computes: every lane calls it.
__device__ __forceinline__ bool warp_last_to_arrive(int* counter,
                                                    int active) {
  __threadfence();
  __syncwarp();
  int last = 0;
  if ((threadIdx.x & 31) == 0) last = atomicAdd(counter, 1) == active - 1;
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last) __threadfence();
  return last != 0;
}

// ctx of `gn` heads from the `active` splits' states, merged in split
// order by the consumer threads: w0 is split 0's row of the first head,
// `step` floats from one split to the next; ctx of head gg goes to
// out + gg * hd.  Then the arrival counter is reset for the next launch.
__device__ __forceinline__ void combine_splits(const float* w0, size_t step,
                                               int active, int gn, int hd,
                                               float* out, int* counter) {
  for (int idx = threadIdx.x; idx < gn * hd; idx += NC) {
    const int gg = idx / hd, c = idx % hd;
    const float* w = w0 + (size_t)gg * (hd + 2);
    float M = -INFINITY;
    for (int s = 0; s < active; ++s) M = fmaxf(M, __ldcg(w + s * step + hd));
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < active; ++s) {
      const float ms = __ldcg(w + s * step + hd);
      if (ms != -INFINITY) {
        const float e = exp2f(ms - M);
        Lsum = fmaf(__ldcg(w + s * step + hd + 1), e, Lsum);
        A = fmaf(__ldcg(w + s * step + c), e, A);
      }
    }
    out[(size_t)gg * hd + c] = A / fmaxf(Lsum, 1e-30f);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

// The same merge by one warp (B5), split-major: the splits' maxima, then
// for each split in order its weight (lane s computes split s's), and each
// lane's channels lane + 32 k read in 128-byte rows, hd <= HDM.
template <int HDM>
__device__ __forceinline__ void warp_combine_splits(const float* w0,
                                                    size_t step, int active,
                                                    int gn, int hd,
                                                    float* out,
                                                    int* counter) {
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < gn; ++g) {
    const float* w = w0 + (size_t)g * (hd + 2);
    float M = -INFINITY;
    for (int s = lane; s < active; s += 32)
      M = fmaxf(M, __ldcg(w + s * step + hd));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float A[HDM / 32], Lsum = 0.f;
#pragma unroll
    for (int k = 0; k < HDM / 32; ++k) A[k] = 0.f;
    for (int s0 = 0; s0 < active; s0 += 32) {
      const int s = s0 + lane;
      float e = 0.f, ls = 0.f;
      if (s < active) {
        const float ms = __ldcg(w + s * step + hd);
        if (ms != -INFINITY) {
          e = exp2f(ms - M);
          ls = __ldcg(w + s * step + hd + 1);
        }
      }
      const int n = min(32, active - s0);
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float et = __shfl_sync(0xffffffffu, e, t);
        Lsum = fmaf(__shfl_sync(0xffffffffu, ls, t), et, Lsum);
        const float* ws = w + (size_t)(s0 + t) * step;
#pragma unroll
        for (int k = 0; k < HDM / 32; ++k)
          if (lane + 32 * k < hd)
            A[k] = fmaf(__ldcg(ws + lane + 32 * k), et, A[k]);
      }
    }
    const float inv = 1.f / fmaxf(Lsum, 1e-30f);
#pragma unroll
    for (int k = 0; k < HDM / 32; ++k)
      if (lane + 32 * k < hd)
        out[(size_t)g * hd + lane + 32 * k] = A[k] * inv;
  }
  if (lane == 0) *counter = 0;  // ready for the next launch
}

// ---- host side ---------------------------------------------------------

// The TMA element type of a cache kind (the box is hp elements wide: at
// most 256 of them, where 1024 bytes of f32 would not fit a byte box).
template <int KIND>
inline CUtensorMapDataType tma_type() {
  return KIND == 0   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : KIND == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
         : KIND == 3 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// Tensor maps of a cache, kept by (address, kind, shape, box): a
// serving run reads the same two buffers at every layer and step.
struct MapKey {
  const void* base;
  int kind;
  uint64_t rows, cols;
  uint32_t box_cols, box_rows;
};

template <int KIND>
int cached_map(CUtensorMap* map, const void* base, uint64_t rows,
               uint64_t cols, uint32_t box_cols, uint32_t box_rows = C) {
  constexpr int N = 16;
  static std::mutex mu;
  static MapKey keys[N];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i].base == base && keys[i].kind == KIND &&
        keys[i].rows == rows && keys[i].cols == cols &&
        keys[i].box_cols == box_cols && keys[i].box_rows == box_rows) {
      *map = maps[i];
      return 0;
    }
  const int e = wg::encode_2d(map, base, tma_type<KIND>(), Elem<KIND>::ESZ,
                              rows, cols, box_rows, box_cols,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  keys[next] = MapKey{base, KIND, rows, cols, box_cols, box_rows};
  maps[next] = *map;
  next = (next + 1) % N;
  used = used < N ? used + 1 : N;
  return 0;
}

}  // namespace dc
}  // namespace
