// flash_decode: one-token decode attention over the KV cache, read in
// place, on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/flash_decode.py::_kernel (the Pallas TPU kernel,
// pallas_call at :171).  Same function: for slot b and query head h,
//   ctx[b,h] = sum_{j <= pos[b]} softmax_j(q[b,h] . k[j]) v[j]
// over the [L, B, Smax, KVH, hd] cache at `layer`, with GQA (G = H/KVH
// query heads per kv head; head h reads kv head h / G).  The cache holds
// int8 codes with per-(token, head) f32 scales [L, B, Smax, KVH], or bf16
// values.  q arrives f32 and pre-scaled.  The K scale multiplies the
// scores after the dot and the V scale folds into the probabilities —
// nothing is dequantized element-wise.  Online softmax (m, l, acc) in f32.
//
// What bounds it on an H100: the valid cache prefix, (pos[b] + 1) rows of
// K and V per (slot, kv head) — the card's memory rate; the arithmetic is
// about 2 G flops per byte read.  The TPU walked a slot's cache in one
// sequential grid row; here that walk is cut three ways:
//
// - Split-K over the cache (flash-decoding).  The grid is (split, kv head,
//   slot): a (slot, kv head) is cut into S splits of `cps` whole 64-row
//   chunks, S chosen on the host from B, KVH, Smax and the SM count so the
//   grid fills the card about twice over (ops/flash_decode.py::
//   split_plan).  A split wholly past pos[b] exits at once; the host never
//   reads pos.  With one active split the CTA writes ctx itself; else each
//   split writes its (m, l, acc[G, hd]) to an f32 workspace and the last
//   CTA of the (slot, kv head) to arrive (an atomic arrival counter, reset
//   by that CTA) combines them in split order, so the result is the same
//   from run to run.  One launch either way.
// - An asynchronous ring.  A producer warp keeps up to STAGES chunks of K
//   and V in flight by TMA (cp.async.bulk.tensor over a 2-D byte view of
//   the cache: a row is one position of one kv head, hd * esize bytes; a
//   box is 64 positions of one kv head), each landing on its stage's
//   mbarrier, the split's G query rows riding with its first chunk by the
//   bulk copy engine.  The four consumer warps score one chunk while the
//   next ones arrive and release it by an `empty` mbarrier.  The int8
//   scales, 4 bytes a position 4 KVH bytes apart, are no TMA box: each
//   consumer thread loads those of its own rows a batch of rows ahead (the
//   chunk's first batch before it waits on the chunk).  Shared memory is
//   dynamic and sized by the cache's element size, hd, G and the split's
//   chunks (a ring of at most three).
// - All warps on the arithmetic.  Consumer thread t owns (query head g,
//   row slice rs, channel group cg): 16 channels of one head (int8: one
//   16-byte shared read a row; bf16: two, each 8 lanes over 128 contiguous
//   bytes), the rows j = rs (mod RS) of every chunk, RS = 16 / NG row
//   slices a head, NG the query heads a CTA serves (G rounded up to 1, 2,
//   4 or 8).  A score is the 8 channel groups' partial dots summed by
//   three shuffles; every (g, rs) keeps its own online softmax over its
//   rows, four rows at a time, and P.V accumulates in the thread's 16
//   channels.  The row slices merge once, at the end: a warp's by
//   shuffles, then the warps of a head through shared memory.  No barrier
//   across warps inside the loop.  int8 codes become f32 by a byte permute
//   and one add (2^23 + 128 + code, exactly).  q is scaled by log2(e) as it
//   is read, so the softmax runs on exp2.
//
// `layer` is a kernel argument and `pos` a device array, so no per-layer
// copy and no host sync.  The two tensor maps are encoded on the host and
// kept in a small cache keyed by the cache's address and shape.

#include <cuda_bf16.h>

#include <mutex>

#include "wgmma_common.cuh"  // mbarriers, TMA, tensor-map encoding

namespace {
namespace fd {

constexpr int C = 64;              // positions a chunk (a TMA box's rows)
constexpr int NCW = 4;             // consumer warps
constexpr int NC = NCW * 32;       // consumer threads
constexpr int NTH = NC + 32;       // and one producer warp
constexpr int CPR = 16;            // channels a thread covers in a row
constexpr int RB = 4;              // rows a thread takes per softmax update
constexpr int SLICES = NC / 8;     // (head, row slice) pairs: 8 lanes each
constexpr int HDMAX = 128;

// KIND 0: int8 codes + f32 scales; KIND 1: bf16 values
template <int KIND>
struct Ring {
  static constexpr int ESZ = KIND == 0 ? 1 : 2;
  // at most STAGES chunks in the ring: two in flight while one is scored
  static constexpr int STAGES = 3;
  // CTAs an SM holds with a full ring at hd = 128 (shared memory;
  // registers capped to match)
  static constexpr int RESIDENT = KIND == 0 ? 4 : 2;
  // K, V and, with a split's first chunk, its G query rows; a multiple
  // of 128 bytes (TMA's alignment)
  static __host__ __device__ int stage_bytes(int hd, int G) {
    return (2 * C * hd * ESZ + G * hd * 4 + 127) / 128 * 128;
  }
  // the ring's chunks where a split reads `chunks` at most
  static __host__ __device__ int stages(int chunks) {
    return chunks < STAGES ? chunks : STAGES;
  }
  // the ring, then its mbarriers.  The row slices' merge (8 slots of hd
  // floats, m and l at most: 32 hd + 64 bytes) reuses the ring's first
  // stage (at least 128 hd bytes) once every chunk is read.
  static __host__ __device__ int smem_bytes(int hd, int G, int stages) {
    return 128 + stages * stage_bytes(hd, G) + 2 * stages * 8;
  }
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

// 2^23 + 128 + code, as a float, minus 2^23 + 128: the int8 code, exactly
__device__ __forceinline__ float code_at(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + k)) -
         8388736.f;
}

// 16 int8 codes -> floats
__device__ __forceinline__ void unpack_i8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) f[4 * i + k] = code_at(w[i], k);
}

// 8 bf16 values -> floats
__device__ __forceinline__ void unpack_bf16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The thread's 16 values of row `row` (bytes), zeros where its channels
// lie past hd.  int8: channels 16 cg..; bf16: 8 cg.. and 64 + 8 cg..
template <int KIND>
__device__ __forceinline__ void row_values(const uint8_t* row, int cg, int hd,
                                           float* f) {
  if (KIND == 0) {
    if (CPR * cg < hd) {
      unpack_i8(*reinterpret_cast<const uint4*>(row + CPR * cg), f);
    } else {
#pragma unroll
      for (int i = 0; i < CPR; ++i) f[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int piece = 0; piece < 2; ++piece) {
      const int c = 64 * piece + 8 * cg;
      if (c < hd) {
        unpack_bf16(*reinterpret_cast<const uint4*>(row + 2 * c),
                    f + 8 * piece);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[8 * piece + i] = 0.f;
      }
    }
  }
}

// int8: the K and V scales of rows rs + RS (i0 + r), r < RB, of the chunk
// at cache row `crow` (0 past the chunk's jn valid rows)
__device__ __forceinline__ void row_scales(const float* __restrict__ ks,
                                           const float* __restrict__ vs,
                                           int crow, int KVH, int kv, int rs,
                                           int RS, int i0, int jn, float* kk,
                                           float* vv) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = rs + RS * (i0 + r);
    const size_t o = ((size_t)crow + j) * KVH + kv;
    kk[r] = j < jn ? __ldg(ks + o) : 0.f;
    vv[r] = j < jn ? __ldg(vs + o) : 0.f;
  }
}

// channel of the thread's i-th value
template <int KIND>
__device__ __forceinline__ int channel(int cg, int i) {
  return KIND == 0 ? CPR * cg + i : 64 * (i / 8) + 8 * cg + i % 8;
}

// Merge the online-softmax state (m, l, acc) of this lane with the lane
// `d` apart (the same channels of another row slice).
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

template <int KIND, int NG>
__global__ void __launch_bounds__(NTH, Ring<KIND>::RESIDENT)
    flash_decode_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ q,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ pos, float* __restrict__ out,
                        float* __restrict__ work, int* __restrict__ arrivals,
                        int B, int H, int KVH, int hd, int Smax, int layer,
                        int cps) {
  using R = Ring<KIND>;
  constexpr int ESZ = R::ESZ;
  constexpr int RS = SLICES / NG;           // row slices a head
  constexpr int WPH = RS >= 4 ? RS / 4 : 1;  // warps a head spans
  __shared__ int is_last;
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x, G = H / KVH;
  const int p = pos[b];
  const int last_chunk = p / C;  // the chunk that holds pos
  const int c0 = split * cps;
  if (c0 > last_chunk) return;  // the split lies wholly past pos
  const int nch = min(c0 + cps, last_chunk + 1) - c0;
  const int active = min(S, last_chunk / cps + 1);  // splits with a row
  const int ST = R::stages(cps);                    // the ring's chunks

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int rowb = hd * ESZ;   // bytes of one position of one kv head
  const int kvb = C * rowb;    // a chunk of K (or V)
  const int stage = R::stage_bytes(hd, G);
  const int qoff = 2 * kvb;  // the query rows in a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * stage);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  const int row0 = (layer * B + b) * Smax;  // (layer, b, 0) in the 2-D view

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      wg::mbar_init(&full[i], 1);  // the TMA thread's, with the bytes
      wg::mbar_init(&empty[i], NCW);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC) {
    // producer: one thread issues the two TMA boxes of a chunk (and, with
    // the first, the bulk copy of the G query rows)
    if (tid == NC)
      for (int i = 0; i < nch; ++i) {
        const int st = i % ST, j0 = (c0 + i) * C;
        wg::mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        uint8_t* buf = smem + st * stage;
        const int qbytes = i == 0 ? G * hd * 4 : 0;
        wg::mbar_expect_tx(&full[st], 2 * kvb + qbytes);
        wg::tma_load_2d(buf, &tk, &full[st], kv * rowb, row0 + j0);
        wg::tma_load_2d(buf + kvb, &tv, &full[st], kv * rowb, row0 + j0);
        if (qbytes)
          bulk_load(buf + qoff, q + ((size_t)b * H + (size_t)kv * G) * hd,
                    qbytes, &full[st]);
      }
    return;
  }

  // consumers: (head g, row slice rs, channel group cg)
  const int lane = tid & 31, cg = tid & 7, slice = tid >> 3;
  const int g = slice / RS, rs = slice % RS;
  const bool head = g < G;
  float qv[CPR], acc[CPR], m = -INFINITY, l = 0.f;
#pragma unroll
  for (int c = 0; c < CPR; ++c) acc[c] = 0.f;

  for (int i = 0; i < nch; ++i) {
    const int st = i % ST, j0 = (c0 + i) * C;
    const int jn = min(C, p - j0 + 1);  // valid rows of the chunk
    // int8: the scales of the thread's rows, a batch of rows ahead, the
    // first batch's before the chunk's data is waited on
    float kss[RB], vss[RB];
    if (KIND == 0)
      row_scales(ks, vs, row0 + j0, KVH, kv, rs, RS, 0, jn, kss, vss);
    wg::mbar_wait(&full[st], (i / ST) & 1);
    const uint8_t* kb = smem + st * stage;
    const uint8_t* vb = kb + kvb;
    if (i == 0) {
      // q times log2(e): the scores, m and the splits' maxima in base 2
      const float* qs = reinterpret_cast<const float*>(kb + qoff) + g * hd;
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        const int ch = channel<KIND>(cg, c);
        qv[c] = head && ch < hd ? qs[ch] * 1.4426950408889634f : 0.f;
      }
    }
    for (int i0 = 0; i0 < C / RS; i0 += RB) {
      // the warp's slices hold rows rs + RS i0 ..: stop where none is valid
      if (!__any_sync(0xffffffffu, rs + RS * i0 < jn)) break;
      float nks[RB], nvs[RB];
      if (KIND == 0)
        row_scales(ks, vs, row0 + j0, KVH, kv, rs, RS, i0 + RB, jn, nks,
                   nvs);
      float s[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int j = rs + RS * (i0 + r);
        float kf[CPR];
        row_values<KIND>(kb + j * rowb, cg, hd, kf);
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int c = 0; c < CPR; c += 2) {
          d0 = fmaf(qv[c], kf[c], d0);
          d1 = fmaf(qv[c + 1], kf[c + 1], d1);
        }
        float d = d0 + d1;
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        s[r] = j < jn ? (KIND == 0 ? d * kss[r] : d) : -INFINITY;
      }
      float mb = s[0];
#pragma unroll
      for (int r = 1; r < RB; ++r) mb = fmaxf(mb, s[r]);
      const float m_new = fmaxf(m, mb);
      if (m_new != -INFINITY) {  // else no valid row of this slice yet
        const float corr = exp2f(m - m_new);  // 0 while m is -inf
        l *= corr;
#pragma unroll
        for (int c = 0; c < CPR; ++c) acc[c] *= corr;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int j = rs + RS * (i0 + r);
          if (j < jn) {
            const float pe = exp2f(s[r] - m_new);
            l += pe;
            const float pv = KIND == 0 ? pe * vss[r] : pe;
            float vf[CPR];
            row_values<KIND>(vb + j * rowb, cg, hd, vf);
#pragma unroll
            for (int c = 0; c < CPR; ++c) acc[c] = fmaf(pv, vf[c], acc[c]);
          }
        }
        m = m_new;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        kss[r] = nks[r];
        vss[r] = nvs[r];
      }
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[st]);
  }

  // merge the row slices of each head: the warp's by shuffles (lane bit 3
  // and, for NG <= 4, bit 4 hold a slice's low bits), then the WPH warps of
  // a head through shared memory, in the ring (every chunk was waited on):
  // [NG * WPH][hd] acc, then m and l
  merge_lanes(m, l, acc, 8);
  if (NG <= 4) merge_lanes(m, l, acc, 16);
  float* red = reinterpret_cast<float*>(smem);
  float* red_m = red + NG * WPH * hd;
  float* red_l = red_m + NG * WPH;
  const int slot = g * WPH + (tid >> 5) % WPH;
  consumers_sync();
  if ((lane >> 3) % (NG <= 4 ? 4 : 2) == 0) {
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      const int ch = channel<KIND>(cg, c);
      if (ch < hd) red[slot * hd + ch] = acc[c];
    }
    if (cg == 0) {
      red_m[slot] = m;
      red_l[slot] = l;
    }
  }
  consumers_sync();
  const size_t pair = (size_t)b * KVH + kv;
  for (int idx = tid; idx < G * hd; idx += NC) {
    const int gg = idx / hd, c = idx % hd;
    float M = -INFINITY;
    for (int w = 0; w < WPH; ++w) M = fmaxf(M, red_m[gg * WPH + w]);
    float Lsum = 0.f, A = 0.f;
    for (int w = 0; w < WPH; ++w) {
      const float mw = red_m[gg * WPH + w];
      if (mw != -INFINITY) {
        const float e = exp2f(mw - M);
        Lsum = fmaf(red_l[gg * WPH + w], e, Lsum);
        A = fmaf(red[(gg * WPH + w) * hd + c], e, A);
      }
    }
    if (active == 1) {
      out[((size_t)b * H + (size_t)kv * G + gg) * hd + c] =
          A / fmaxf(Lsum, 1e-30f);
    } else {
      float* w = work + ((pair * S + split) * G + gg) * (hd + 2);
      w[c] = A;
      if (c == 0) {
        w[hd] = M;
        w[hd + 1] = Lsum;
      }
    }
  }
  if (active == 1) return;

  // the last split of the (slot, kv head) to arrive combines them all
  __threadfence();
  consumers_sync();
  if (tid == 0) is_last = atomicAdd(&arrivals[pair], 1) == active - 1;
  consumers_sync();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < G * hd; idx += NC) {
    const int gg = idx / hd, c = idx % hd;
    const float* w0 = work + (pair * S * G + gg) * (hd + 2);
    const size_t step = (size_t)G * (hd + 2);  // from one split to the next
    float M = -INFINITY;
    for (int s2 = 0; s2 < active; ++s2)
      M = fmaxf(M, __ldcg(w0 + s2 * step + hd));
    float Lsum = 0.f, A = 0.f;
    for (int s2 = 0; s2 < active; ++s2) {
      const float ms = __ldcg(w0 + s2 * step + hd);
      if (ms != -INFINITY) {
        const float e = exp2f(ms - M);
        Lsum = fmaf(__ldcg(w0 + s2 * step + hd + 1), e, Lsum);
        A = fmaf(__ldcg(w0 + s2 * step + c), e, A);
      }
    }
    out[((size_t)b * H + (size_t)kv * G + gg) * hd + c] =
        A / fmaxf(Lsum, 1e-30f);
  }
  if (tid == 0) arrivals[pair] = 0;  // ready for the next launch
}

// Tensor maps of a cache, kept by (address, rows, row bytes, box bytes):
// a serving run reads the same two buffers at every layer and step.
struct MapKey {
  const void* base;
  uint64_t rows, cols;
  uint32_t box_cols;
};

int cached_map(CUtensorMap* map, const void* base, uint64_t rows,
               uint64_t cols, uint32_t box_cols) {
  constexpr int N = 16;
  static std::mutex mu;
  static MapKey keys[N];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i].base == base && keys[i].rows == rows &&
        keys[i].cols == cols && keys[i].box_cols == box_cols) {
      *map = maps[i];
      return 0;
    }
  const int e = wg::encode_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              rows, cols, C, box_cols,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  keys[next] = MapKey{base, rows, cols, box_cols};
  maps[next] = *map;
  next = (next + 1) % N;
  used = used < N ? used + 1 : N;
  return 0;
}

template <int KIND, int NG>
int launch(const void* q, const void* kbuf, const void* vbuf, const void* ks,
           const void* vs, const void* pos, void* out, void* work,
           void* arrivals, int B, int H, int KVH, int hd, int Smax, int L,
           int layer, int splits, int cps, cudaStream_t st) {
  using R = Ring<KIND>;
  auto kern = flash_decode_kernel<KIND, NG>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         R::smem_bytes(HDMAX, 8, R::STAGES));
    attr = true;
  }
  const uint64_t rows = (uint64_t)L * B * Smax;
  const uint64_t cols = (uint64_t)KVH * hd * R::ESZ;
  CUtensorMap tk, tv;
  int e = cached_map(&tk, kbuf, rows, cols, hd * R::ESZ);
  if (e == 0) e = cached_map(&tv, vbuf, rows, cols, hd * R::ESZ);
  if (e != 0) return e;
  kern<<<dim3(splits, KVH, B), NTH,
         R::smem_bytes(hd, H / KVH, R::stages(cps)), st>>>(
      tk, tv, static_cast<const float*>(q), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<float*>(out), static_cast<float*>(work),
      static_cast<int*>(arrivals), B, H, KVH, hd, Smax, layer, cps);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int dispatch_g(int G, const void* q, const void* kbuf, const void* vbuf,
               const void* ks, const void* vs, const void* pos, void* out,
               void* work, void* arrivals, int B, int H, int KVH, int hd,
               int Smax, int L, int layer, int splits, int cps,
               cudaStream_t st) {
#define LLMC_FD_LAUNCH(NG)                                                  \
  launch<KIND, NG>(q, kbuf, vbuf, ks, vs, pos, out, work, arrivals, B, H, \
                   KVH, hd, Smax, L, layer, splits, cps, st)
  return G <= 1   ? LLMC_FD_LAUNCH(1)
         : G <= 2 ? LLMC_FD_LAUNCH(2)
         : G <= 4 ? LLMC_FD_LAUNCH(4)
                  : LLMC_FD_LAUNCH(8);
#undef LLMC_FD_LAUNCH
}

}  // namespace fd
}  // namespace

// kv_kind: 0 = int8 codes with f32 scales, 1 = bf16 values.  hd <= 128 a
// multiple of 16, G = H / KVH <= 8; splits x cps chunks of 64 positions
// cover Smax.  With splits > 1, work is [B, KVH, splits, G, hd + 2] f32
// scratch and arrivals [B * KVH] int32 zeros, left zero by the launch.
extern "C" int llmc_flash_decode(const void* q, const void* kbuf,
                                 const void* vbuf, const void* ks,
                                 const void* vs, const void* pos, void* out,
                                 void* work, void* arrivals, int B, int H,
                                 int KVH, int hd, int Smax, int L, int layer,
                                 int kv_kind, int splits, int cps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd > fd::HDMAX || hd % 16 || H % KVH || H / KVH > 8 || splits < 1 ||
      splits * cps * fd::C < Smax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_kind == 0)
    return fd::dispatch_g<0>(H / KVH, q, kbuf, vbuf, ks, vs, pos, out, work,
                             arrivals, B, H, KVH, hd, Smax, L, layer, splits,
                             cps, st);
  return fd::dispatch_g<1>(H / KVH, q, kbuf, vbuf, ks, vs, pos, out, work,
                           arrivals, B, H, KVH, hd, Smax, L, layer, splits,
                           cps, st);
}
