// flash_decode: one-token decode attention over the KV cache, read in
// place, on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/flash_decode.py::_kernel (the Pallas TPU kernel,
// pallas_call at :171).  Same function: for slot b and query head h,
//   ctx[b,h] = sum_{j <= pos[b]} softmax_j(q[b,h] . k[j]) v[j]
// over the [L, B, Smax, KVH, hd] cache at `layer`, with GQA (G = H/KVH
// query heads per kv head; head h reads kv head h / G).  The cache holds
// int8 codes with per-(token, head) f32 scales [L, B, Smax, KVH], or bf16
// or f32 values (the reference's kernel casts any float cache to f32 in
// its body).  q arrives f32 and pre-scaled.  The K scale multiplies the
// scores after the dot and the V scale folds into the probabilities —
// nothing is dequantized element-wise.  Online softmax (m, l, acc) in f32.
//
// What bounds it on an H100: the valid cache prefix, (pos[b] + 1) rows of
// K and V per (slot, kv head) — the card's memory rate; the arithmetic is
// about 2 G flops per byte read.  The TPU walked a slot's cache in one
// sequential grid row; here that walk is cut three ways:
//
// - Split-K over the cache (flash-decoding).  The grid is (split x head
//   group, kv head, slot): a (slot, kv head) is cut into S splits of `cps`
//   whole 64-row chunks, S chosen on the host from B, KVH, the head groups,
//   Smax and the SM count so the grid fills the card about twice over
//   (ops/flash_decode.py::split_plan).  A split wholly past pos[b] exits at
//   once; the host never reads pos.  With one active split the CTA writes
//   ctx itself; else each split writes its (m, l, acc[G, hd]) to an f32
//   workspace and the last CTA of the (slot, kv head, head group) to
//   arrive combines them in split order (decode_common.cuh), so the result
//   is the same from run to run.  One launch either way.
// - An asynchronous ring.  A producer warp keeps up to STAGES chunks of K
//   and V in flight by TMA (cp.async.bulk.tensor over a 2-D view of the
//   cache: a row is one position of one kv head, hd elements; a box is 64
//   positions of one kv head), each landing on its stage's mbarrier, the
//   CTA's query rows riding with its first chunk by the bulk copy engine.
//   The four consumer warps score one chunk while the next ones arrive and
//   release it by an `empty` mbarrier.  The int8 scales, 4 bytes a
//   position 4 KVH bytes apart, are no TMA box: each consumer thread loads
//   those of its own rows a batch of rows ahead (the chunk's first batch
//   before it waits on the chunk).  Shared memory is dynamic and sized by
//   the cache's element size, hd, the CTA's heads and the split's chunks (a
//   ring of at most three; an f32 ring of three chunks takes 204 KB, so
//   one such CTA an SM).
// - All warps on the arithmetic.  Consumer thread t owns (query head g,
//   row slice rs, channel group cg): 16 channels of one head (int8: one
//   16-byte shared read a row; bf16 two and f32 four, each 8 lanes over 128
//   contiguous bytes), the rows j = rs (mod RS) of every chunk, RS = 16 /
//   NG row slices a head, NG the query heads a CTA serves (G rounded up to
//   1, 2, 4 or 8; above 8 the heads go in groups of 8, one CTA a group, a
//   grid dimension: each group reads its K and V again, from L2).  A score
//   is the 8 channel groups' partial dots summed by three shuffles; every
//   (g, rs) keeps its own online softmax over its rows, four rows at a
//   time, and P.V accumulates in the thread's 16 channels.  The row slices
//   merge once, at the end: a warp's by shuffles, then the warps of a head
//   through shared memory.  No barrier across warps inside the loop.  int8
//   codes become f32 by a byte permute and one add (2^23 + 128 + code,
//   exactly).  q is scaled by log2(e) as it is read, so the softmax runs on
//   exp2.
//
// `layer` is a kernel argument and `pos` a device array, so no per-layer
// copy and no host sync.  The two tensor maps are encoded on the host and
// kept in a small cache keyed by the cache's address and shape.

#include "decode_common.cuh"

namespace {
namespace fd {

using namespace dc;

constexpr int RB = 4;              // rows a thread takes per softmax update
constexpr int SLICES = NC / LPR;   // (head, row slice) pairs: 16
constexpr int NGMAX = 8;           // query heads a CTA

// KIND 0: int8 codes + f32 scales; KIND 1: bf16 values; KIND 2: f32 values
template <int KIND>
struct Ring {
  static constexpr int ESZ = Elem<KIND>::ESZ;
  // at most STAGES chunks in the ring: two in flight while one is scored
  static constexpr int STAGES = 3;
  // CTAs an SM holds with a full ring at hd = 128 (shared memory;
  // registers capped to match)
  static constexpr int RESIDENT = KIND == 0 ? 4 : KIND == 1 ? 2 : 1;
  // K, V and, with a split's first chunk, its query rows (at most NGMAX);
  // a multiple of 128 bytes (TMA's alignment)
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
  using RowT = Row<KIND>;
  constexpr int ESZ = R::ESZ;
  constexpr int RS = SLICES / NG;           // row slices a head
  constexpr int WPH = RS >= 4 ? RS / 4 : 1;  // warps a head spans
  __shared__ int is_last;
  const int G = H / KVH, ngrp = (G + NGMAX - 1) / NGMAX;
  const int grp = blockIdx.x % ngrp, split = blockIdx.x / ngrp;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x / ngrp;
  const int hb = grp * NGMAX;                  // the group's first head
  const int GC = min(G - hb, NGMAX);           // and its heads
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
  const int stage = R::stage_bytes(hd, GC);
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
    // the first, the bulk copy of the group's query rows)
    if (tid == NC)
      for (int i = 0; i < nch; ++i) {
        const int st = i % ST, j0 = (c0 + i) * C;
        wg::mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        uint8_t* buf = smem + st * stage;
        const int qbytes = i == 0 ? GC * hd * 4 : 0;
        wg::mbar_expect_tx(&full[st], 2 * kvb + qbytes);
        wg::tma_load_2d(buf, &tk, &full[st], kv * hd, row0 + j0);
        wg::tma_load_2d(buf + kvb, &tv, &full[st], kv * hd, row0 + j0);
        if (qbytes)
          bulk_load(buf + qoff,
                    q + ((size_t)b * H + (size_t)kv * G + hb) * hd, qbytes,
                    &full[st]);
      }
    return;
  }

  // consumers: (head g, row slice rs, channel group cg)
  const int lane = tid & 31, cg = tid & 7, slice = tid >> 3;
  const int g = slice / RS, rs = slice % RS;
  const bool head = g < GC;
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
        const int ch = RowT::channel(cg, c);
        qv[c] = head && ch < hd ? qs[ch] * LOG2E : 0.f;
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
        RowT::values(kb + j * rowb, cg, hd, kf);
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
            RowT::values(vb + j * rowb, cg, hd, vf);
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
      const int ch = RowT::channel(cg, c);
      if (ch < hd) red[slot * hd + ch] = acc[c];
    }
    if (cg == 0) {
      red_m[slot] = m;
      red_l[slot] = l;
    }
  }
  consumers_sync();
  const size_t pair = (size_t)b * KVH + kv;
  float* ctx = out + ((size_t)b * H + (size_t)kv * G + hb) * hd;
  for (int idx = tid; idx < GC * hd; idx += NC) {
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
      ctx[(size_t)gg * hd + c] = A / fmaxf(Lsum, 1e-30f);
    } else {
      float* w = work + ((pair * S + split) * G + hb + gg) * (hd + 2);
      w[c] = A;
      if (c == 0) {
        w[hd] = M;
        w[hd + 1] = Lsum;
      }
    }
  }
  if (active == 1) return;

  // the last split of the (slot, kv head, head group) to arrive combines
  int* counter = arrivals + pair * ngrp + grp;
  if (!last_to_arrive(counter, active, &is_last)) return;
  combine_splits(work + (pair * S * G + hb) * (hd + 2),
                 (size_t)G * (hd + 2), active, GC, hd, ctx, counter);
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
                         R::smem_bytes(HDMAX, NGMAX, R::STAGES));
    attr = true;
  }
  const uint64_t rows = (uint64_t)L * B * Smax;
  const uint64_t cols = (uint64_t)KVH * hd;
  CUtensorMap tk, tv;
  int e = cached_map<KIND>(&tk, kbuf, rows, cols, hd);
  if (e == 0) e = cached_map<KIND>(&tv, vbuf, rows, cols, hd);
  if (e != 0) return e;
  const int G = H / KVH, ngrp = (G + NGMAX - 1) / NGMAX;
  kern<<<dim3(splits * ngrp, KVH, B), NTH,
         R::smem_bytes(hd, G < NGMAX ? G : NGMAX, R::stages(cps)), st>>>(
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

// kv_kind: 0 = int8 codes with f32 scales, 1 = bf16 values, 2 = f32
// values.  hd <= 128 a multiple of 16, any G = H / KVH (in groups of 8);
// splits x cps chunks of 64 positions cover Smax.  With splits > 1, work
// is [B, KVH, splits, G, hd + 2] f32 scratch and arrivals [B * KVH *
// ceil(G / 8)] int32 zeros, left zero by the launch.
extern "C" int llmc_flash_decode(const void* q, const void* kbuf,
                                 const void* vbuf, const void* ks,
                                 const void* vs, const void* pos, void* out,
                                 void* work, void* arrivals, int B, int H,
                                 int KVH, int hd, int Smax, int L, int layer,
                                 int kv_kind, int splits, int cps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd > dc::HDMAX || hd % 16 || H % KVH || splits < 1 ||
      splits * cps * dc::C < Smax || kv_kind < 0 || kv_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define LLMC_FD_KIND(K)                                                    \
  fd::dispatch_g<K>(H / KVH, q, kbuf, vbuf, ks, vs, pos, out, work,        \
                    arrivals, B, H, KVH, hd, Smax, L, layer, splits, cps, st)
  return kv_kind == 0 ? LLMC_FD_KIND(0)
         : kv_kind == 1 ? LLMC_FD_KIND(1)
                        : LLMC_FD_KIND(2);
#undef LLMC_FD_KIND
}
