// batch_decode: one-token decode attention for the serving batch — many
// slots, one new token each — on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/batch_decode.py::_kernel (the Pallas TPU kernel,
// pallas_call at :248).  Same function as flash_decode.cu: for slot b and
// query head h,
//   ctx[b,h] = sum_{j <= pos[b]} softmax_j(q[b,h] . k[j]) v[j]
// over the [L, B, Smax, KVH, hd] cache at `layer`, GQA by h / G, int8
// codes with per-(token, head) f32 scales [L, B, Smax, KVH], or bf16 or
// f32 values, q f32 and pre-scaled.  The K scale multiplies the score
// after the dot and the V scale folds into the probability; nothing is
// dequantized element-wise.  As on the TPU, the slots are taken in blocks
// of b_blk, one block a CTA, and a block reads no chunk past its last
// valid one; here each slot stops at its own last chunk.
//
// What bounds it on an H100: the valid cache prefix, (pos[b] + 1) rows of
// K and V per (slot, kv head) — the card's memory rate — and, at a
// serving batch, the fixed cost of each of thousands of (slot, kv head)
// pairs of a few dozen rows.  The design:
//
// - A warp per (slot, kv head, head group, split), nothing shared across
//   warps.  A CTA holds the b_blk warps of a block of slots (grid: split x
//   head group, kv head, block), each with its own ring in shared memory
//   and no barrier across warps: a slot's merge never waits on another,
//   and the card keeps as many warps in flight as registers and shared
//   memory allow.
// - An asynchronous ring a warp.  Lane 0 keeps the next chunk of 16
//   positions of K and V in flight by TMA (the 2-D view of
//   decode_common.cuh, a box of 16 rows) while the warp scores the current
//   one; each stage lands on its own mbarrier.  For int8, the chunk's 16 K
//   and 16 V scales (4 bytes a position, 4 KVH bytes apart: no TMA box)
//   are one load a lane, issued a chunk ahead, and reach the lanes that
//   need them by shuffles (copying them into the ring by cp.async instead
//   measured slower: tools/attention_variants.py).
// - Split-K at small batch, interleaved.  Where the slots, kv heads and
//   head groups alone would leave the card short of warps, split s of a
//   slot takes its chunks s, s + S, s + 2S, ... (ops/batch_decode.py::
//   batch_plan, up to one wave of the warps this kernel keeps resident,
//   from shapes and its occupancy alone; the host never reads pos), so
//   that a short prefix still spreads over the splits
//   (tools/attention_variants.py times runs of whole chunks instead); the
//   last warp of a (slot, kv head, head group) to arrive merges its splits
//   in split order (decode_common.cuh), inside the one launch.
// - One read of K and V for all the query heads of a kv head, two ways:
//   * one query head (G = 1: Llama-2-7B): the CUDA cores.  A lane owns 16
//     channels of every 4th row of a chunk, q's channels in registers and
//     an online softmax (m, l, acc[16]); a score is a sum over the row's 8
//     lanes by shuffles, and the warp's row groups merge at the end.
//   * several (GQA): the tensor cores, mma.sync m16n8k16 with f32 sums, up
//     to 8 heads a warp (more go to a grid dimension).  S = Q K^T takes
//     the heads as M (rows 8..15 zero), a chunk's 16 keys as N (two tiles)
//     and hd as K; the online softmax runs on S's accumulators, which are
//     then the B operand of O^T += V^T P^T (hd as M in tiles of 16, the 16
//     keys as K, the heads as N).  The int8 codes are exact in f16 and
//     bf16 values are bf16, so those go in as they are (codes converted in
//     registers by a byte permute and one subtraction); q and p are split
//     into a high and a low half (q = q_hi + q_lo, about 22 bits in f16,
//     16 in bf16) and each product taken twice; an f32 cache is split the
//     same way (three products).  f16's normal range ends at 2^-14, where
//     a low half loses its bits, and p times the V scale is often far
//     below it (a V scale of 1e-3, p of 1e-4): on an int8 cache head g's
//     q and p go in times powers of two that put the largest of each in
//     [2^13, 2^14), and come out divided by them, exactly.  The channels
//     are permuted inside each k step and m tile (a sum does not care) so
//     that a lane reads contiguous pieces of a key row.
//
// q is scaled by log2(e) as it is read, so the softmax runs on exp2.  The
// workspace and the arrival counters are the caller's, kept at stable
// addresses (ops/flash_decode.py::decode_scratch).

#include <cuda_fp16.h>

#include "decode_common.cuh"

namespace {
namespace bd {

using namespace dc;

constexpr int CH = 16;     // positions a warp's chunk (a TMA box's rows)
constexpr int ST = 2;      // stages of a warp's ring
constexpr int MAXW = 8;    // warps a CTA: the largest b_blk
constexpr int NGT = 8;     // query heads a tensor-core warp
constexpr int KS = HDMAX / 16;  // k steps of S, m tiles of O^T at hd = 128

// a warp's ring: ST stages of K and V, CH rows each
template <int KIND>
__host__ __device__ constexpr int warp_bytes(int hd) {
  return ST * 2 * CH * hd * Elem<KIND>::ESZ;
}

__device__ __forceinline__ uint32_t u32_of(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A warp's work: its slot, kv head, head group and split, the split's
// chunks of the slot's prefix, and its ring.
template <int KIND>
struct Warp {
  int b, kv, G, ngrp, grp, hb, GC, S, split, p, nch, active, row0, hd, lane;
  uint8_t* ring;
  uint64_t* full;
  const CUtensorMap *tk, *tv;

  // false where the split lies wholly past pos
  __device__ bool init(const CUtensorMap* k_map, const CUtensorMap* v_map,
                       const int* pos, int B, int H, int KVH, int hd_,
                       int Smax, int layer, int heads) {
    tk = k_map, tv = v_map, hd = hd_;
    G = H / KVH, ngrp = (G + heads - 1) / heads;
    grp = blockIdx.x % ngrp, split = blockIdx.x / ngrp;
    S = gridDim.x / ngrp;
    kv = blockIdx.y;
    const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    b = blockIdx.z * nw + warp;
    hb = grp * heads;
    GC = min(G - hb, heads);
    p = min(pos[b], Smax - 1);
    const int last = p / CH;  // the chunk that holds pos
    if (split > last) return false;
    nch = (last - split) / S + 1;  // chunks split, split + S, ...
    active = min(S, last + 1);     // splits with a row
    row0 = (layer * B + b) * Smax;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
    ring = smem + warp * warp_bytes<KIND>(hd);
    full = reinterpret_cast<uint64_t*>(smem + nw * warp_bytes<KIND>(hd)) +
           warp * ST;
    if (lane == 0) {
      for (int i = 0; i < ST; ++i) wg::mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < ST && k < nch; ++k) issue(k);
    }
    return true;
  }
  // the first position of the split's chunk k, and its valid rows
  __device__ int first(int k) const { return (split + k * S) * CH; }
  __device__ int valid(int k) const { return min(CH, p + 1 - first(k)); }
  __device__ int half() const { return CH * hd * Elem<KIND>::ESZ; }
  // lane 0: chunk k into stage k % ST
  __device__ void issue(int k) {
    const int st = k % ST;
    uint8_t* buf = ring + st * 2 * half();
    wg::mbar_expect_tx(&full[st], 2 * half());
    wg::tma_load_2d(buf, tk, &full[st], kv * hd, row0 + first(k));
    wg::tma_load_2d(buf + half(), tv, &full[st], kv * hd, row0 + first(k));
  }
  // wait for chunk k; its K rows (V rows follow at + half())
  __device__ const uint8_t* wait(int k) {
    wg::mbar_wait(&full[k % ST], (k / ST) & 1);
    return ring + (k % ST) * 2 * half();
  }
  // the warp is done with chunk k: refill its stage with chunk k + ST
  __device__ void release(int k) {
    __syncwarp();
    if (lane == 0 && k + ST < nch) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(k + ST);
    }
  }
  // int8: lane l < 16 holds the K scale of row l of chunk k, lane 16 + l
  // its V scale
  __device__ float scale(const float* ks, const float* vs, int KVH,
                         int k) const {
    const int j = first(k) + (lane & 15);
    return KIND == 0 && k < nch && j <= p
               ? __ldg((lane < 16 ? ks : vs) + ((size_t)row0 + j) * KVH + kv)
               : 0.f;
  }
  // the split's state (acc of gn heads, m, l) is written; the last split
  // of the (slot, kv head, head group) to arrive merges them into ctx
  __device__ void finish(float* work, int* arrivals, float* ctx) const {
    const size_t pair = (size_t)b * (gridDim.y) + kv;
    int* counter = arrivals + pair * ngrp + grp;
    if (warp_last_to_arrive(counter, active))
      warp_combine_splits(work + (pair * S * G + hb) * (hd + 2),
                          (size_t)G * (hd + 2), active, GC, hd, ctx, counter);
  }
  __device__ float* work_row(float* work, int gh) const {
    const size_t pair = (size_t)b * (gridDim.y) + kv;
    return work + ((pair * S + split) * G + hb + gh) * (hd + 2);
  }
};

// ---- one query head a kv head: the CUDA cores ----------------------------

constexpr int RG = 32 / LPR;   // rows a warp reads at once: 4
constexpr int RPL = CH / RG;   // rows a lane in a chunk: 4

template <int KIND>
__global__ void __launch_bounds__(MAXW * 32, 2)
    batch_decode_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ q,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ pos, float* __restrict__ out,
                        float* __restrict__ work, int* __restrict__ arrivals,
                        int B, int H, int KVH, int hd, int Smax, int layer) {
  using RowT = Row<KIND>;
  Warp<KIND> w;
  if (!w.init(&tk, &tv, pos, B, H, KVH, hd, Smax, layer, 1)) return;
  const int lane = w.lane, cg = lane % LPR, rg = lane / LPR;
  const int rowb = hd * Elem<KIND>::ESZ;
  float scur = w.scale(ks, vs, KVH, 0);

  // the lane's channels of q, times log2(e)
  float qv[CPR], acc[CPR], m = -INFINITY, l = 0.f;
  const float* qr = q + ((size_t)w.b * H + w.hb + (size_t)w.kv * w.G) * hd;
#pragma unroll
  for (int c = 0; c < CPR; c += 4) {
    const int ch = RowT::channel(cg, c);  // 4 contiguous channels
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < hd) v = *reinterpret_cast<const float4*>(qr + ch);
    qv[c] = v.x * LOG2E;
    qv[c + 1] = v.y * LOG2E;
    qv[c + 2] = v.z * LOG2E;
    qv[c + 3] = v.w * LOG2E;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c + e] = 0.f;
  }
  __syncwarp();

  for (int i = 0; i < w.nch; ++i) {
    const int jn = w.valid(i);
    const float snext = w.scale(ks, vs, KVH, i + 1);
    const uint8_t* kb = w.wait(i);
    const uint8_t* vb = kb + w.half();
    {
      float sc[RPL], vsc[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int j = rg + RG * r;
        float kf[CPR];
        RowT::values(kb + j * rowb, cg, hd, kf);
        const float ksc =
            KIND == 0 ? __shfl_sync(0xffffffffu, scur, j) : 1.f;
        vsc[r] = KIND == 0 ? __shfl_sync(0xffffffffu, scur, 16 + j) : 1.f;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int c = 0; c < CPR; c += 2) {
          d0 = fmaf(qv[c], kf[c], d0);
          d1 = fmaf(qv[c + 1], kf[c + 1], d1);
        }
        float d = d0 + d1;
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[r] = j < jn ? d * ksc : -INFINITY;
      }
      // the online softmax over the lane's rows of the chunk
      float mb = sc[0];
#pragma unroll
      for (int r = 1; r < RPL; ++r) mb = fmaxf(mb, sc[r]);
      const float m_new = fmaxf(m, mb);
      if (m_new != -INFINITY) {  // else no valid row of this lane yet
        const float corr = exp2f(m - m_new);  // 0 while m is -inf
        l *= corr;
#pragma unroll
        for (int c = 0; c < CPR; ++c) acc[c] *= corr;
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          const int j = rg + RG * r;
          if (j < jn) {
            const float pe = exp2f(sc[r] - m_new);
            l += pe;
            const float pv = pe * vsc[r];
            float vf[CPR];
            RowT::values(vb + j * rowb, cg, hd, vf);
#pragma unroll
            for (int c = 0; c < CPR; ++c) acc[c] = fmaf(pv, vf[c], acc[c]);
          }
        }
        m = m_new;
      }
    }
    w.release(i);
    scur = snext;
  }

  // merge the warp's row groups (lanes LPR apart hold the same channels)
#pragma unroll
  for (int d = LPR; d < 32; d <<= 1) merge_lanes(m, l, acc, d);
  float* ctx = out + ((size_t)w.b * H + (size_t)w.kv * w.G + w.hb) * hd;
  if (lane < LPR) {
    if (w.active == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int c = 0; c < CPR; c += 4) {
        const int ch = RowT::channel(cg, c);
        if (ch < hd)
          *reinterpret_cast<float4*>(ctx + ch) =
              make_float4(acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv,
                          acc[c + 3] * inv);
      }
    } else {
      float* wr = w.work_row(work, 0);
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        const int ch = RowT::channel(cg, c);
        if (ch < hd) wr[ch] = acc[c];
      }
      if (cg == 0) {
        wr[hd] = m;
        wr[hd + 1] = l;
      }
    }
  }
  if (w.active > 1) w.finish(work, arrivals, ctx);
}

// ---- several query heads a kv head: the tensor cores ---------------------

// d += a b, m16n8k16, f32 accumulators: f16 operands for KIND 0 (int8
// codes), bf16 for KIND 1 and 2
template <int KIND>
__device__ __forceinline__ void mma(float* d, uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  if constexpr (KIND == 0)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (x, y) as a pair of the mma's type: the high half, and the low half of
// what is left
template <int KIND>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  if constexpr (KIND == 0) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 f = __half22float2(h);
    const __half2 r = __floats2half2_rn(x - f.x, y - f.y);
    hi = u32_of(&h);
    lo = u32_of(&r);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 r = __floats2bfloat162_rn(x - f.x, y - f.y);
    hi = u32_of(&h);
    lo = u32_of(&r);
  }
}

// 2^k as a float, k <= 127; 0 below 2^-126
__device__ __forceinline__ float pow2(int k) {
  return k < -126 ? 0.f : __int_as_float((min(k, 127) + 127) << 23);
}

// the exponent k, within [-126, 126], that puts x * 2^k in [2^13, 2^14)
// (x > 0 and finite; k = 126 where x is below 2^-113)
__device__ __forceinline__ int f16_range(float x) {
  return max(-126, min(126, 140 - (__float_as_int(x) >> 23)));
}

// two int8 codes picked from the biased words a and b (code + 128 in each
// byte) by `sel` into bytes 0 and 2, as f16x2: 1024 + code + 128 exactly,
// minus 1152
__device__ __forceinline__ uint32_t codes_f16x2(uint32_t a, uint32_t b,
                                                uint32_t sel) {
  uint32_t r = (__byte_perm(a, b, sel) & 0x00FF00FFu) | 0x64006400u;
  const uint32_t k = 0x64806480u;
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&r),
                            *reinterpret_cast<const __half2*>(&k));
  return u32_of(&h);
}

// `bytes` (16, 8, 4, 2 or 1) bytes of shared memory at p, aligned to
// their count, into w[0..3]
__device__ __forceinline__ void load16(const uint8_t* p, int bytes,
                                       uint32_t* w) {
  if (bytes >= 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if (bytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = w[3] = 0u;
  } else if (bytes == 4) {
    w[0] = u32_of(p), w[1] = w[2] = w[3] = 0u;
  } else if (bytes == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p), w[1] = w[2] = w[3] = 0u;
  } else {
    w[0] = *p, w[1] = w[2] = w[3] = 0u;
  }
}

template <int KIND>
__global__ void __launch_bounds__(MAXW * 32, 1)
    batch_decode_mma_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float* __restrict__ q,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int* __restrict__ pos,
                            float* __restrict__ out, float* __restrict__ work,
                            int* __restrict__ arrivals, int B, int H, int KVH,
                            int hd, int Smax, int layer) {
  constexpr int ESZ = Elem<KIND>::ESZ;
  constexpr int KPG = 16 / (4 * ESZ);  // k steps in 16 bytes of a K span
  Warp<KIND> w;
  if (!w.init(&tk, &tv, pos, B, H, KVH, hd, Smax, layer, NGT)) return;
  const int lane = w.lane, g = lane >> 2, t = lane & 3;
  const int rowb = hd * ESZ, nks = hd / 16;  // k steps, and m tiles
  float scur = w.scale(ks, vs, KVH, 0);

  // S's A operand: row g is head hb + g (rows g + 8 are zero); k step k
  // takes channels t hd/4 + 4k + {0, 1 | 2, 3} as k = 2t, 2t + 1 | 2t + 8,
  // 2t + 9
  uint32_t qa[KS][2][2];  // [k step][high, low][k 2t.., k 2t + 8..]
  const float* qr =
      q + ((size_t)w.b * H + (size_t)w.kv * w.G + w.hb + g) * hd + t * (hd / 4);
  float4 qx[KS];
  float qm = 0.f;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    qx[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < nks && g < w.GC)
      qx[k] = *reinterpret_cast<const float4*>(qr + 4 * k);
    qm = fmaxf(fmaxf(qm, fmaxf(fabsf(qx[k].x), fabsf(qx[k].y))),
               fmaxf(fabsf(qx[k].z), fabsf(qx[k].w)));
  }
  // int8: head g's q times 2^qe in f16 (its largest in [2^13, 2^14)), its
  // scores times sdiv = 2^-qe
  float qup = LOG2E, sdiv = 1.f;
  if constexpr (KIND == 0) {
    qm = fmaxf(qm, __shfl_xor_sync(0xffffffffu, qm, 1));
    qm = fmaxf(qm, __shfl_xor_sync(0xffffffffu, qm, 2));
    const int qe = qm > 0.f ? f16_range(qm * LOG2E) : 0;
    qup = LOG2E * pow2(qe);
    sdiv = pow2(-qe);
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    split2<KIND>(qx[k].x * qup, qx[k].y * qup, qa[k][0][0], qa[k][1][0]);
    split2<KIND>(qx[k].z * qup, qx[k].w * qup, qa[k][0][1], qa[k][1][1]);
  }
  // O^T: m tile u, rows g and g + 8 are channels g hd/16 + u and
  // (g + 8) hd/16 + u; columns 2t, 2t + 1 are heads 2t, 2t + 1
  float o[KS][4];
#pragma unroll
  for (int u = 0; u < KS; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
  float m = -INFINITY, l = 0.f;  // head g's
  // O^T's columns of head g hold O times 2^pe: on an int8 cache pe is
  // lowered (never raised) so that the largest p v_scale yet times 2^pe
  // lies in [2^13, 2^14); else it stays 0
  int pe = KIND == 0 ? 126 : 0;
  __syncwarp();

  for (int i = 0; i < w.nch; ++i) {
    const int jn = w.valid(i);
    const float snext = w.scale(ks, vs, KVH, i + 1);
    const uint8_t* kb = w.wait(i);
    const uint8_t* vb = kb + w.half();

    // S = Q K^T: tile n2 is keys 8 n2 + g of this lane (B's column g); the
    // products with q's high and low halves sum apart, the four chains
    // side by side
    float sh[2][4], sl[2][4];
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[n2][e] = sl[n2][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += KPG) {
      if (k0 >= nks) break;
      uint32_t wd[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
        load16(kb + (8 * n2 + g) * rowb + (t * (hd / 4) + k0 * 4) * ESZ,
               min(16, (nks - k0) * 4 * ESZ), wd[n2]);
#pragma unroll
      for (int e = 0; e < KPG; ++e) {
        const int k = k0 + e;
        if (k >= nks) break;
        uint32_t b0[2], b1[2], l0[2] = {0u, 0u}, l1[2] = {0u, 0u};
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          if constexpr (KIND == 0) {
            const uint32_t x = wd[n2][e] ^ 0x80808080u;
            b0[n2] = codes_f16x2(x, x, 0x0100);
            b1[n2] = codes_f16x2(x, x, 0x0302);
          } else if constexpr (KIND == 1) {
            b0[n2] = wd[n2][2 * e];
            b1[n2] = wd[n2][2 * e + 1];
          } else {
            split2<KIND>(__uint_as_float(wd[n2][0]),
                         __uint_as_float(wd[n2][1]), b0[n2], l0[n2]);
            split2<KIND>(__uint_as_float(wd[n2][2]),
                         __uint_as_float(wd[n2][3]), b1[n2], l1[n2]);
          }
        }
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          mma<KIND>(sh[n2], qa[k][0][0], 0u, qa[k][0][1], 0u, b0[n2],
                    b1[n2]);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          mma<KIND>(sl[n2], qa[k][1][0], 0u, qa[k][1][1], 0u, b0[n2],
                    b1[n2]);
        if constexpr (KIND == 2)
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2)
            mma<KIND>(sl[n2], qa[k][0][0], 0u, qa[k][0][1], 0u, l0[n2],
                      l1[n2]);
      }
    }

    // head g's scores of keys 8 n2 + 2t + e, its online softmax over the
    // chunk (the keys lie in the row's four lanes t), and P^T: B operand
    // of O^T += V^T P^T (k = keys 2t, 2t + 1 | 2t + 8, 2t + 9, n = head g)
    float sc[2][2], vsc[2][2];
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * n2 + 2 * t + e;
        const float ksc =
            KIND == 0 ? __shfl_sync(0xffffffffu, scur, key) * sdiv : 1.f;
        vsc[n2][e] =
            KIND == 0 ? __shfl_sync(0xffffffffu, scur, 16 + key) : 1.f;
        sc[n2][e] = key < jn ? (sh[n2][e] + sl[n2][e]) * ksc : -INFINITY;
      }
    float cm = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
    const float m_new = fmaxf(m, cm);
    // 1 while m_new is -inf (no valid key yet: O and l are 0), else 0
    // while m is -inf
    const float corr = m_new == -INFINITY ? 1.f : exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            m_new == -INFINITY ? 0.f : exp2f(sc[n2][e] - m_new);
        l += p;
        sc[n2][e] = p * vsc[n2][e];
      }
    m = m_new;
    float fo = corr;  // head g's factor on O^T
    if constexpr (KIND == 0) {
      float pm = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
      pm = fmaxf(pm, __shfl_xor_sync(0xffffffffu, pm, 1));
      pm = fmaxf(pm, __shfl_xor_sync(0xffffffffu, pm, 2));
      const int pe_new = pm > 0.f ? min(pe, f16_range(pm)) : pe;
      fo = corr * pow2(pe_new - pe);
      pe = pe_new;
      const float up = pow2(pe);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
        sc[n2][0] *= up, sc[n2][1] *= up;
    }
    uint32_t pb[2][2];  // [high, low][k 2t.., k 2t + 8..]
    split2<KIND>(sc[0][0], sc[0][1], pb[0][0], pb[1][0]);
    split2<KIND>(sc[1][0], sc[1][1], pb[0][1], pb[1][1]);
    // O^T's columns are heads 2t, 2t + 1: their factors from row 2t
    const float c0 = __shfl_sync(0xffffffffu, fo, (2 * t) << 2);
    const float c1 = __shfl_sync(0xffffffffu, fo, (2 * t + 1) << 2);
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      o[u][0] *= c0;
      o[u][1] *= c1;
      o[u][2] *= c0;
      o[u][3] *= c1;
    }

    // O^T += V^T P^T: lane (g, t) reads keys 2t, 2t + 1, 2t + 8, 2t + 9 at
    // channels g hd/16 .. and (g + 8) hd/16 .. (a key past the valid ones
    // reads 0 for a float cache: its p is 0, and 0 times a stale value
    // must stay 0)
    // a run: hd/16 channels, at hd = 128 8, 16 or 32 bytes (VWN words)
    constexpr int VWN = 2 * ESZ < 4 ? 4 : 2 * ESZ;
    uint32_t vw[4][2][VWN];  // [key][run][word]
    const int run = nks * ESZ;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = 2 * t + (r & 1) + 8 * (r >> 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* src = vb + key * rowb + (g + 8 * h) * run;
#pragma unroll
        for (int c = 0; c < VWN; c += 4) {
          if (4 * c < run) {
            load16(src + 4 * c, min(16, run - 4 * c), &vw[r][h][c]);
          } else {
            vw[r][h][c] = vw[r][h][c + 1] = vw[r][h][c + 2] =
                vw[r][h][c + 3] = 0u;
          }
        }
#pragma unroll
        for (int c = 0; c < VWN; ++c) {
          if (KIND != 0 && key >= jn) vw[r][h][c] = 0u;
          if (KIND == 0) vw[r][h][c] ^= 0x80808080u;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      if (u >= nks) break;
      // A = V^T: rows (channels) g | g + 8 by keys 2t, 2t + 1 | 2t + 8,
      // 2t + 9: element u of each run
      uint32_t a[4], al[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t* ra = vw[2 * kk][h];      // key 2t (+ 8)
          const uint32_t* rb = vw[2 * kk + 1][h];  // key 2t + 1 (+ 8)
          const int reg = h + 2 * kk;  // a0 (g, 2t..), a1 (g+8), a2, a3
          if constexpr (KIND == 0) {
            const uint32_t sel = (u & 3) | ((4 + (u & 3)) << 8);
            a[reg] = codes_f16x2(ra[u >> 2], rb[u >> 2], sel);
          } else if constexpr (KIND == 1) {
            a[reg] = __byte_perm(ra[u >> 1], rb[u >> 1],
                                 u & 1 ? 0x7632 : 0x5410);
          } else {
            split2<KIND>(__uint_as_float(ra[u]), __uint_as_float(rb[u]),
                         a[reg], al[reg]);
          }
        }
      mma<KIND>(o[u], a[0], a[1], a[2], a[3], pb[0][0], pb[0][1]);
      mma<KIND>(o[u], a[0], a[1], a[2], a[3], pb[1][0], pb[1][1]);
      if constexpr (KIND == 2)
        mma<KIND>(o[u], al[0], al[1], al[2], al[3], pb[0][0], pb[0][1]);
    }

    w.release(i);
    scur = snext;
  }

  // head g's l over its four lanes; lane (g, t) holds O^T of heads 2t,
  // 2t + 1 at channels g hd/16 + u and (g + 8) hd/16 + u
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* ctx = out + ((size_t)w.b * H + (size_t)w.kv * w.G + w.hb) * hd;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gh = 2 * t + e;
    const float lh = __shfl_sync(0xffffffffu, l, gh << 2);
    const float mh = __shfl_sync(0xffffffffu, m, gh << 2);
    // O of head gh in its own units: times 2^-pe
    const float down = pow2(-__shfl_sync(0xffffffffu, pe, gh << 2));
    if (gh >= w.GC) continue;
    const float inv = w.active == 1 ? down / fmaxf(lh, 1e-30f) : down;
    float* dst = w.active == 1 ? ctx + (size_t)gh * hd : w.work_row(work, gh);
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      if (u >= nks) break;
      dst[g * nks + u] = o[u][e] * inv;
      dst[(g + 8) * nks + u] = o[u][2 + e] * inv;
    }
    if (w.active > 1 && g == 0) {
      dst[hd] = mh;
      dst[hd + 1] = lh;
    }
  }
  if (w.active > 1) w.finish(work, arrivals, ctx);
}

// the kernel for G query heads a kv head, with the dynamic shared memory
// of b_blk warps' rings allowed it
template <int KIND>
int prepare(int G, int hd, int b_blk,
            decltype(&batch_decode_kernel<KIND>)* kern, int* smem) {
  *kern = G == 1 ? batch_decode_kernel<KIND> : batch_decode_mma_kernel<KIND>;
  *smem = 128 + b_blk * (warp_bytes<KIND>(hd) + ST * 8);
  static int attr[2] = {0, 0};
  if (*smem > attr[G > 1]) {
    const cudaError_t e = cudaFuncSetAttribute(
        *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr[G > 1] = *smem;
  }
  return 0;
}

template <int KIND>
int occupancy(int G, int hd, int b_blk, int* warps) {
  decltype(&batch_decode_kernel<KIND>) kern;
  int smem = 0, blocks = 0;
  int e = prepare<KIND>(G, hd, b_blk, &kern, &smem);
  if (e == 0)
    e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, b_blk * 32, smem));
  *warps = blocks * b_blk;
  return e;
}

template <int KIND>
int launch(const void* q, const void* kbuf, const void* vbuf, const void* ks,
           const void* vs, const void* pos, void* out, void* work,
           void* arrivals, int B, int H, int KVH, int hd, int Smax, int L,
           int layer, int b_blk, int splits, cudaStream_t st) {
  const int G = H / KVH;
  decltype(&batch_decode_kernel<KIND>) kern;
  int smem = 0;
  int e = prepare<KIND>(G, hd, b_blk, &kern, &smem);
  if (e != 0) return e;
  const uint64_t rows = (uint64_t)L * B * Smax;
  const uint64_t cols = (uint64_t)KVH * hd;
  CUtensorMap tk, tv;
  e = cached_map<KIND>(&tk, kbuf, rows, cols, hd, CH);
  if (e == 0) e = cached_map<KIND>(&tv, vbuf, rows, cols, hd, CH);
  if (e != 0) return e;
  const int ngrp = G == 1 ? 1 : (G + NGT - 1) / NGT;
  kern<<<dim3(splits * ngrp, KVH, B / b_blk), b_blk * 32, smem, st>>>(
      tk, tv, static_cast<const float*>(q), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<float*>(out), static_cast<float*>(work),
      static_cast<int*>(arrivals), B, H, KVH, hd, Smax, layer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bd
}  // namespace

// kv_kind: 0 = int8 codes with f32 scales, 1 = bf16 values, 2 = f32
// values.  hd <= 128 a multiple of 16, any G = H / KVH (one head on the
// CUDA cores, more in groups of 8 on the tensor cores); B a multiple of
// b_blk <= 8, whose rings fit the card's 227 KB; 1 <= splits <=
// ceil(Smax / 16).
// With splits > 1, work is [B, KVH, splits, G, hd + 2] f32 scratch and
// arrivals [B * KVH * groups] int32 zeros, left zero by the launch.
extern "C" int llmc_batch_decode(const void* q, const void* kbuf,
                                 const void* vbuf, const void* ks,
                                 const void* vs, const void* pos, void* out,
                                 void* work, void* arrivals, int B, int H,
                                 int KVH, int hd, int Smax, int L, int layer,
                                 int kv_kind, int b_blk, int splits,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd > dc::HDMAX || hd % 16 || H % KVH || b_blk < 1 ||
      b_blk > bd::MAXW || B % b_blk || B / b_blk > 65535 || splits < 1 ||
      splits > (Smax + bd::CH - 1) / bd::CH || kv_kind < 0 || kv_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define LLMC_BD_KIND(K)                                                     \
  bd::launch<K>(q, kbuf, vbuf, ks, vs, pos, out, work, arrivals, B, H, KVH, \
                hd, Smax, L, layer, b_blk, splits, st)
  return kv_kind == 0 ? LLMC_BD_KIND(0)
         : kv_kind == 1 ? LLMC_BD_KIND(1)
                        : LLMC_BD_KIND(2);
#undef LLMC_BD_KIND
}

// The warps of G query heads a kv head, hd channels and b_blk slots a CTA
// that one SM keeps resident (registers, shared memory and the launch
// bounds), into *warps: the unit of ops/batch_decode.py's split plan.
extern "C" int llmc_batch_decode_occupancy(int kv_kind, int G, int hd,
                                           int b_blk, int* warps) {
  *warps = 0;
  if (hd > dc::HDMAX || hd % 16 || G < 1 || b_blk < 1 || b_blk > bd::MAXW ||
      kv_kind < 0 || kv_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return kv_kind == 0   ? bd::occupancy<0>(G, hd, b_blk, warps)
         : kv_kind == 1 ? bd::occupancy<1>(G, hd, b_blk, warps)
                        : bd::occupancy<2>(G, hd, b_blk, warps);
}
