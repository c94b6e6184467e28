// batch_decode: one-token decode attention for the serving batch — many
// slots, one new token each, short caches — on Hopper (sm_90a).
//
// Replaces: llmc_tpu/ops/batch_decode.py::_kernel (the Pallas TPU kernel,
// pallas_call at :248).  Same function as flash_decode.cu: for slot b and
// query head h,
//   ctx[b,h] = sum_{j <= pos[b]} softmax_j(q[b,h] . k[j]) v[j]
// over the [L, B, Smax, KVH, hd] cache at `layer`, GQA by h / G, int8 codes
// with per-(token, head) f32 scales [L, B, Smax, KVH] or bf16 values, q f32
// and pre-scaled.  The K scale multiplies the score after the dot and the
// V scale folds into the probability; nothing is dequantized element-wise.
// As on the TPU, the slots are taken in blocks of b_blk and a block walks
// the cache in chunks up to its last valid one, blk_last = max(pos in
// block) / chunk, found here inside the kernel (a warp max over the
// block's positions), so the host never reads pos.  A slot whose own
// prefix ends earlier leaves the loop earlier: its later chunks would only
// add zeros.
//
// What bounds it on an H100: the valid cache prefix, (pos[b] + 1) rows of K
// and V per (slot, kv head) — the card's memory rate.  flash_decode.cu
// stages every chunk in shared memory behind block-wide barriers, one CTA
// per (kv head, slot); at 64 rows a slot that is four barriers per chunk
// for 16 KB.  Design here: no shared-memory staging and no barrier in the
// loop.  One CTA takes one kv head and b_blk slots, `wps` warps per slot
// (1 for a full serving batch; more when there are too few slots to fill
// the card, each warp then taking every wps-th step of the rows).  Within
// a warp a K or V row is read 16 bytes a thread, so hd * esz / 16 threads
// cover a row and a warp reads 32 / that many rows at once, four steps
// deep (eight 16-byte loads in flight per thread).  q stays in registers
// (the thread's 16-byte slice of the head).  A score is a shuffle
// reduction over the threads of a row.  Every row group keeps its own f32
// online softmax (m, l, acc) and the groups are merged by shuffles at the
// end, then the warps of a slot through shared memory.  The G query heads
// of a kv head are taken one after another: for G > 1 the K / V rows are
// read again, from L1 / L2 (later work: keep G heads in registers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HDMAX = 128;  // largest head dim
constexpr int MAXW = 16;    // most warps per CTA (b_blk * wps)
constexpr int R = 4;        // rows per thread and step

// the thread's 16 bytes of a row as floats: 16 int8 codes or 8 bf16 values
template <int KIND>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if (KIND == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[4 * i] = (float)(int8_t)(w[i] & 0xFF);
      f[4 * i + 1] = (float)(int8_t)((w[i] >> 8) & 0xFF);
      f[4 * i + 2] = (float)(int8_t)((w[i] >> 16) & 0xFF);
      f[4 * i + 3] = (float)(int8_t)(w[i] >> 24);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

// weight of a partial softmax state with maximum m inside one with m_tot
__device__ __forceinline__ float merge_weight(float m, float m_tot) {
  return m == -INFINITY ? 0.f : expf(m - m_tot);
}

// KIND 0: int8 codes + f32 scales; KIND 1: bf16 values
template <int KIND>
__global__ void __launch_bounds__(MAXW * 32) batch_decode_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ kbuf,
    const uint8_t* __restrict__ vbuf, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ pos,
    float* __restrict__ out, int B, int H, int KVH, int hd, int Smax,
    int layer, int b_blk, int wps, int chunk) {
  constexpr int ESZ = KIND == 0 ? 1 : 2;
  constexpr int E = 16 / ESZ;  // elements in a thread's 16 bytes
  __shared__ float smerge[MAXW][HDMAX + 2];

  const int kv = blockIdx.x, b0 = blockIdx.y * b_blk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / wps, wsub = warp % wps;
  const int b = b0 + slot;
  const int G = H / KVH;
  const int tpr = hd * ESZ / 16;  // threads per row (a power of two)
  const int rpw = 32 / tpr;       // rows per warp and load
  const int rg = lane / tpr, part = lane % tpr;
  const int rows_step = rpw * R;  // rows per warp and step

  // the block's last valid chunk, from the block's own positions
  int pl = lane < b_blk ? pos[b0 + lane] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    pl = max(pl, __shfl_xor_sync(0xffffffffu, pl, o));
  const int blk_last = min(max(pl, 0), Smax - 1) / chunk;
  const int p = min(pos[b], Smax - 1);

  // row index (in units of hd elements) of (layer, b, position 0, kv)
  const size_t base = ((size_t)layer * B + b) * Smax * KVH + kv;

  for (int gq = 0; gq < G; ++gq) {
    const int h = kv * G + gq;
    float qv[E], acc[E];
    const float* qp = q + ((size_t)b * H + h) * hd + part * E;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(qp + e);
      qv[e] = t4.x;
      qv[e + 1] = t4.y;
      qv[e + 2] = t4.z;
      qv[e + 3] = t4.w;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    float m = -INFINITY, l = 0.f;

    for (int ic = 0; ic <= blk_last; ++ic) {
      const int j0 = ic * chunk;
      if (j0 > p) break;  // the slot's prefix ended; the block may go on
      const int jend = min(min(j0 + chunk, Smax), p + 1);
      for (int jb = j0 + wsub * rows_step; jb < jend;
           jb += wps * rows_step) {
        uint4 kk[R], vv[R];
        float ksc[R], vsc[R];
        bool ok[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = jb + r * rpw + rg;
          ok[r] = j < jend;
          kk[r] = make_uint4(0, 0, 0, 0);
          vv[r] = make_uint4(0, 0, 0, 0);
          ksc[r] = vsc[r] = 1.f;
          if (ok[r]) {
            const size_t row = base + (size_t)j * KVH;
            const size_t off = row * hd * ESZ + part * 16;
            kk[r] = *reinterpret_cast<const uint4*>(kbuf + off);
            vv[r] = *reinterpret_cast<const uint4*>(vbuf + off);
            if (KIND == 0) {
              ksc[r] = ks[row];
              vsc[r] = vs[row];
            }
          }
        }
        float sc[R];
        float m_new = m;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float kf[E];
          unpack16<KIND>(kk[r], kf);
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d += qv[e] * kf[e];
          for (int o = tpr >> 1; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          sc[r] = ok[r] ? d * ksc[r] : -INFINITY;
          m_new = fmaxf(m_new, sc[r]);
        }
        if (m_new > -INFINITY) {
          const float corr = merge_weight(m, m_new);
          l *= corr;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float pr = expf(sc[r] - m_new);  // 0 for a masked row
            l += pr;
            const float pv = pr * vsc[r];
            float vf[E];
            unpack16<KIND>(vv[r], vf);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[e] += pv * vf[e];
          }
          m = m_new;
        }
      }
    }

    // merge the row groups of the warp (lane bits above tpr)
    for (int o = tpr; o < 32; o <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
      const float m_t = fmaxf(m, m_o);
      const float ca = merge_weight(m, m_t), cb = merge_weight(m_o, m_t);
      l = l * ca + l_o * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[e], o);
        acc[e] = acc[e] * ca + a_o * cb;
      }
      m = m_t;
    }

    // merge the warps of the slot through shared memory
    if (wps > 1) {
      if (rg == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) smerge[warp][part * E + e] = acc[e];
        if (part == 0) {
          smerge[warp][HDMAX] = m;
          smerge[warp][HDMAX + 1] = l;
        }
      }
      __syncthreads();
      if (wsub == 0 && rg == 0) {
        for (int w2 = 1; w2 < wps; ++w2) {
          const float m_o = smerge[warp + w2][HDMAX];
          const float l_o = smerge[warp + w2][HDMAX + 1];
          const float m_t = fmaxf(m, m_o);
          const float ca = merge_weight(m, m_t), cb = merge_weight(m_o, m_t);
          l = l * ca + l_o * cb;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[e] = acc[e] * ca + smerge[warp + w2][part * E + e] * cb;
          m = m_t;
        }
      }
    }
    if (wsub == 0 && rg == 0) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      float* op = out + ((size_t)b * H + h) * hd + part * E;
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(op + e) = make_float4(
            acc[e] * inv, acc[e + 1] * inv, acc[e + 2] * inv,
            acc[e + 3] * inv);
    }
    if (wps > 1) __syncthreads();  // smerge is written again for head gq+1
  }
}

}  // namespace

// kv_kind: 0 = int8 codes with f32 scales, 1 = bf16 values.  B a multiple
// of b_blk; b_blk * wps <= 16; hd a power of two in [16, 128].
extern "C" int llmc_batch_decode(const void* q, const void* kbuf,
                                 const void* vbuf, const void* ks,
                                 const void* vs, const void* pos, void* out,
                                 int B, int H, int KVH, int hd, int Smax,
                                 int layer, int kv_kind, int b_blk, int wps,
                                 int chunk, void* stream) {
  const dim3 grid(KVH, B / b_blk);
  const int threads = 32 * b_blk * wps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const uint8_t*>(kbuf);
  const auto* vp = static_cast<const uint8_t*>(vbuf);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<float*>(out);
  if (kv_kind == 0)
    batch_decode_kernel<0><<<grid, threads, 0, st>>>(
        qp, kp, vp, ksp, vsp, pp, op, B, H, KVH, hd, Smax, layer, b_blk, wps,
        chunk);
  else
    batch_decode_kernel<1><<<grid, threads, 0, st>>>(
        qp, kp, vp, ksp, vsp, pp, op, B, H, KVH, hd, Smax, layer, b_blk, wps,
        chunk);
  return static_cast<int>(cudaGetLastError());
}
