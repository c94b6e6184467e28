// quant_act_token: the per-token int8 activation quantizer of the W4A8
// path, on Hopper (sm_90a), in one launch and one pass over x.
//
// Replaces no TPU kernel: the reference leaves this quantizer to XLA
// (llmc_tpu/ops/dequant_matmul.py::_quant_act_token, :143-151, called
// before the Pallas kernel at :399), and the port's plain version is
// llmc_tpu_torch/ops/dequant_matmul.py::_quant_act_token.  Per row m of x
// [M, K] (bf16 or f32), with the arithmetic in exactly this form:
//   amax    = max_k |f32(x[m,k])|
//   sx[m]   = fmaxf(amax, 1e-8f) * (1.0f / 127.0f)   (XLA's folded division)
//   xq[m,k] = clamp(rintf(x[m,k] / sx[m]), -127, 127)  (a true division,
//             rounded half to even as torch.round and jnp.round do)
// so xq and sx equal the plain version's bit for bit.  It also writes the
// int32 sums of xq over each 64-column piece, sums[p, m] (rows padded to
// Mp, a multiple of 4, with zeros): the zero term of the W4A8 GEMM
// (dequant_matmul_w4a8.cu), whose producer loads them with each stage by
// TMA.
//
// What bounds it on an H100: the bytes, x read once and xq written once
// (one CTA a row, the row held in registers between the max and the
// codes; a row wider than 32768 columns is read twice instead).  It
// takes the place of the torch ops before each W4A8 launch (an abs, a max,
// a clamp, a multiply, a division, a round, a clamp, a cast) and of the
// row-sum mma of the W4A8 kernel's old design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads a row
constexpr int PIECE = 64;     // columns a sum
constexpr int VEC = 8;        // elements a thread reads at once

// eight elements of x as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// NV vectors of VEC elements a thread, K <= NV * VEC * NT, held in
// registers; NV = 0: any K, each vector read once for the max and again
// for the codes
template <typename X, int NV>
__global__ void __launch_bounds__(NT) quant_act_token_kernel(
    const X* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
    int* __restrict__ sums, int M, int K, int Mp) {
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int nvec = K / VEC;
  if (m >= M) {  // a padding row of the sums: zeros
    for (int p = tid; p < K / PIECE; p += NT) sums[(size_t)p * Mp + m] = 0;
    return;
  }
  const X* row = x + (size_t)m * K;
  const int nv = NV ? NV : (nvec + NT - 1) / NT;
  float v[NV ? NV : 1][VEC];
  float amax = 0.f;
#pragma unroll
  for (int n = 0; n < nv; ++n) {
    const int i = n * NT + tid;
    if (i < nvec) {
      float(&vn)[VEC] = v[NV ? n : 0];
      load8(row + (size_t)i * VEC, vn);
#pragma unroll
      for (int k = 0; k < VEC; ++k) amax = fmaxf(amax, fabsf(vn[k]));
    }
  }
  // the row's max: over the warp, then over the eight warps
  __shared__ float wmax[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
  if (lane == 0) wmax[tid >> 5] = amax;
  __syncthreads();
  amax = wmax[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) amax = fmaxf(amax, wmax[w]);
  const float scale = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  if (tid == 0) sx[m] = scale;

  int8_t* qrow = xq + (size_t)m * K;
#pragma unroll
  for (int n = 0; n < nv; ++n) {
    // every thread takes part in the shuffles: K / VEC is a multiple of 8,
    // so the eight threads of a piece are in or out together
    const int i = n * NT + tid;
    const bool in = i < nvec;
    int sum = 0;
    uint32_t packed[2] = {0u, 0u};
    if (in) {
      float(&vn)[VEC] = v[NV ? n : 0];
      if (NV == 0) load8(row + (size_t)i * VEC, vn);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float q =
            fminf(fmaxf(rintf(__fdiv_rn(vn[k], scale)), -127.f), 127.f);
        const int c = static_cast<int>(q);
        sum += c;
        packed[k >> 2] |= (static_cast<uint32_t>(c) & 0xFFu) << (8 * (k & 3));
      }
      *reinterpret_cast<uint2*>(qrow + (size_t)i * VEC) =
          make_uint2(packed[0], packed[1]);
    }
    // the eight threads of a 64-column piece
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
    if (in && (i & 7) == 0) sums[(size_t)(i / 8) * Mp + m] = sum;
  }
}

template <typename X, int NV>
void launch(const void* x, void* xq, void* sx, void* sums, int M, int K,
            int Mp, cudaStream_t st) {
  quant_act_token_kernel<X, NV><<<Mp, NT, 0, st>>>(
      static_cast<const X*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), static_cast<int*>(sums), M, K, Mp);
}

template <typename X>
int dispatch(const void* x, void* xq, void* sx, void* sums, int M, int K,
             int Mp, cudaStream_t st) {
  const int nv = (K / VEC + NT - 1) / NT;  // vectors a thread
  if (nv <= 1)
    launch<X, 1>(x, xq, sx, sums, M, K, Mp, st);
  else if (nv <= 2)
    launch<X, 2>(x, xq, sx, sums, M, K, Mp, st);
  else if (nv <= 4)
    launch<X, 4>(x, xq, sx, sums, M, K, Mp, st);
  else if (nv <= 8)
    launch<X, 8>(x, xq, sx, sums, M, K, Mp, st);
  else if (nv <= 16)
    launch<X, 16>(x, xq, sx, sums, M, K, Mp, st);
  else
    launch<X, 0>(x, xq, sx, sums, M, K, Mp, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16 (x_f32 0) or f32 (x_f32 1), K a multiple of 64; xq int8
// [M, K]; sx f32 [M]; sums int32 [K/64, Mp], Mp >= M
// (rows M .. Mp-1 of every piece are written as zeros).
extern "C" int llmc_quant_act_token(const void* x, void* xq, void* sx,
                                    void* sums, int M, int K, int Mp,
                                    int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32) return dispatch<float>(x, xq, sx, sums, M, K, Mp, st);
  return dispatch<__nv_bfloat16>(x, xq, sx, sums, M, K, Mp, st);
}
