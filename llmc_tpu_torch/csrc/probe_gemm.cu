// probe_gemm: the w4 design probes, nine variants of the W4A16 kernel
// (dequant_matmul_w4.cu) on Hopper (sm_90a), each the same skeleton with
// one part changed, so that the difference of two variants' times is the
// cost of that part on this card.
//
// Replaces the TPU design probes (Pallas kernels local to the tools; one
// kernel per function, whatever the TPU tiling arguments of its calls):
//   kBf16Chunked  tools/kernel_bench.py:113 bf16_pallas / _bf16_kernel
//                 (and tools/w4_probe.py:120, the same function)
//   kBf16Bigdot   tools/w4_probe.py:149 bf16_big / _bf16_big
//   kI8Cast       tools/kernel_bench.py:151 i8_pallas (and
//                 tools/w4_probe.py:179 i8_big, the same function)
//   kI8xI8        tools/w4_probe.py:210 i8i8 / _i8i8
//   kW4Block      tools/w4_probe.py:257 w4_block / _w4_block
//   kW4Fullq      tools/kernel_bench.py:236 fullq / _fullq_kernel
//   kI32Window    tools/kernel_bench.py:191 i32_pallas / _i32_kernel
//   kW4Xc         tools/kernel_bench.py:297 xc_pallas / _xc_kernel
//   kI4Native     tools/w4_probe.py:295 i4_big / _i4_big
//
// Functions (x bf16 [M, K], f32 sums of exact products, bf16 out):
//   kBf16Chunked  y = sum_c x_c . w_c^T, w bf16 [N, K], a fresh f32 partial
//                 per 128-column chunk c added into the accumulator
//   kBf16Bigdot   the same sum straight into one accumulator
//   kI8Cast       y = x . bf16(codes)^T, codes int8 [N, K]
//   kI8xI8        y = xq . codes^T in int32, xq and codes int8 [M|N, K],
//                 int32 out (the quantizer of x stays outside)
//   kW4Block      packed [N, K/2] u8 in group pairs (byte p*128 + c: column
//                 2p*128 + c low nibble, (2p+1)*128 + c high nibble), W =
//                 bf16(u * bf16(s[n, g])) with u the stored nibble 0..15 (no
//                 excess-8 correction), s [N, K/128] f32
//   kW4Fullq      the same bytes read as group halves (byte g*64 + c: column
//                 g*128 + c low nibble, g*128 + 64 + c high nibble), W =
//                 bf16(u * bf16(s_t[g, n])), s_t [K/128, N] f32
//   kI32Window    words int32 [N, K/8]: in each 1024-column window t, column
//                 t*1024 + j*128 + c is nibble j of word [n, t*128 + c]; no
//                 scale
//   kW4Xc         y = sum_g s_t[g, n] (xe_g . b_g^T + xc_g . (b_g >> 4)^T)
//                 over 64-byte groups g, xe and xc bf16 [M, K/2], b the
//                 byte 0..255 of packed [N, K/2] (exact in bf16); the scale
//                 multiplies each group's f32 partial
//   kI4Native     packed [N, K/2] u8, two's-complement 4-bit codes, column
//                 2c in the low nibble of byte c; y = x . bf16(codes)^T
//
// What bounds them on an H100 at N = 22016, K = 4096 (data-sheet peaks,
// 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8): at M = 128 the bf16 and
// int8 weights' bytes (0.056 ms for bf16 w, 0.029 for int8 codes, 0.030
// for kI8xI8 with its int32 out) and the bf16 tensor-core rate for the
// 4-bit rows (0.023 ms); at M = 4096 the tensor-core rate for all (0.747
// ms bf16, 0.373 ms kI8xI8 at the int8 rate).
//
// Design: dequant_matmul_w4.cu's skeleton unchanged in every variant —
// 256 threads on a 64 x 128 output tile (one row tile: the probes run at
// M >= 64; rows beyond M are zero-filled and never written), a ring of
// STAGES cp.async buffers of 16-byte copies over the K chunks, the 8 warps
// side by side along N, A fragments by ldmatrix, mma.sync m16n8k16 bf16 ->
// f32 (m16n8k32 s8 -> s32 for kI8xI8), split-K below one wave summed in a
// fixed order by a second kernel.  A compile-time weight policy sets what
// differs: the weight bytes a row a chunk, the decode of a B fragment to
// bf16x2 (a 32-bit load for bf16; int8 and u8 through f32 magic numbers;
// a nibble by the 0x4300|v - 128 trick), where the scale goes (none; into
// the bf16 weight by one bf16x2 multiply; onto a fresh f32 partial), and
// whether a chunk gets a fresh partial.  kI32Window loads four 32-bit
// words a thread a chunk and decodes all eight nibbles of each, one per
// k step: the load-time repack ROADMAP B1 proposes, measured.
// Not here: wgmma, TMA, persistence.

#include <type_traits>

#include "gemm_common.cuh"

namespace {

enum Kind : int {
  kBf16Chunked = 0,
  kBf16Bigdot = 1,
  kI8Cast = 2,
  kI8xI8 = 3,
  kW4Block = 4,
  kW4Fullq = 5,
  kI32Window = 6,
  kW4Xc = 7,
  kI4Native = 8,
};

constexpr int PBM = 64;  // the probes' one row tile

template <int KIND>
struct Policy {
  static constexpr bool I8A = KIND == kI8xI8;  // int8 A tile, int32 out
  static constexpr int ES = I8A ? 1 : 2;       // bytes an A element
  // A columns a chunk stages: a group pair for kW4Block; for kW4Xc 64
  // columns of xe then 64 of xc; for kI32Window 16 columns from each of
  // the window's eight 128-column pieces
  static constexpr int AK = KIND == kW4Block ? 2 * KC : KC;
  // columns of K (the C interface's K) a chunk covers, and of x (kW4Xc:
  // of xe and of xc, each K/2 wide)
  static constexpr int KCH = KIND == kW4Block ? 2 * KC : KC;
  static constexpr int CK = KIND == kW4Xc ? KC / 2 : KCH;
  // weight bytes a row a chunk
  static constexpr int WB =
      (KIND == kBf16Chunked || KIND == kBf16Bigdot) ? 2 * KC
      : (KIND == kI8Cast || KIND == kI8xI8 || KIND == kW4Block) ? KC
                                                                 : KC / 2;
  // a fresh f32 partial per chunk
  static constexpr bool FRESH = KIND == kBf16Chunked || KIND == kW4Xc;
  static constexpr int MI = PBM / 16, NJ = BN / 8 / 8;
  static constexpr int XS = AK * ES + 16;  // x smem row stride, bytes
  static constexpr int WS = WB + 16;       // weight smem row stride, bytes
  static constexpr int X_BYTES = PBM * XS;
  static constexpr int W_BYTES = BN * WS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "alignment");
  static_assert(AK * ES % 16 == 0 && WB % 16 == 0, "16-byte copies");
};

struct Args {
  const uint8_t* x;   // bf16 [M, K] (int8 for kI8xI8; xe [M, K/2] for kW4Xc)
  const uint8_t* x2;  // xc [M, K/2] (kW4Xc only)
  const uint8_t* w;   // the weight rows, N of them
  const float* s;     // [N, K/128] (kW4Block), [K/128, N] (kW4Fullq, kW4Xc)
  void* out;          // [M, N] bf16 (int32 for kI8xI8)
  void* partial;      // [splits, M, N] f32 (int32), or null
  int M, N, K, chunks_per_split;
};

__device__ __forceinline__ uint32_t nib2bf16x2(uint32_t a, uint32_t b) {
  // a, b in 0..15 -> bf16x2 {a, b} exactly: bf16(128 + v) is 0x4300 | v
  uint32_t r = 0x43004300u | a | (b << 16);
  const uint32_t k128 = 0x43004300u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&k128));
  return *reinterpret_cast<uint32_t*>(&v);
}

// bytes 0 and 1 of u, int8 (SIGNED) or uint8, -> bf16x2 exactly: the f32
// 2^23 + b' (b' the byte, biased by 128 when signed) less its bias is the
// integer, and an integer below 256 in magnitude is its f32's upper half
template <bool SIGNED>
__device__ __forceinline__ uint32_t byte2bf16x2(uint32_t u) {
  const uint32_t flip = SIGNED ? 0x80u : 0u;
  const float bias = SIGNED ? 8388736.f : 8388608.f;  // 2^23 (+ 128)
  const float v0 = __uint_as_float(0x4B000000u | ((u ^ flip) & 0xFFu)) - bias;
  const float v1 =
      __uint_as_float(0x4B000000u | (((u >> 8) ^ flip) & 0xFFu)) - bias;
  return __byte_perm(__float_as_uint(v0), __float_as_uint(v1), 0x7632);
}

// a byte of two 4-bit two's-complement codes -> bf16x2 {low, high}:
// v ^ 8 is the code + 8, and bf16(128 + that) - 136 the code
__device__ __forceinline__ uint32_t s4x2_bf16x2(uint32_t byte) {
  uint32_t r = ((byte | (byte << 12)) & 0x000F000Fu) ^ 0x00080008u;
  r |= 0x43004300u;
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2_splat(float s) {
  __nv_bfloat162 v = __bfloat162bfloat162(__float2bfloat16_rn(s));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

template <int KIND>
__global__ void __launch_bounds__(NT, 1) probe_gemm_kernel(const Args a) {
  using P = Policy<KIND>;
  using Acc = typename std::conditional<P::I8A, int, float>::type;
  constexpr int MI = P::MI, NJ = P::NJ;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp * (BN / 8);
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * PBM;
  const int M = a.M, N = a.N, K = a.K;
  const int nck = K / P::KCH;  // chunks along K
  const size_t row_bytes = (size_t)nck * P::WB;
  const int c_begin = blockIdx.z * a.chunks_per_split;
  const int n_chunks = min(nck, c_begin + a.chunks_per_split) - c_begin;

  auto stage_x = [&](int st) { return smem + st * P::STAGE; };
  auto stage_w = [&](int st) { return smem + st * P::STAGE + P::X_BYTES; };

  auto load_chunk = [&](int st, int i) {
    const int ci = c_begin + i;
    uint8_t* sx = stage_x(st);
    uint8_t* sw = stage_w(st);
    constexpr int XV = P::AK * P::ES / 16;  // 16-byte vectors a staged row
    for (int v = tid; v < PBM * XV; v += NT) {
      const int r = v / XV, q = v % XV;
      const int m = m0 + r;
      const size_t mc = (size_t)min(m, M - 1);
      const uint8_t* src;
      if constexpr (KIND == kI32Window) {
        // vector q: 8 columns of piece j = q / 2 of window ci / 8
        const int col = (ci / 8) * 1024 + (q >> 1) * KC + (ci % 8) * 16 +
                        (q & 1) * 8;
        src = a.x + (mc * K + col) * 2;
      } else if constexpr (KIND == kW4Xc) {
        const uint8_t* base = q < XV / 2 ? a.x : a.x2;
        src = base +
              (mc * (K / 2) + (size_t)ci * P::CK + (q % (XV / 2)) * 8) * 2;
      } else {
        src = a.x + (mc * K + (size_t)ci * P::CK) * P::ES + q * 16;
      }
      cp_async16(sx + r * P::XS + q * 16, src, m < M);
    }
    constexpr int WV = P::WB / 16;
    for (int v = tid; v < BN * WV; v += NT) {
      const int r = v / WV, q = v % WV;
      const int n = n0 + r;
      const uint8_t* src = a.w + (size_t)min(n, N - 1) * row_bytes +
                           (size_t)ci * P::WB + q * 16;
      cp_async16(sw + r * P::WS + q * 16, src, n < N);
    }
  };

  Acc acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_chunks) load_chunk(j, j);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % STAGES, ci = c_begin + i;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i landed; every warp is done with chunk i-1
    if (i + STAGES - 1 < n_chunks)
      load_chunk((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_async_commit();

    const uint8_t* sx = stage_x(st);
    const uint8_t* sw = stage_w(st);
    // the A fragment of rows mi*16.., staged columns col..col+15 (bf16)
    // or bytes col..col+31 (int8)
    auto load_a = [&](uint32_t (&fa)[MI][4], int col) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(fa[mi],
                    sx + (mi * 16 + (lane & 15)) * P::XS +
                        (col + (P::I8A ? 16 : 8) * (lane >> 4)) * P::ES);
    };

    if constexpr (P::I8A) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 32) {
        uint32_t fa[MI][4];
        load_a(fa, kk);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          // B fragment: column n = g, k = 4t .. 4t+3 and 16+4t .. 16+4t+3
          const uint8_t* wb = sw + (wn + nj * 8 + g) * P::WS + kk + 4 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wb);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wb + 16);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            mma16832_s8(acc[mi][nj], fa[mi], b0, b1);
        }
      }
    } else {
      float part[MI][NJ][4];
      if constexpr (P::FRESH) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
      }
      float(&dst)[MI][NJ][4] = P::FRESH ? part : acc;
      const uint8_t* wrow[NJ];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) wrow[nj] = sw + (wn + nj * 8 + g) * P::WS;

      if constexpr (KIND == kI32Window) {
        // four words a thread feed its B fragments of all eight pieces:
        // words 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of the chunk's sixteen
        uint2 lo[NJ], hi[NJ];
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          lo[nj] = *reinterpret_cast<const uint2*>(wrow[nj] + 8 * t);
          hi[nj] = *reinterpret_cast<const uint2*>(wrow[nj] + 32 + 8 * t);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t fa[MI][4];
          load_a(fa, j * 16);
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) {
            const int sh = 4 * j;
            const uint32_t b0 = nib2bf16x2((lo[nj].x >> sh) & 0xF,
                                           (lo[nj].y >> sh) & 0xF);
            const uint32_t b1 = nib2bf16x2((hi[nj].x >> sh) & 0xF,
                                           (hi[nj].y >> sh) & 0xF);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
              mma16816(dst[mi][nj], fa[mi], b0, b1);
          }
        }
      } else if constexpr (KIND == kW4Xc) {
#pragma unroll
        for (int kk = 0; kk < KC / 2; kk += 16) {
          uint32_t fe[MI][4], fc[MI][4];
          load_a(fe, kk);
          load_a(fc, KC / 2 + kk);
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) {
            const uint32_t u0 = ld16(wrow[nj] + kk + 2 * t);
            const uint32_t u1 = ld16(wrow[nj] + kk + 8 + 2 * t);
            const uint32_t be0 = byte2bf16x2<false>(u0);
            const uint32_t be1 = byte2bf16x2<false>(u1);
            const uint32_t bc0 = nib2bf16x2((u0 >> 4) & 0xF, (u0 >> 12) & 0xF);
            const uint32_t bc1 = nib2bf16x2((u1 >> 4) & 0xF, (u1 >> 12) & 0xF);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma16816(dst[mi][nj], fe[mi], be0, be1);
              mma16816(dst[mi][nj], fc[mi], bc0, bc1);
            }
          }
        }
      } else {
        // the weight-side bf16 scales of this chunk: per half (kW4Block:
        // groups 2ci, 2ci+1; kW4Fullq: group ci for both halves)
        uint32_t sc[NJ][2];
        if constexpr (KIND == kW4Block || KIND == kW4Fullq) {
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) {
            const int n = n0 + wn + nj * 8 + g;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float sv = 0.f;
              if (n < N)
                sv = KIND == kW4Block ? a.s[(size_t)n * (K / KC) + 2 * ci + h]
                                      : a.s[(size_t)ci * N + n];
              sc[nj][h] = bf16x2_splat(sv);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < P::AK; kk += 16) {
          uint32_t fa[MI][4];
          load_a(fa, kk);
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) {
            // B fragment: column n = g, k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1)
            const uint8_t* wr = wrow[nj];
            uint32_t b0, b1;
            if constexpr (KIND == kBf16Chunked || KIND == kBf16Bigdot) {
              b0 = *reinterpret_cast<const uint32_t*>(wr + (kk + 2 * t) * 2);
              b1 = *reinterpret_cast<const uint32_t*>(wr +
                                                      (kk + 8 + 2 * t) * 2);
            } else if constexpr (KIND == kI8Cast) {
              b0 = byte2bf16x2<true>(ld16(wr + kk + 2 * t));
              b1 = byte2bf16x2<true>(ld16(wr + kk + 8 + 2 * t));
            } else if constexpr (KIND == kI4Native) {
              b0 = s4x2_bf16x2(wr[kk / 2 + t]);
              b1 = s4x2_bf16x2(wr[kk / 2 + 4 + t]);
            } else {  // kW4Block (halves of 128 columns), kW4Fullq (of 64)
              constexpr int HALF = KIND == kW4Block ? KC : KC / 2;
              const int h = kk / HALF, c = kk % HALF;
              const uint32_t u0 = ld16(wr + c + 2 * t) >> (4 * h);
              const uint32_t u1 = ld16(wr + c + 8 + 2 * t) >> (4 * h);
              b0 = bf16x2_mul(nib2bf16x2(u0 & 0xF, (u0 >> 8) & 0xF), sc[nj][h]);
              b1 = bf16x2_mul(nib2bf16x2(u1 & 0xF, (u1 >> 8) & 0xF), sc[nj][h]);
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
              mma16816(dst[mi][nj], fa[mi], b0, b1);
          }
        }
      }

      if constexpr (P::FRESH) {
        // kBf16Chunked adds the partial; kW4Xc scales it by s_t[ci, n]
        float sv[NJ][2];
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn + nj * 8 + 2 * t + e;
            sv[nj][e] = KIND == kBf16Chunked ? 1.f
                        : n < N              ? a.s[(size_t)ci * N + n]
                                             : 0.f;
          }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (KIND == kBf16Chunked)
                acc[mi][nj][e] += part[mi][nj][e];
              else
                acc[mi][nj][e] += part[mi][nj][e] * sv[nj][e & 1];
            }
      }
    }
  }

  if constexpr (P::I8A) {
    // int32 out, or this split's int32 partial
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + mi * 16 + g + 8 * r;
          const int n = n0 + wn + nj * 8 + 2 * t;
          if (m >= M || n >= N) continue;  // N is even: n + 1 < N too
          int* dst = a.partial != nullptr
                         ? static_cast<int*>(a.partial) +
                               (size_t)blockIdx.z * M * N
                         : static_cast<int*>(a.out);
          *reinterpret_cast<int2*>(dst + (size_t)m * N + n) =
              make_int2(acc[mi][nj][2 * r], acc[mi][nj][2 * r + 1]);
        }
  } else {
    write_tile<MI, NJ, false>(acc, a.out, static_cast<float*>(a.partial),
                              nullptr, M, N, m0, n0 + wn, lane, blockIdx.z);
  }
}

// int32 split-K partials [splits, M*N] summed in split order
__global__ void __launch_bounds__(256) split_sum_i32_kernel(
    const int* __restrict__ partial, int* __restrict__ out, int splits,
    size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  int v = partial[i];
  for (int z = 1; z < splits; ++z) v += partial[z * mn + i];
  out[i] = v;
}

template <int KIND>
int launch(Args a, int splits, cudaStream_t st) {
  using P = Policy<KIND>;
  auto kern = probe_gemm_kernel<KIND>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         P::SMEM);
    attr = true;
  }
  const int nck = a.K / P::KCH;
  a.chunks_per_split = (nck + splits - 1) / splits;
  void* partial = a.partial;
  if (splits <= 1) a.partial = nullptr;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + PBM - 1) / PBM, splits);
  kern<<<grid, NT, P::SMEM, st>>>(a);
  if (splits > 1) {
    if constexpr (P::I8A) {
      const size_t mn = (size_t)a.M * a.N;
      split_sum_i32_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
          static_cast<const int*>(partial), static_cast<int*>(a.out), splits,
          mn);
    } else {
      launch_split_sum<false>(partial, a.out, nullptr, splits, a.M, a.N, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: the Kind above; splits >= 1 K-splits (partial: [splits, M, N] f32,
// int32 for kI8xI8, when splits > 1).  K is x's row length (for kW4Xc
// twice the row length of xe and xc).
extern "C" int llmc_probe_gemm(int kind, const void* x, const void* x2,
                               const void* w, const void* s, void* out,
                               void* partial, int M, int N, int K,
                               int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(x2),
               static_cast<const uint8_t*>(w), static_cast<const float*>(s),
               out, partial, M, N, K, 0};
  switch (kind) {
    case kBf16Chunked: return launch<kBf16Chunked>(a, splits, st);
    case kBf16Bigdot: return launch<kBf16Bigdot>(a, splits, st);
    case kI8Cast: return launch<kI8Cast>(a, splits, st);
    case kI8xI8: return launch<kI8xI8>(a, splits, st);
    case kW4Block: return launch<kW4Block>(a, splits, st);
    case kW4Fullq: return launch<kW4Fullq>(a, splits, st);
    case kI32Window: return launch<kI32Window>(a, splits, st);
    case kW4Xc: return launch<kW4Xc>(a, splits, st);
    case kI4Native: return launch<kI4Native>(a, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
