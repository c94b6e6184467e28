// The Hopper skeleton of the GEMM kernels B1 (dequant_matmul_w4.cu), B3
// (dequant_matmul_w4a8.cu), B4 (dequant_matmul_w8.cu) and B6
// (fp8_block_gemm.cu): y = x @ W^T over a weight that stays in its stored
// form (packed nibbles, int8 or e4m3 codes).
//
// Swap AB: a CTA computes y^T for 128 weight rows (output columns n) by T
// tokens (rows m of x), as two consumer warpgroups of 64 weight rows each.
// wgmma.mma_async m64nTk16 (bf16, f16) or m64nTk32 (s8) takes the weight
// decoded in registers as its A operand (the RS form) and the x tile from
// shared memory as B, so the token count is wgmma's N: one set of
// instantiations, T in {8, 16, 32, 64, 128}, covers every M, and each
// weight byte crosses L2 once per T tokens.  The K loop walks units of
// UNIT weight bytes a row:
//
// - a producer warp: one thread keeps a ring of STAGES units in flight by
//   TMA (the weight tile [128 rows x UNIT B], and one or two x boxes
//   [T rows x XROW B] as wgmma reads them: 64 bf16 or f16 under the
//   128-byte swizzle, 64 int8 under the 64-byte one; for B1 and B3 also
//   the T row sums of each x box for the zero term, from a sums tensor made
//   once per call), each landing on the stage's `full` mbarrier; for B6 its
//   lanes also store the stage's T per-token scales;
// - two consumer warpgroups: each thread reads its A-fragment bytes of the
//   unit from shared memory (conflict-free under the swizzle), decodes
//   them, issues the unit's wgmma and releases the stage: one arrival a
//   warp on the stage's `empty` mbarrier;
// - the epilogue stages y^T through shared memory and stores [M, N] rows
//   coalesced: bf16 or f32 out (each row times a per-token scale for B3),
//   or this split's f32 partial, summed in a fixed order by
//   gemm_common.cuh's split_sum_kernel (deterministic).
//
// TMA zero-fills rows past M and N.  The tensor maps are encoded on the
// host in the launch function (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: the library links no libcuda) and passed as
// __grid_constant__ parameters.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "gemm_common.cuh"  // split-K sum

namespace {
namespace wg {

constexpr int ROWS = 128;      // weight rows (output columns) per CTA
constexpr int UNIT = 64;       // weight bytes a row per stage
constexpr int CONSUMERS = 256; // two consumer warpgroups
// and one producer warp.  At nine warps a CTA, three share one of the SM's
// four register files, so ptxas gives a thread at most 168 registers (with
// setmaxnreg or without: an H100 build showed no difference).
constexpr int NTHREADS = CONSUMERS + 32;
constexpr int RING_BUDGET = 220 * 1024;  // ring + row sums, bytes
constexpr int MAX_STAGES = 8;
constexpr int OUT_LD = ROWS + 4;  // staging row stride, floats (no conflicts)

// Shared memory of one instantiation: T tokens; a weight tile of ROWS rows
// of UNIT bytes and XB x boxes of T rows of XROW bytes a stage; SUMS boxes
// of T 4-byte values a stage beside the ring (row sums of x, or per-token
// scales).  The ring starts 1024-aligned; every stage is a multiple of
// 1024 bytes, as the 128-byte swizzle needs (the 64-byte one needs 512); a
// sums box takes at least the 128 bytes a TMA destination is aligned to.
template <int T, int XB, int SUMS, int XROW = 128>
struct Layout {
  static constexpr int W_BYTES = ROWS * UNIT;
  static constexpr int X_BYTES = T * XROW;
  static constexpr int SUM_BYTES = T * 4;
  static constexpr int SUM_BOX = SUM_BYTES < 128 ? 128 : SUM_BYTES;
  static constexpr int STAGE = W_BYTES + XB * X_BYTES;
  static constexpr int SUMS_BYTES = SUMS * SUM_BOX;  // a stage's sums boxes
  static constexpr int TX = STAGE + SUMS * SUM_BYTES;  // bytes, all by TMA
  static constexpr int FIT = RING_BUDGET / (STAGE + SUMS_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BARS = RING + STAGES * SUMS_BYTES;  // 2 mbarriers a stage
  static constexpr int SMEM = 1024 + BARS + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0, "stage alignment");
  static_assert(STAGES >= 2, "ring too small");
  static_assert(T * OUT_LD * 4 <= RING, "output staging must fit the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// A consumer warp is done with a stage: one arrival a warp on its `empty`
// barrier, once every lane is.
__device__ __forceinline__ void release_stage(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a fault in the ring's bookkeeping) traps after
// about 2^24 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0 inner, c1 outer) of `map` into shared memory, its
// bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Named barrier over the consumer warpgroups only.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions: each register is "used and changed" here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma descriptor of a K-major tile whose rows are SW bytes under the
// SW-byte swizzle (SW = 128 or 64): 8-row groups 8 * SW bytes apart (SBO);
// a k step of 32 bytes (k16 of bf16, k32 of 8-bit codes) is +2 on the
// descriptor (the start address in 16-byte units).
template <int SW>
__device__ __forceinline__ uint64_t desc_k(const void* tile) {
  static_assert(SW == 128 || SW == 64, "swizzle");
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(SW / 2) << 32) |
         (static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62);
}

// The two 16-bit pieces of one A-fragment row for k16 step `ks` of a unit:
// bytes 2t, 2t+1 (low half) and 2t+8, 2t+9 (high half) of row r of a
// [128 x 64 B] tile stored under the 64-byte swizzle (16-byte chunk c of
// row r at chunk c ^ ((r >> 1) & 3)).  Over a warp, rows g = 0..7 at one
// t fall in 16 distinct banks.
__device__ __forceinline__ uint32_t frag_bytes(const uint8_t* w, int r, int ks,
                                               int t) {
  const uint8_t* p = w + r * UNIT + ((ks ^ ((r >> 1) & 3)) << 4) + 2 * t;
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + 8);
  return lo | (hi << 16);
}

// wgmma m64nNk16, bf16 x bf16 -> f32, A from registers, B K-major from
// shared memory; scale_d 0 writes d fresh, 1 adds to it.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a,
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// wgmma m64nNk16, f16 x f16 -> f32, A from registers, B K-major from
// shared memory; scale_d 0 writes d fresh, 1 adds to it.
template <int N>
__device__ __forceinline__ void wgmma_f16_rs(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_f16_rs<8>(float* d, const uint32_t* a,
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_f16_rs<16>(float* d, const uint32_t* a,
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_f16_rs<32>(float* d, const uint32_t* a,
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_f16_rs<64>(float* d, const uint32_t* a,
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_f16_rs<128>(float* d, const uint32_t* a,
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// wgmma m64nNk32, s8 x s8 -> s32, A from registers (four bytes of one
// row a register, the bf16 fragment's byte layout), B K-major from shared
// memory; scale_d 0 writes d fresh, 1 adds to it.
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int* d, const uint32_t* a,
                                            uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8_rs<8>(int* d, const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<16>(int* d, const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<32>(int* d, const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(int* d, const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<128>(int* d, const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Write this consumer thread's y^T fragment (acc[4j+e]: weight row
// r0 + 8 (e >> 1), token 8j + 2t + (e & 1)) through shared memory to
// [M, N]: the output (bf16 or f32; each row times row_scale[m] when it is
// given), or this split's f32 partial.
template <int T, bool OUT_F32>
__device__ __forceinline__ void store_tile(const float (&acc)[T / 2],
                                           uint8_t* smem, void* out,
                                           float* partial,
                                           const float* row_scale, int M,
                                           int N, int m0, int n0, int split,
                                           int r0, int t) {
  float* st = reinterpret_cast<float*>(smem);
  consumers_sync();  // every consumer is done with the ring
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[(8 * j + 2 * t + (e & 1)) * OUT_LD + r0 + 8 * (e >> 1)] =
          acc[4 * j + e];
  consumers_sync();
  const int c = (threadIdx.x & 31) * 4, n = n0 + c;
  const bool vec = (N % 4 == 0) && n + 3 < N;
  for (int m = threadIdx.x >> 5; m < T && m0 + m < M; m += CONSUMERS / 32) {
    float4 v = *reinterpret_cast<const float4*>(&st[m * OUT_LD + c]);
    if (partial == nullptr && row_scale != nullptr) {
      const float r = __ldg(row_scale + m0 + m);
      v = make_float4(v.x * r, v.y * r, v.z * r, v.w * r);
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
    const size_t o = (size_t)(m0 + m) * N + n;
    if (partial != nullptr || OUT_F32) {
      float* dst = partial != nullptr
                       ? partial + (size_t)split * M * N + o
                       : static_cast<float*>(out) + o;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < N) dst[q] = vs[q];
      }
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
      if (vec) {
        __nv_bfloat162 b[2] = {__floats2bfloat162_rn(v.x, v.y),
                               __floats2bfloat162_rn(v.z, v.w)};
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<uint2*>(b);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < N) dst[q] = __float2bfloat16_rn(vs[q]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes of the launch functions beside cudaError_t's: no driver entry
// point, or a tensor map the driver refused.
constexpr int ERR_NO_ENCODE = 9001;
constexpr int ERR_ENCODE = 9002;

// A 2-D row-major tensor map: `rows` x `cols` elements of `esize` bytes,
// rows `row_bytes` apart (0: cols * esize), boxes of box_rows x box_cols,
// zero fill out of bounds.
inline int encode_2d(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type, int esize, uint64_t rows,
                     uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                     CUtensorMapSwizzle swizzle, uint64_t row_bytes = 0) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes ? row_bytes : cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// launch<T, OUT_F32>(args...) for the caller's token tile
#define LLMC_DISPATCH_T(tt, OUT_F32, launch_fn, ...)       \
  ((tt) == 8    ? launch_fn<8, OUT_F32>(__VA_ARGS__)       \
   : (tt) == 16 ? launch_fn<16, OUT_F32>(__VA_ARGS__)      \
   : (tt) == 32 ? launch_fn<32, OUT_F32>(__VA_ARGS__)      \
   : (tt) == 64 ? launch_fn<64, OUT_F32>(__VA_ARGS__)      \
                : launch_fn<128, OUT_F32>(__VA_ARGS__))

}  // namespace wg
}  // namespace
