// Hopper (sm_90a) building blocks for the hand-written tensor-core
// kernels of this directory: 16-byte asynchronous copies into
// 128-byte-swizzled bf16 tiles in shared memory, wgmma descriptors for
// those tiles, the warpgroup products and their fences, and the
// accumulator-to-operand fragment conversions.
//
// Tile layout.  A tile holds 64 rows of a row-major bf16 matrix, kCols
// (a multiple of 64) columns wide, as kCols / 64 blocks of 64 rows x 64
// columns (8 KB each, 1024-byte aligned).  Row r of a block takes 128
// bytes; its 16-byte chunk c lies at chunk c ^ (r % 8) -- the 128B
// swizzle that wgmma's layout type 1 reads, so the 8 rows a product
// fetches at one k step fall in 8 different bank groups.  The same tile
// serves both orientations:
//   K-major operand (rows are M or N, the product sums along a row):
//     k step kk (16 columns) starts at block kk / 4, byte 32 (kk % 4);
//     8-row groups 1024 bytes apart (SBO), LBO unused.
//   MN-major operand (rows are the summed K, columns are N; the
//     transpose bit): k step kk starts at row 16 kk; 8-row groups 1024
//     bytes apart (SBO), 64-column blocks kBlockBytes apart (LBO).
//
// Accumulator fragments (m64nN, f32): thread t = 32 w + l of the
// warpgroup holds d[j] at row 16 w + l / 4 + 8 ((j >> 1) & 1) and column
// 8 (j >> 2) + 2 (l % 4) + (j & 1).  Columns 16 kk .. 16 kk + 15 of such
// an accumulator are, packed to bf16 pairs, the register A operand of
// k step kk (the m16n8k16 A layout of each warp's 16 rows).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace hopper {

constexpr int kRows = 64;                   // rows of a tile: one wgmma M
constexpr int kBlockBytes = kRows * 128;    // one 64 x 64 bf16 block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory's first 1024-byte boundary (callers reserve
// 1024 bytes more than they use)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * kBlockBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// --------------------------------------------------- asynchronous copies

// 16 bytes from global to shared; bytes past src_bytes (0 or 16) are
// zero-filled and not read
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's copy groups are in flight
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}
// this thread's writes to shared memory become visible to the async
// proxy (wgmma's operand reads); a __syncthreads after it publishes them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [row0, row0 + 64) of a row-major (S, D) bf16 matrix into a
// swizzled tile of kCols columns; rows at or past S and columns at or
// past D are zero.  With 16-byte aligned rows (D % 8 == 0) the copies
// are asynchronous (the caller commits and waits); otherwise each chunk
// is gathered element by element and stored at once.
template <int kCols, int kThreads>
__device__ __forceinline__ void load_tile(uint8_t* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int D, int tid) {
  constexpr int kChunks = kCols / 8;        // 16-byte chunks per row
  const uint32_t base = smem_u32(tile);
  const bool aligned =
      (D & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll 4
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r, col = c * 8;
    const __nv_bfloat16* p = src + (size_t)row * D + col;
    if (aligned) {
      const bool live = row < S && col < D;
      cp_async_16(base + swizzled(r, c), live ? p : src, live ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = row < S && col + e < D ? p[e] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(tile + swizzled(r, c)) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc_of(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);   // 1: 128B swizzle
}
// k step kk of a tile read K-major (no transpose bit)
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc_of(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}
// k step kk of a tile read MN-major (the transpose bit)
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return desc_of(tile + kk * 16 * 128, kBlockBytes, 1024);
}

// before the first wgmma, and between other instructions' accesses to a
// wgmma's registers (accumulator or A fragments) and the wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n of the warpgroup's wgmma groups are in flight
template <int n> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(n) : "memory");
}
// keeps the compiler from moving accesses to an accumulator across the
// wgmma instructions (which it cannot see write it asynchronously)
template <int n>
__device__ __forceinline__ void fence_regs(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HOPPER_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B, A and B K-major in shared memory: m64n64k16, bf16 -> f32
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A from registers (a), B MN-major in shared memory (the
// transpose bit): m64n64k16, bf16 -> f32
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A from registers (a), B MN-major in shared memory (the
// transpose bit): m64n128k16, bf16 -> f32
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_D8

// d += A B with A from registers, N = 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs takes N = 64 or 128");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---------------------------------------------------------- fragments

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

// the register A operand of k step kk from columns 16 kk .. 16 kk + 15
// of a 64-column accumulator, each value rounded to bf16
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const float (&d)[32], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// the same split in two: hi = bf16(x) and lo = bf16(x - hi), so hi + lo
// carries x to ~2^-16 relative; two products on one float32 accumulator
// then sum x itself, not its bf16 rounding
__device__ __forceinline__ void a_fragment_split(uint32_t (&hi)[4],
                                                 uint32_t (&lo)[4],
                                                 const float (&d)[32],
                                                 int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = d[8 * kk + 2 * i], x1 = d[8 * kk + 2 * i + 1];
    const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
    hi[i] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
    lo[i] = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
  }
}

// the row and column of accumulator register j for lane l of warp w
__device__ __forceinline__ int frag_row(int w, int l, int j) {
  return 16 * w + l / 4 + 8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int l, int j) {
  return 8 * (j >> 2) + 2 * (l & 3) + (j & 1);
}

}  // namespace hopper
