// Hopper (sm_90a) building blocks of the bf16 tensor-core flash kernels:
// asynchronous 16-byte copies (cp.async) into swizzled shared-memory tiles,
// wgmma shared-memory descriptors, and the bf16 x bf16 -> f32 wgmma
// instructions the kernels issue.
//
// Tile layout.  A tile of R rows of a (rows, D) bf16 operand is stored as
// D / C column blocks of C = min(D, 64) columns (up to 4, at D = 256),
// each R x C, rows of
// C * 2 bytes (128, 64 or 32: the 128B, 64B and 32B swizzle modes).  The
// 16-byte chunks of a row are permuted the way the hardware reads them:
// byte offset o inside a block goes to o ^ (((o >> 7) & kMask) << 4), the
// XOR of address bits [4, 7) with bits [7, 10) (Swizzle<3,4,3>, <2,4,3>,
// <1,4,3>), so every block starts 1024-byte aligned.  The same tile is
// read K-major (its rows are M or N, its columns the reduction: q, k in
// q k^T) or MN-major (its rows are the reduction: v in p v, q and dO in
// the dk/dv products).
//
// Descriptors.  Both strides of a descriptor are set to the distance of
// two 8-row groups (8 * C * 2 bytes).  K-major swizzled layouts read only
// that one (the stride byte offset; the 16 reduction elements of one
// instruction lie inside a row), and every MN-major read here spans one
// column block (N = C), so it too steps only over 8-row groups along the
// reduction.  A 64-row operand starts at row 64 * warpgroup (a multiple of
// the swizzle atom); the k-th group of 16 reduction elements starts
// 32 * k bytes into the row (K-major) or 16 * k rows down (MN-major).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tmx_hopper {

template <int D>
struct TileShape {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 192 ||
                    D == 256,
                "head_dim must be 16, 32, 64, 128, 192 or 256");
  static constexpr int kCols = D < 64 ? D : 64;     // columns of a block
  static constexpr int kBlocks = D / kCols;         // column blocks
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kMask = kRowBytes / 16 - 1;  // 7, 3 or 1
  static constexpr int kChunks = D / 8;             // 16-byte chunks a row
  // wgmma layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // 8-row group stride
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t swizzle(uint32_t off, int mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// Issue the copy of rows [r0, r0 + R) of a (rows, D) bf16 operand into
// a tile at shared address `tile`, by nthreads threads; rows past `rows`
// are zero-filled (the source size is 0, the address clamped to row 0).
template <int D, int R, int kThreads>
__device__ __forceinline__ void copy_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int tid) {
  using S = TileShape<D>;
  constexpr int kN = R * S::kChunks;
#pragma unroll
  for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (kN % kThreads != 0 && i >= kN) break;
    const int r = i / S::kChunks, c = i % S::kChunks;
    const int blk = c / (S::kCols / 8), cc = c % (S::kCols / 8);
    const uint32_t dst =
        tile + blk * R * S::kRowBytes +
        swizzle(static_cast<uint32_t>(r * S::kRowBytes + cc * 16), S::kMask);
    const bool in = r0 + r < rows;
    const __nv_bfloat16* from =
        src + (in ? static_cast<long>(r0 + r) * D + c * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// Copy n float32 values (rows of lse or delta) by the threads whose `tid`
// is in [0, n); values past `valid` are zero-filled.
__device__ __forceinline__ void copy_floats(uint32_t dst, const float* src,
                                            int n, int valid, int tid) {
  if (tid >= 0 && tid < n) {
    const bool in = tid < valid;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst + 4 * tid),
                 "l"(src + (in ? tid : 0)), "r"(in ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The generic-proxy writes of cp.async become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t stride,
                                              uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) |
         (mode << 62);
}

// K-major operand: 64 rows from `row0` of an R-row tile, reduction
// elements [16k, 16k + 16).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int row0,
                                                 int k) {
  using S = TileShape<D>;
  const int col = 16 * k, blk = col / S::kCols;
  return make_desc(tile + blk * R * S::kRowBytes + row0 * S::kRowBytes +
                       (col % S::kCols) * 2,
                   S::kGroup, S::kMode);
}

// MN-major operand: column block `blk` of an R-row tile, reduction rows
// [16k, 16k + 16).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int blk,
                                                  int k) {
  using S = TileShape<D>;
  return make_desc(tile + blk * R * S::kRowBytes + 16 * k * S::kRowBytes,
                   S::kGroup, S::kMode);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats as a bf16x2 word, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The accumulator fragment of an m64nN product maps register i of lane l
// of warp w (of the warpgroup) to row 16w + l/4 + 8((i/2)%2) and column
// 8(i/4) + 2(l%4) + i%2.  Registers 8j..8j+7 are then exactly the
// A-operand fragment of reduction elements [16j, 16j + 16) of a
// register-sourced product: four bf16x2 words.
template <int N>
__device__ __forceinline__ void to_a_frag(const float (&d)[N], int j,
                                          uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(d[8 * j + 2 * r], d[8 * j + 2 * r + 1]);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major
// (no transpose).  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] B[16 x N]: A from registers (to_a_frag), B from
// shared memory MN-major (transposed), accumulating.  N = 16, 32 or 64.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace tmx_hopper
