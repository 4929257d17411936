// What the runtime-D flash kernels (flash_attention_fwd_dn.cu,
// flash_attention_bwd_dn.cu) share: head dims of 320 and more, any
// multiple of 64, passed as an argument instead of a template parameter.
//
// Why the templated instances stop at D = 256: they keep Q (forward, dq) or
// K and V (dk/dv) whole in shared memory beside a ring of the streamed
// tiles, and at D = 320 the bf16 forward's Q tile plus two K/V stages take
// 240 KB (the float32 one 251 KB) against the 232,448 bytes a block may
// have; at D = 512 a float32 Q tile and one K/V stage of 32 keys take 266 KB.
//
// The design here keeps shared memory fixed whatever D is:
//   - a block owns 64 rows (4 warps of 16, mma.sync fragments) and 64
//     output columns, column block blockIdx.z of D / 64: the D = 128
//     instances' registers at most (one 64-column block of O or dQ, of dK
//     and of dV);
//   - the score products (S = Q K^T, and dP = dO V^T in the backward) are
//     dot products over all D: their operands are streamed through shared
//     memory in 64-column chunks (64 rows x 64 columns a tile), summed into
//     the same accumulator registers chunk after chunk;
//   - so every column block recomputes S (and dP) and the softmax
//     statistics: D / 64 times the score products of a kernel that keeps
//     all of O resident, the price of the fixed budget.  The forward does
//     (D/64 + 1) / 2 times the operations of the single pass, dq
//     (2 D/64 + 1) / 3 and dk/dv (2 D/64 + 2) / 4: 4.5, 5.67 and 4.5 at
//     D = 512;
//   - each chunk is copied with cp.async (16 bytes a thread, rows past T or
//     Tk zero-filled), then waited for: one stage, no ring.  Latency is
//     hidden by the blocks an SM holds (4 warps and 35-70 KB each), not
//     inside a block.
// bf16 runs mma.sync.m16n8k16 (float32 accumulators, P and dS rounded to
// bf16 as the wgmma instances round them); float32 runs 3xTF32
// mma.sync.m16n8k8 (flash_common.cuh), every k-step's three products summed
// from zero and added by FADD (mma_3xtf32_sum<true>, ROADMAP B item 8c), in
// the score products and in the output products alike.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace tmx_dn {

using namespace tmx_flash;

constexpr int kRows = 64;     // rows of a block: 4 warps of 16
constexpr int kThreads = 128;
constexpr int kChunk = 64;    // columns of a streamed chunk; keys of a tile
constexpr float kLog2e = 1.4426950408889634f;

// Row stride of a 64-column tile in shared memory, in elements.  float32:
// 68 (= 4 mod 32 words): fragments read one float at a time, along a row
// (bank 4g + t) or down the rows (rows 2t and 2t + 1 at column g: bank
// 8t + g), hit 32 distinct banks.  bf16: 72 (36 words, = 4 mod 32): the
// 32-bit pairs along a row hit bank 4g + t.
template <typename T>
constexpr int kLd = sizeof(T) == 4 ? 68 : 72;

template <typename T>
constexpr size_t tile_bytes() {
  return sizeof(T) * kRows * kLd<T>;
}

// Issue the copy of rows [r0, r0 + 64) and columns [c0, c0 + 64) of a
// (rows, d) operand into a tile at shared address dst; rows past `rows` are
// zero-filled (source size 0, address clamped to row 0).
template <typename T>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const T* src, int r0,
                                           int rows, int d, int c0, int tid) {
  constexpr int kPer = 16 / sizeof(T);       // elements of a 16-byte copy
  constexpr int kRowCopies = kChunk / kPer;  // 16-byte copies of a row
  constexpr int kN = kRows * kRowCopies;
#pragma unroll
  for (int it = 0; it < kN / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kRowCopies, c = (i % kRowCopies) * kPer;
    const bool in = r0 + r < rows;
    const T* from = src + (in ? static_cast<long>(r0 + r) * d + c0 + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + static_cast<uint32_t>(sizeof(T) *
                                                 (r * kLd<T> + c))),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// The copies issued so far have landed and every thread sees them.
__device__ __forceinline__ void chunk_ready() {
  tmx_hopper::cp_async_commit();
  tmx_hopper::cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 bit patterns as one word, the first in the low half.
__device__ __forceinline__ uint32_t pack_bits(unsigned short lo,
                                              unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// s[j] += A B^T over one 64-column chunk: A the warp's 16 rows (g, g + 8)
// at `a`, B the 64 rows (8j + g) of the tile at `b`, both row-major tiles
// kLd<T> elements a row.  The score products: S = Q K^T, dP = dO V^T and
// their transposes.
template <typename T>
__device__ __forceinline__ void score_chunk(float (&s)[8][4], const T* a,
                                            const T* b, int g, int t);

template <>
__device__ __forceinline__ void score_chunk<float>(float (&s)[8][4],
                                                   const float* a,
                                                   const float* b, int g,
                                                   int t) {
  constexpr int L = kLd<float>;
  // k-steps one at a time: unrolled, the compiler hoists their shared
  // loads and splits, and the backward's kernels spilled
#pragma unroll 1
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    const int c = 8 * kk + t;  // reduction elements t and t + 4
    uint32_t ah[4], al[4];
    split_frag(a[g * L + c], a[(g + 8) * L + c], a[g * L + c + 4],
               a[(g + 8) * L + c + 4], ah, al);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_3xtf32_sum<true>(s[j], ah, al, b[(8 * j + g) * L + c],
                           b[(8 * j + g) * L + c + 4]);
  }
}

template <>
__device__ __forceinline__ void score_chunk<__nv_bfloat16>(
    float (&s)[8][4], const __nv_bfloat16* a, const __nv_bfloat16* b, int g,
    int t) {
  constexpr int W = kLd<__nv_bfloat16> / 2;  // words a row
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(b);
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const int w = 8 * kk + t;  // columns 16kk + 2t, 16kk + 2t + 1
    const uint32_t af[4] = {aw[g * W + w], aw[(g + 8) * W + w],
                            aw[g * W + w + 4], aw[(g + 8) * W + w + 4]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_bf16(s[j], af, bw[(8 * j + g) * W + w], bw[(8 * j + g) * W + w + 4]);
  }
}

// acc[n] += P B over 64 keys (or queries): P the warp's 16 x 64 C fragments
// as they stand (p[j] holds rows g, g + 8 and keys 8j + 2t, 8j + 2t + 1),
// B the tile at `b`, 64 key rows of 64 columns (8n + g).  The output
// products: O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q.  P is
// consumed (the float32 product leaves it rotated).
template <typename T>
__device__ __forceinline__ void out_chunk(float (&acc)[8][4],
                                          float (&p)[8][4], const T* b,
                                          int g, int t);

template <>
__device__ __forceinline__ void out_chunk<float>(float (&acc)[8][4],
                                                 float (&p)[8][4],
                                                 const float* b, int g,
                                                 int t) {
  constexpr int L = kLd<float>;
  // one 8-key step at a time, P's step always in p[0] (the array rotated
  // after each step, so that it stays in registers): unrolled whole, the
  // compiler hoisted the steps' shared loads and splits, and the backward
  // spilled 400 bytes; indexed by the loop counter, P went to local memory
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    // keys 8j + 2t and 8j + 2t + 1 as reduction elements t and t + 4
    uint32_t ah[4], al[4];
    split_frag(p[0][0], p[0][2], p[0][1], p[0][3], ah, al);
    const float* b2 = b + (8 * j + 2 * t) * L + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma_3xtf32_sum<true>(acc[n], ah, al, b2[8 * n], b2[L + 8 * n]);
#pragma unroll
    for (int r = 0; r < 7; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[r][i] = p[r + 1][i];
  }
}

template <>
__device__ __forceinline__ void out_chunk<__nv_bfloat16>(
    float (&acc)[8][4], float (&p)[8][4], const __nv_bfloat16* b, int g,
    int t) {
  constexpr int L = kLd<__nv_bfloat16>;
  const unsigned short* bs = reinterpret_cast<const unsigned short*>(b);
#pragma unroll
  for (int c = 0; c < kChunk / 16; ++c) {
    const uint32_t af[4] = {tmx_hopper::pack_bf16(p[2 * c][0], p[2 * c][1]),
                            tmx_hopper::pack_bf16(p[2 * c][2], p[2 * c][3]),
                            tmx_hopper::pack_bf16(p[2 * c + 1][0],
                                                  p[2 * c + 1][1]),
                            tmx_hopper::pack_bf16(p[2 * c + 1][2],
                                                  p[2 * c + 1][3])};
    const unsigned short* r = bs + (16 * c + 2 * t) * L + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma_bf16(acc[n], af, pack_bits(r[8 * n], r[L + 8 * n]),
               pack_bits(r[8 * L + 8 * n], r[9 * L + 8 * n]));
  }
}

// Store two adjacent output columns of row `row` (float32 or rounded to
// bf16).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = 0.f;
}

}  // namespace tmx_dn
