// What the runtime-D flash kernels (flash_attention_fwd_dn.cu,
// flash_attention_bwd_dn.cu) share: head dims of 320 and more, any
// multiple of 64, passed as an argument instead of a template parameter.
//
// Why the templated instances stop at D = 256: they keep Q (forward, dq) or
// K and V (dk/dv) whole in shared memory beside a ring of the streamed
// tiles, and at D = 320 the bf16 forward's Q tile plus two K/V stages take
// 240 KB (the float32 one 251 KB) against the 232,448 bytes a block may
// have; and one warpgroup's registers hold at most 256 columns of a
// 64-row float32 accumulator.
//
// Two designs live here.
//
// 1. The split-D design of the forward and dk/dv (the second half of this
//    file).  A 64-row tile's D columns are split over consumer
//    warpgroups, two a block, the blocks of a thread-block cluster along
//    D (split_d): a warpgroup owns up to 256 columns of O (forward) or
//    128 each of dK and dV (64 in float32), in 64-column blocks, and
//    reads only its own slice of the operands.  The score products (S =
//    Q K^T; dk/dv S^T = K Q^T and dP^T = V dO^T) are summed from the
//    warpgroups' partial products over their slices, through shared
//    memory and, across the cluster, through distributed shared memory
//    (Exchange), so every score product is computed once for each pair
//    of query and key tiles wherever one cluster holds all of D (up to
//    4096 forward, 2048 bf16 and 1024 float32 dk/dv; beyond, passes of
//    clusters share out the columns, each summing the scores over all of
//    D).  Every warpgroup then holds the whole 64 x 64 tile, runs the same
//    online softmax on it (dk/dv: receives P^T and dS^T, made once by the
//    owner of each part of the tile) and applies it to its own columns.
//    The bf16 forward keeps its Q slice resident and streams K and V
//    through a per-warpgroup cp.async ring of 64 x 64 tiles (Ring: four
//    copies in flight bf16, two float32, while the current tiles
//    compute); dk/dv keeps K and V resident and stages Q and dO once a
//    query tile for both of its products.  Against streaming these
//    operands through the ring too, the resident ones take 10-15% off
//    the bf16 forward's device time and 7-33% off dk/dv's on the H100
//    (torch_flash_ab.py --runtime-d; PERF.md); the ring alone
//    serves what does not fit (more than one pass of clusters).  bf16 on wgmma (hopper.cuh; P
//    and dS from registers as the A operand), float32 on 3xTF32 mma.sync.
//    What is still shared with the dq kernel: the tile layout and copy of
//    the float32 tiles (kLd<float>, copy_chunk<float>), kRows, kChunk,
//    store2 and the flash_common.cuh masks, dropout hash and bias reads.
// 2. The column-block design all three kernels had first, which the dq
//    kernel still runs: a block owns 64 rows (4 warps of 16, mma.sync
//    fragments) and 64 output columns,
//    column block blockIdx.z of D / 64, and streams the score products'
//    operands over D in 64-column chunks (copy_chunk, chunk_ready: one
//    cp.async stage, no ring), so every column block recomputes S and dP:
//    dq does (2 D/64 + 1) / 3 times the operations of one pass, 5.67x at
//    D = 512.  Its helpers chunk_ready, score_chunk, out_chunk, mma_bf16,
//    pack_bits, tile_bytes and zero are used by dq alone.
// bf16 column blocks run mma.sync.m16n8k16 (float32 accumulators, P and
// dS rounded to bf16 as the wgmma instances round them); float32 runs
// 3xTF32 mma.sync.m16n8k8 (flash_common.cuh), every k-step's three
// products summed from zero and added by FADD (mma_3xtf32_sum<true>,
// ROADMAP B item 8c), in the score products and in the output products
// alike, in both designs.
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

// --- the split-D design of the forward and dk/dv ----------------------------

constexpr int kWg = 128;             // threads of a warpgroup
constexpr int kSplitThreads = 256;   // two consumer warpgroups a block
constexpr int kClusterMax = 8;       // the portable cluster size
constexpr int kFwdCapBlocks = 4;     // 256 columns of O a warpgroup
// 128 columns each of dK and dV a bf16 warpgroup, 64 a float32 one (its
// resident K and V, a query tile of Q and of dO and the exchange's
// buffers fill its half of shared memory)
template <typename T>
constexpr int kDkvCapBlocks = sizeof(T) == 4 ? 1 : 2;
// a dk/dv cluster has at least two blocks (four warpgroups), so that a
// warpgroup owns at most two of a tile's eight exchange groups: with
// four, a float32 region would pass kRegionMax
constexpr int kFwdMinBlocks = 1, kDkvMinBlocks = 2;

// How a head dim is split (tpu_mx_torch/kernels/flash_attention.py
// runtime_d_split computes the same): the warpgroups that hold all of D
// at `cap` 64-column blocks each, two a block, in clusters of at most
// kClusterMax blocks; `passes` clusters walk the columns when one cannot
// hold them all, and `wgs` warpgroups share each pass's columns.
struct Split {
  int cluster, passes, wgs;
};

__host__ __device__ __forceinline__ Split split_d(int d, int cap,
                                                  int min_blocks) {
  const int blocks = d / kChunk;
  const int wgs = (blocks + cap - 1) / cap;
  int ctas = (wgs + 1) / 2;
  if (ctas < min_blocks) ctas = min_blocks;
  const int passes = (ctas + kClusterMax - 1) / kClusterMax;
  const int cluster = (ctas + passes - 1) / passes;
  return {cluster, passes, 2 * cluster};
}

// Blocks [s0, s0 + n) shared out evenly over `parts`: part i's first
// block and count.
__host__ __device__ __forceinline__ void share(int s0, int n, int parts,
                                               int i, int& b0, int& nb) {
  nb = n / parts + (i < n % parts ? 1 : 0);
  b0 = s0 + i * (n / parts) + (i < n % parts ? i : n % parts);
}

// The output's 64-column blocks [b0, b0 + nb) of warpgroup w of pass p:
// the blocks shared out evenly over the passes, then over the
// warpgroups.
__host__ __device__ __forceinline__ void slice_of(int d, const Split& sp,
                                                  int p, int w, int& b0,
                                                  int& nb) {
  int p0, pn;
  share(0, d / kChunk, sp.passes, p, p0, pn);
  share(p0, pn, sp.wgs, w, b0, nb);
}

// The score products' 64-column blocks of warpgroup w: all of D shared
// out over the pass's warpgroups (the output's blocks when there is one
// pass; with more, every pass sums the scores over all of D).
__host__ __device__ __forceinline__ void score_slice_of(int d,
                                                        const Split& sp,
                                                        int w, int& b0,
                                                        int& nb) {
  share(0, d / kChunk, sp.wgs, w, b0, nb);
}

// The launch's grid.x for `rows` rows (queries forward, keys dk/dv): a
// cluster a pass a 64-row tile.
__host__ __device__ __forceinline__ long split_grid_x(const Split& sp,
                                                      int rows) {
  return static_cast<long>(sp.cluster) * sp.passes *
         ((rows + kRows - 1) / kRows);
}

// The split a kernel launches with, written out for a host-side check of
// flash_attention.runtime_d_split: cluster, passes, warpgroups, grid.x
// for `rows`, then each pass's warpgroups' (first block, blocks) of the
// output, then each warpgroup's of the scores.  Returns the ints written,
// or -1 when `n` ints cannot hold them.
inline int write_split(int d, const Split& sp, int rows, int* out, int n) {
  const int need = 4 + 2 * sp.wgs * (sp.passes + 1);
  if (n < need) return -1;
  out[0] = sp.cluster;
  out[1] = sp.passes;
  out[2] = sp.wgs;
  const long gx = split_grid_x(sp, rows);
  out[3] = gx > 2147483647L ? -1 : static_cast<int>(gx);
  int at = 4;
  for (int p = 0; p < sp.passes; ++p)
    for (int w = 0; w < sp.wgs; ++w, at += 2)
      slice_of(d, sp, p, w, out[at], out[at + 1]);
  for (int w = 0; w < sp.wgs; ++w, at += 2)
    score_slice_of(d, sp, w, out[at], out[at + 1]);
  return need;
}

// A ring tile is 64 x 64: bf16 swizzled (128-byte rows, the wgmma
// layout), float32 rows of kLd<float> = 68 floats (mma.sync).
template <typename T>
constexpr uint32_t kTileBytes = sizeof(T) == 4 ? 64 * 68 * 4 : 64 * 64 * 2;
// tiles of a warpgroup's streaming ring
template <typename T>
constexpr int kRingTiles = sizeof(T) == 4 ? 4 : 6;
constexpr uint32_t kGroupBytes = kWg * 16;  // a float4 of every thread
constexpr int kGroups = 8;                  // of a 64 x 64 float32 tile
constexpr uint32_t kPartBytes = kGroups * kGroupBytes;  // one tile
// A warpgroup's region holds at most this (two a block, 1024 bytes of
// alignment, 232,448 bytes a block)
constexpr uint32_t kRegionMax = (232448 - 1024) / 2;

// Whether an exchange among `wgs` warpgroups whose regions hold
// `tiles_bytes` of tiles is an all-gather (one barrier, two partial
// buffers): two or four warpgroups, where the buffers fit; else a
// reduce-scatter then a gather.
__host__ __device__ constexpr bool exchange_gathers(uint32_t tiles_bytes,
                                                   int wgs) {
  return (wgs == 2 || wgs == 4) &&
         tiles_bytes + 2 * kPartBytes <= kRegionMax;
}

// The exchange's bytes in a warpgroup's region: two partial tiles, or
// one and the groups the warpgroup reduces for the others.
__host__ __device__ constexpr uint32_t exchange_bytes(uint32_t tiles_bytes,
                                                      int wgs) {
  return exchange_gathers(tiles_bytes, wgs)
             ? 2 * kPartBytes
             : kPartBytes + ((kGroups + wgs - 1) / wgs) * kGroupBytes;
}

// A warpgroup's region of shared memory: `tiles` 64 x 64 tiles (its
// ring, or its resident and staged operands), then the exchange's
// buffers.  The block's two regions follow each other from a 1024-byte
// aligned base, at the same offsets in every block of the cluster.
template <typename T>
__host__ __device__ constexpr uint32_t wg_region_bytes(int tiles, int wgs) {
  return tiles * kTileBytes<T> + exchange_bytes(tiles * kTileBytes<T>, wgs);
}

// The forward's tiles: the ring, and bf16's resident Q slice.
template <typename T>
constexpr int kFwdTiles = kRingTiles<T> + (sizeof(T) == 4 ? 0 : kFwdCapBlocks);
// dk/dv's: with one pass, its slices of K and V (resident) and of one
// query tile's Q and dO; with more, the ring.
template <typename T>
__host__ __device__ constexpr int dkv_tiles(bool resident) {
  return resident ? 4 * kDkvCapBlocks<T> : kRingTiles<T>;
}
// dk/dv's region: its tiles, its partial S^T and dP^T, and the P^T and
// dS^T of the groups it owns (the dk/dv kernel's exchange).
template <typename T>
__host__ __device__ constexpr uint32_t dkv_region_bytes(bool resident,
                                                        int wgs) {
  return dkv_tiles<T>(resident) * kTileBytes<T> + 2 * kPartBytes +
         2 * ((kGroups + wgs - 1) / wgs) * kGroupBytes;
}

// A block's dynamic shared memory: two regions and the alignment.
__host__ __device__ constexpr size_t split_smem_bytes(uint32_t region) {
  return 1024 + 2 * static_cast<size_t>(region);
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster has arrived; the shared
// memory writes before it are visible to the reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The 128 threads of warpgroup `half` of this block.
__device__ __forceinline__ void wg_sync(int half) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
}

// A shared address of this block as the same address in block `rank` of
// the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b,
                                           float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Issue the copy of rows [r0, r0 + 64) and columns [c0, c0 + 64) of a
// (rows, d) operand into a ring tile at `dst`, by a warpgroup's 128
// threads; rows past `rows` are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_block(uint32_t dst, const T* src, int r0,
                                           int rows, int d, int c0, int tid);

template <>
__device__ __forceinline__ void copy_block<float>(uint32_t dst,
                                                  const float* src, int r0,
                                                  int rows, int d, int c0,
                                                  int tid) {
  copy_chunk<float>(dst, src, r0, rows, d, c0, tid);
}

template <>
__device__ __forceinline__ void copy_block<__nv_bfloat16>(
    uint32_t dst, const __nv_bfloat16* src, int r0, int rows, int d, int c0,
    int tid) {
  // 64 rows of eight 16-byte chunks, each at its 128B-swizzled place
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = tid + it * kWg, r = i / 8, cc = i % 8;
    const bool in = r0 + r < rows;
    const __nv_bfloat16* from =
        src + (in ? static_cast<long>(r0 + r) * d + c0 + 8 * cc : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + tmx_hopper::swizzle(
                               static_cast<uint32_t>(r * 128 + 16 * cc), 7)),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// c[4n .. 4n + 3] += the 3xTF32 product of one k-step, summed apart.
__device__ __forceinline__ void mma_3xtf32_at(float (&c)[32], int n,
                                              const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4],
                                              float b0, float b1) {
  float part[4] = {c[4 * n], c[4 * n + 1], c[4 * n + 2], c[4 * n + 3]};
  mma_3xtf32_sum<true>(part, ah, al, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[4 * n + i] = part[i];
}

// s += A B^T over one 64-column block, float32: A the warp's 16 rows at
// `a`, B the 64 rows of the tile at `b` (kLd<float> a row).  s is a
// 64 x 64 accumulator in the wgmma layout (register i of lane l of warp w:
// row 16w + l/4 + 8((i/2)%2), column 8(i/4) + 2(l%4) + i%2), which is the
// m16n8 fragments of the warp's 16 rows side by side.
__device__ __forceinline__ void score_f32(float (&s)[32], const float* a,
                                          const float* b, int g, int t) {
  constexpr int L = kLd<float>;
#pragma unroll 1
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    const int c = 8 * kk + t;  // reduction elements t and t + 4
    uint32_t ah[4], al[4];
    split_frag(a[g * L + c], a[(g + 8) * L + c], a[g * L + c + 4],
               a[(g + 8) * L + c + 4], ah, al);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_3xtf32_at(s, j, ah, al, b[(8 * j + g) * L + c],
                    b[(8 * j + g) * L + c + 4]);
  }
}

// s += A B^T over one 64-column block, bf16: SS wgmma m64n64k16 on the
// swizzled tiles at shared addresses a (the warpgroup's 64 rows) and b.
__device__ __forceinline__ void score_bf16(float (&s)[32], uint32_t a,
                                           uint32_t b) {
  tmx_hopper::fence_regs(s);
  tmx_hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
    tmx_hopper::wgmma_ss(s, tmx_hopper::desc_k_major<64, 64>(a, 0, kk),
                         tmx_hopper::desc_k_major<64, 64>(b, 0, kk), 1);
  tmx_hopper::wgmma_commit();
  tmx_hopper::wgmma_wait();
  tmx_hopper::fence_regs(s);
}

// acc += P B over 64 keys (or queries), float32: P a 64 x 64 tile in the
// wgmma layout (its rows the warp's, its columns the reduction), B the
// tile at `b`, 64 reduction rows of 64 output columns.  One 8-key step at
// a time, P's step always in p[0 .. 3]: the array is rotated by one step
// after each (in registers; indexed by the loop counter it would go to
// local memory; two steps an iteration spilled) and is whole again at
// the end.
__device__ __forceinline__ void out_f32(float (&acc)[32], float (&p)[32],
                                        const float* b, int g, int t) {
  constexpr int L = kLd<float>;
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    // keys 8j + 2t and 8j + 2t + 1 as reduction elements t and t + 4
    uint32_t ah[4], al[4];
    split_frag(p[0], p[2], p[1], p[3], ah, al);
    const float* b2 = b + (8 * j + 2 * t) * L + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma_3xtf32_at(acc, n, ah, al, b2[8 * n], b2[L + 8 * n]);
    const float x0 = p[0], x1 = p[1], x2 = p[2], x3 = p[3];
#pragma unroll
    for (int r = 0; r < 28; ++r) p[r] = p[r + 4];
    p[28] = x0;
    p[29] = x1;
    p[30] = x2;
    p[31] = x3;
  }
}

// acc += P B over 64 keys (or queries), bf16: P as the four A fragments
// of register-sourced wgmma (tmx_hopper::to_a_frag), B the swizzled tile
// at shared address b read MN-major.
__device__ __forceinline__ void out_bf16(float (&acc)[32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
  tmx_hopper::fence_regs(acc);
  tmx_hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kChunk / 16; ++j)
    tmx_hopper::wgmma_rs(acc, a[j], tmx_hopper::desc_mn_major<64, 64>(b, 0, j));
  tmx_hopper::wgmma_commit();
  tmx_hopper::wgmma_wait();
  tmx_hopper::fence_regs(acc);
}

// The exchange of a split-D kernel: sums the warpgroups' partial 64 x 64
// tiles (32 floats a thread in the wgmma layout) so that every
// warpgroup of the cluster holds the sum, with the same bits.  Partials
// are stored in groups of a float4 a thread (group q of thread tid at
// q * 2048 + 16 tid), and read from the other blocks of the cluster
// through distributed shared memory (mapa, ld.shared::cluster).
struct Exchange {
  uint32_t base, region, part;  // part: the buffers' offset in a region
  int n, w, rank, tid;
  bool one_block;  // the cluster is this block: block barriers suffice
  bool gather;     // exchange_gathers
  int parity;

  __device__ __forceinline__ void sync() const {
    if (one_block)
      __syncthreads();
    else
      cluster_sync();
  }
  // group q of thread tid in warpgroup v's region at offset `off`
  __device__ __forceinline__ float4 load(int v, uint32_t off, int q) const {
    const uint32_t at = base + (v & 1) * region + off + q * kGroupBytes +
                        16 * tid;
    if ((v >> 1) == rank) {
      float4 y;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(y.x), "=f"(y.y), "=f"(y.z), "=f"(y.w)
                   : "r"(at)
                   : "memory");
      return y;
    }
    return ld_cluster4(map_rank(at, v >> 1));
  }
  __device__ __forceinline__ void store(uint32_t off, int q, float a, float b,
                                        float c, float d) const {
    st_shared4(base + (w & 1) * region + off + q * kGroupBytes + 16 * tid, a,
               b, c, d);
  }

  // All-gather (two or four warpgroups): each writes its partial to one
  // of its two buffers (alternating), one barrier, then each sums the
  // partials as a tree of pairs, (p0 + p1) + (p2 + p3), its own from its
  // registers: addition is commutative, so every warpgroup gets the same
  // bits.  A buffer is rewritten two exchanges later, after the next
  // exchange's barrier, which every reader reaches only once it has
  // read it.
  // Reduce-scatter: each writes its partial, one barrier, then warpgroup
  // q % n sums group q over the n partials in order and keeps the sums
  // beside its partial, a second barrier, then every warpgroup reads
  // every group from its owner: a warpgroup moves about two tiles' bytes
  // however many share the tile.  A partial is rewritten only after the
  // next exchange's products, once the owners have read it (the second
  // barrier); the sums only after the next exchange's first barrier.
  __device__ __forceinline__ void operator()(float (&x)[32]) {
    if (gather) {
      const uint32_t off = part + parity * kPartBytes;
      parity ^= 1;
#pragma unroll
      for (int q = 0; q < kGroups; ++q)
        store(off, q, x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      sync();
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        float4 z = load(w ^ 1, off, q);
        if (n == 4) {
          const float4 b = load(w ^ 2, off, q), c = load(w ^ 3, off, q);
          z.x = (x[4 * q] + z.x) + (b.x + c.x);
          z.y = (x[4 * q + 1] + z.y) + (b.y + c.y);
          z.z = (x[4 * q + 2] + z.z) + (b.z + c.z);
          z.w = (x[4 * q + 3] + z.w) + (b.w + c.w);
        } else {
          z.x += x[4 * q];
          z.y += x[4 * q + 1];
          z.z += x[4 * q + 2];
          z.w += x[4 * q + 3];
        }
        x[4 * q] = z.x;
        x[4 * q + 1] = z.y;
        x[4 * q + 2] = z.z;
        x[4 * q + 3] = z.w;
      }
      return;
    }
    const uint32_t res = part + kPartBytes;  // the sums
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
      store(part, q, x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    sync();
    for (int q = w, r = 0; q < kGroups; q += n, ++r) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int v = 0; v < n; ++v) {
        const float4 z = load(v, part, q);
        sum.x += z.x;
        sum.y += z.y;
        sum.z += z.z;
        sum.w += z.w;
      }
      store(res, r, sum.x, sum.y, sum.z, sum.w);
    }
    sync();
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const float4 z = load(q % n, res, q / n);
      x[4 * q] = z.x;
      x[4 * q + 1] = z.y;
      x[4 * q + 2] = z.z;
      x[4 * q + 3] = z.w;
    }
  }
};

// Wait for the cp.async groups issued before the last `pending` ones
// (0 to 4), then make them visible to the warpgroup (and to wgmma).
template <typename T>
__device__ __forceinline__ void landed(int pending, int half) {
  switch (pending) {
    case 0: tmx_hopper::cp_async_wait<0>(); break;
    case 1: tmx_hopper::cp_async_wait<1>(); break;
    case 2: tmx_hopper::cp_async_wait<2>(); break;
    case 3: tmx_hopper::cp_async_wait<3>(); break;
    default: tmx_hopper::cp_async_wait<4>(); break;
  }
  if constexpr (sizeof(T) == 2) tmx_hopper::fence_async_smem();
  wg_sync(half);
}

// A warpgroup's streaming ring of kTiles 64 x 64 tiles: tile i of the
// stream goes to slot i % kTiles; `issue(i, dst)` issues its copy (nothing
// past the last tile) and the ring commits one cp.async group a tile.
// `acquire` waits for the next tile, issues the copy of the tile
// kTiles - 2 ahead into the slot of the tile before the previous one,
// and returns the next tile's slot: a step may read the two tiles it
// acquired last while kTiles - 2 copies are in flight.
template <typename T, typename Issue>
struct Ring {
  static constexpr int kTiles = kRingTiles<T>;
  uint32_t slots;
  int half;
  int next;
  Issue& issue;

  __device__ __forceinline__ void put(int i) {
    issue(i, slots + (i % kTiles) * kTileBytes<T>);
    tmx_hopper::cp_async_commit();
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < kTiles - 2; ++i) put(i);
  }
  __device__ __forceinline__ uint32_t acquire() {
    landed<T>(kTiles - 3, half);
    put(next + kTiles - 2);
    return slots + (next++ % kTiles) * kTileBytes<T>;
  }
};

}  // namespace tmx_dn
