// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// each in bf16 on the tensor cores (wgmma) and in float32 on the tensor
// cores in split precision (3xTF32 mma.sync).
//
// Replaces the backward Pallas TPU kernels of tpu_mx/kernels/
// flash_attention.py, both launched by _bwd:
//   - flash_dq_tc_kernel (bf16) and flash_dq_tf32x3_kernel (float32)
//       <- _bwd_dq_kernel:  dq = ds K, with
//       s  = q k^T * scale (masked),  p = exp(s - lse),  dp = dO V^T,
//       dp <- z/(1-r) * dp  (the regenerated keep mask z),
//       ds = p o (dp - delta) * scale;
//   - flash_dkv_tc_kernel (bf16) and flash_dkv_tf32x3_kernel (float32)
//       <- _bwd_dkv_kernel: dv = (z/(1-r) * p)^T dO and dk = ds^T q.
// delta = rowsum(dO o O) (float32, (BH, T)) and lse come from the caller,
// as in the reference.  The masks (causal, kv_valid) and the keep mask are
// those of the forward (flash_common.cuh), so the kernels agree bit for
// bit on which probabilities were dropped.  Accumulators are float32; dq,
// dk and dv are written in q's type.  dq stays a kernel of its own, with
// no atomics, so its result does not depend on the order blocks run in.
// With an additive bias (flash_common.cuh) both kernels add it to the
// scaled scores before the masks, as the forward does, and the dq kernels
// can also write d_bias = p o (dp - delta) (_bwd_dq_kernel: ds before its
// scale), a (BH, T, Tk) float32 array that the caller reduces to the
// bias's shape.  d_bias is not pre-zeroed, so the dq kernels write every
// element of their rows: masked columns and the key tiles they never visit
// (past kv_valid, above the causal diagonal) get 0.  Nor are dk and dv:
// a key tile wholly past kv_valid runs no query tile and writes zeros.
//
// Bound on the H100: operations.  Non-causal, dq does 3 products of
// 2*T*Tk_valid*D operations per head (QK^T, dO V^T, dS K) and dk/dv 4
// (QK^T, dO V^T, P^T dO, dS^T Q), against a few bytes per element of q, k,
// v, dO, dq, dk, dv.  At BERT's shape (BH=384, T=512, D=64, kv_valid
// 384-512) dq is 34.4 GFLOP and dk/dv 45.9:
//   - bf16: 0.035 and 0.046 ms at the 989 TFLOP/s tensor-core rate (dq's
//     just under the 0.036 ms its bytes take);
//   - float32: each product is three TF32 products (below), 0.209 and
//     0.278 ms at the 495 TFLOP/s TF32 rate, above the 0.07 and 0.09 ms
//     of their float32 bytes; on FFMA the same work would take 0.51 and
//     0.69 ms at 67 TFLOP/s.
// In practice the bf16 kernels are held back by their registers and by
// the element-wise work between the products (exp2, the masks, the
// dropout hash): dk/dv (about 0.33 ms there on an H100) needs 167
// registers a thread at D=64 (dk, dv, S^T and dP^T alone are 128), so one
// block of two warpgroups runs per SM and each warpgroup's products wait
// for its own element-wise work; dq (about 0.24 ms) fits in 128 at D<=64
// without a bias (S, dP and dQ are 96), so two blocks share an SM.  ptxas
// (CUDA 12.9): dq 106-179 registers without a bias, 160-236 with one,
// no spill.  The float32 kernels (dq 110-169 registers, dk/dv 112-245, no
// spill) took 0.77 and 1.10 ms of device time at BERT's shape on an H100
// at 700 W, 26% and 25% of their 3xTF32 floor, and 0.24 and 0.28 ms at
// BH=32, T=700, D=128, causal; the FFMA kernels they replace took 1.37 and
// 1.71, and 0.37 and 0.50 ms, in the same calls (torch_flash_ab.py).
//
// dk/dv bf16 design (flash_dkv_tc_kernel):
//   - grid (ceil(Tk/128), BH); 256 threads, two warpgroups of 64 key rows
//     (wgmma's M).  The block's K and V tiles are copied into shared
//     memory once;
//   - Q and dO tiles of 64 queries, with their lse and delta rows, flow
//     through a 2-stage ring in shared memory: the copy of tile j+1
//     (cp.async, zero-filled past T) is issued before tile j is computed.
//     The loop starts at the diagonal tile when causal; a warpgroup skips a
//     tile wholly below its first key, and a warpgroup (or block) wholly
//     past kv_valid computes nothing and writes zeros;
//   - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
//     in shared memory (swizzled, hopper.cuh), 2*D/16 instructions;
//   - P^T = exp(S^T * scale + bias^T - lse), the keep bits and
//     dS^T = P^T o (z/(1-r) dP^T - delta) * scale are computed on the
//     accumulator registers; the query index is the column here, so lse,
//     delta and the keep hash are taken per column (16 a thread); key rows
//     past kv_valid get p = ds = 0;
//   - the bias tile (64 queries x the block's 128 keys, in its own type, a
//     template parameter) is staged with Q/dO into the same ring stage, as
//     the forward stages it (flash_common.cuh: cp.async when its rows
//     start 16-byte aligned), and read from shared memory, one element a
//     register;
//   - dV += (z/(1-r) P^T) dO and dK += dS^T Q: the A operands are the
//     registers rounded to bf16, B = dO or Q read MN-major from the same
//     shared-memory tiles (bf16 wgmma takes the transposed B); dk and dv
//     accumulate in float32 registers and are written once in bf16.
//   The products round P and dS to bf16; the plain version keeps them in
//   float32 (tolerance 2e-2 * max|ref| on the card).
// dq bf16 design (flash_dq_tc_kernel), the forward's orientation: query
// rows own the block, keys are the inner loop, the bias is read [q][k]:
//   - grid (ceil(T/128), BH); 256 threads, two warpgroups of 64 query rows.
//     The block's Q and dO tiles are copied into shared memory once; lse
//     and delta are per query row and live in registers (2 rows a thread,
//     as the accumulator fragment holds them);
//   - K and V tiles of 64 keys, with the bias's (128 queries x 64 keys)
//     tile, flow through a 2-stage cp.async ring (zero-filled past Tk); the
//     copy of tile j+1 is issued before tile j is computed.  The loop stops
//     at ceil(kv_valid/64) and, causal, at the diagonal; a warpgroup
//     computes the prefix of those tiles its own rows need;
//   - S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands in
//     shared memory, K and V read K-major;
//   - P = exp2(S scale log2e + bias log2e - lse log2e), the masks, the keep
//     bits and dS = P o (z/(1-r) dP - delta) * scale on the accumulator
//     registers.  d_bias is written from there in float32, before the bf16
//     rounding and the scale: a quad of lanes holds 8 consecutive keys of
//     a row, so every 32-byte sector is written whole; the key tiles a
//     warpgroup never computes get zeros after the loop;
//   - dQ += dS K: A = dS rounded to bf16 from the registers, B = K read
//     MN-major from the same tile; dq accumulates in float32 registers and
//     is written once in bf16.
// float32 designs (flash_dq_tf32x3_kernel, flash_dkv_tf32x3_kernel), the
// float32 forward's (flash_attention_fwd.cu) carried over: mma.sync.m16n8k8
// TF32 in split precision (flash_common.cuh: every operand x becomes hi =
// rna_tf32(x) and lo = rna_tf32(x - hi), each product a_hi*b_hi +
// a_hi*b_lo + a_lo*b_hi with float32 sums; one TF32 pass would be a
// different result).  mma.sync, not wgmma: the threads load their own
// fragments from padded float32 rows and split them in registers, so
// shared memory holds one float32 copy of each tile and no operand needs a
// transposed copy.
//   - 128 threads, 4 warps of 16 rows: a block owns 64 query rows (dq) or
//     64 key rows (dk/dv), whose two operands (Q and dO; K and V) are
//     copied into shared memory once; the other two flow through a 2-stage
//     cp.async ring (16 bytes a thread, zero-filled past T or Tk) in tiles
//     of 32 rows, 16 at D=128.  The copy of tile j+1 is issued right after
//     the one barrier of tile j, so it runs under tile j's products.  At
//     D=128 a block takes 99 KB (two blocks, 8 warps, share an SM; 32-row
//     tiles would take 132 KB, one block); at D=64 68 KB (three blocks by
//     shared memory; dk/dv's 177 registers a thread allow two).
//   - every tile's rows are D+4 floats apart, and fragments are read one
//     float at a time: along D (the A and B operands of S and dP, element
//     8kk+t or 8kk+t+4 of row g: bank 4g+t) and along the rows (the B
//     operand of dQ, dV and dK, rows 2t and 2t+1, column g: bank 8t+g) both
//     hit 32 distinct banks, so K (dq) and Q, dO (dk/dv), read both ways,
//     need one copy;
//   - the C fragment of S and dP (dq) or S^T and dP^T (dk/dv) is the A
//     fragment of the next product as it stands (flash_common.cuh), so P,
//     the masks, the keep bit and dS are computed on the accumulator
//     registers and feed dQ += dS K, dV += (z/(1-r) P^T) dO and
//     dK += dS^T Q with no shuffle and no shared memory between;
//   - dq: the forward's orientation.  A thread's two query rows keep their
//     lse, delta and dropout key in registers; the loop stops at
//     ceil(kv_valid / tile) and, causal, at the diagonal, and a warp skips
//     the tiles above its own.  d_bias is written from the registers before
//     the scale (a quad of lanes holds 8 consecutive keys of a row: every
//     32-byte sector is written whole), and the key tiles a warp never
//     computes get zeros after the loop;
//   - dk/dv: transposed, the query index is the column: lse and delta of a
//     query tile are staged with it, the keep hash is taken per column,
//     and the loop starts at the diagonal when causal.  A warp holds 16
//     key rows of dK and dV (D floats a thread at D=128, which is why the
//     query tile is 16 there: S^T and dP^T then take 16 registers);
//   - the bias is read from device memory in its own type (a template
//     parameter); the lanes that share a row read 8 consecutive keys, one
//     32-byte sector;
//   - each warp splits every element it reads, as the forward does: a
//     streamed tile's elements 4 times (once a warp), the block's own rows
//     once a tile.  A tile's unrolled body holds 328 splits beside 288
//     HMMA at D=128 in dq (dk/dv: 400 beside 384; 272 and 352 at D=64):
//     at 3 to 5 instructions a split, 21-52% of the instructions at D=64
//     and 128, against 7-10% for the HMMA (chip_smoke.py's build phase
//     reports the mix, f32_mix).  Splitting once at staging (hi and lo in
//     shared memory) would leave only the register-sourced A operands'
//     splits, for one more shared load an operand element, but doubles the
//     tiles: one block (4 warps) a SM at D=128 instead of two, at D=64 one
//     or two instead of three.  Whether that pays is not measured;
//     splitting the block's own rows once (Q and dO in dq, K and V in
//     dk/dv: 128 of dq's 328 splits at D=128) keeps two blocks at D=64 and
//     is the next step.
// Head dims 192 and 256 (Gemma's 16 heads of 256; the reference's gate takes
// any multiple of 64), each kernel as simple as it can be and right:
//   - dK and dV of 64 (bf16) or 16 (float32) key rows at D = 256 are 256
//     float32 registers a thread, past the 255 a thread may have, and dQ
//     with S and dP leaves no room at D = 256 either.  So the grid's z
//     dimension splits the output columns: a bf16 block accumulates at most
//     two 64-column blocks of dQ or of dK and dV (kTcOut: the D = 128
//     instances' register budget; at D = 192 the second block takes the
//     third column block alone), a float32 block half of D (tf_split),
//     and each block recomputes S and dP, which need all D: the
//     recompute costs up to 2x the score products, where accumulating dV
//     and dK in two passes would cost the same and need a second walk.
//     The float32 kernels also copy their streamed tiles by a rolled loop
//     there (copy_rows_f32's kRolled: unrolled, its hoisted addresses
//     spilled dq);
//   - shared memory: the bf16 rings keep two stages where they fit and one
//     at D = 256 (dq's K/V, dk/dv's Q/dO: 263,168 bytes with two, against
//     232,448) and in dk/dv at D = 192 with a float32 bias, so a tile's
//     copy there waits for the products before it; dq reads its bias
//     from device memory above D = 128 (kTcStageBias), one element a
//     register, as the float32 kernels do, and dk/dv stages a float32
//     bias in one stage beside a one-stage ring and reads a 16-bit one
//     from device memory (dkv_stage_bias); the float32 tiles stay
//     (150-200 KB, one block an SM);
//   - the float32 kernels sum each k-step of S and dP apart and add it by
//     FADD (score_products): along D/8 = 24 or 32 k-steps the tensor
//     cores' float32 accumulation put d_bias 5x further from float64
//     than the plain twin.
// Head dims of 320 and more run the runtime-D kernels of
// flash_attention_bwd_dn.cu.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tmx_flash;

namespace hp = tmx_hopper;

// ---------------------------------------------------------------------------
// float32: split-precision TF32 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------
constexpr int kTfWarps = 4;
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfRows = 16 * kTfWarps;  // query (dq) or key rows a block

// The rows of a streamed tile: keys of a K/V tile (dq), queries of a Q/dO
// tile (dk/dv).
template <int D>
__host__ __device__ constexpr int tf_tile() {
  return D >= 128 ? 16 : 32;
}

// The blocks the output columns are split over (grid z) above D = 128:
// dK and dV of 16 key rows are D/2 float32 registers a thread each, 256 at
// D = 256, past the 255 a thread may have, and dQ's D/2 spill beside S and
// dP.  Each block accumulates half of the columns (as many registers as
// at D = 128) and recomputes S and dP, which need all D.
template <int D>
__host__ __device__ constexpr int tf_split() {
  return D > 128 ? 2 : 1;
}

// The block's two operands [64][D+4], 2 stages of the streamed two
// [tile][D+4], float32; dk/dv adds 2 stages of lse and delta [tile].
template <int D, int kKind>
constexpr size_t tf_smem_bytes() {
  return sizeof(float) * ((2 * kTfRows + 4 * tf_tile<D>()) * (D + 4) +
                          (kKind == 1 ? 4 * tf_tile<D>() : 0));
}

// The k-steps [k0, k0 + kSteps) of the two score products of a warp's 16
// rows against a streamed tile's 8 NT rows, both over D: s += A B^T and
// dp += A2 B2^T, A and A2 the warp's rows (g, g + 8), B and B2 the tile's
// (8j + g), every row L floats apart; kApart as mma_3xtf32_sum.
template <int NT, int L, int kSteps, bool kApart>
__device__ __forceinline__ void score_ksteps(
    float (&s)[NT][4], float (&dp)[NT][4], const float* a, const float* b,
    const float* a2, const float* b2, int k0, int g, int t) {
#pragma unroll
  for (int kq = 0; kq < kSteps; ++kq) {
    const int c = 8 * (k0 + kq) + t;  // reduction elements c and c + 4
    uint32_t ah[4], al[4];
    split_frag(a[g * L + c], a[(g + 8) * L + c], a[g * L + c + 4],
               a[(g + 8) * L + c + 4], ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_3xtf32_sum<kApart>(s[j], ah, al, b[(8 * j + g) * L + c],
                             b[(8 * j + g) * L + c + 4]);
    split_frag(a2[g * L + c], a2[(g + 8) * L + c], a2[g * L + c + 4],
               a2[(g + 8) * L + c + 4], ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_3xtf32_sum<kApart>(dp[j], ah, al, b2[(8 * j + g) * L + c],
                             b2[(8 * j + g) * L + c + 4]);
  }
}

// The two score products of the float32 dq and dk/dv kernels (S and dP,
// or their transposes), each a dot product over D.  To D = 128 one
// unrolled walk of the D/8 k-steps, every product accumulated by the
// tensor cores.  Above, along D/8 = 24 or 32 k-steps the tensor cores'
// float32 accumulation (not rounded to nearest) put d_bias 5x further
// from float64 than the plain twin's float32 (1.12e-4 against 2.1e-5 at
// D = 256, torch_flash_8c.py): there each k-step's three products are
// summed apart and added by FADD (mma_3xtf32_sum), and the walk is a loop
// over runs of kWideKsteps k-steps, unrolled inside a run only.  Unrolled
// whole, the partial sums took all 255 registers and spilled up to 180
// bytes; runs of 8 spilled dk/dv at D = 256; runs of 4 spill nothing and
// take the time the accumulation in the tensor cores took.
constexpr int kWideKsteps = 4;

template <int D, int NT, int L>
__device__ __forceinline__ void score_products(
    float (&s)[NT][4], float (&dp)[NT][4], const float* a, const float* b,
    const float* a2, const float* b2, int g, int t) {
  if constexpr (D <= 128) {
    score_ksteps<NT, L, D / 8, false>(s, dp, a, b, a2, b2, 0, g, t);
  } else {
    static_assert((D / 8) % kWideKsteps == 0, "runs must tile D / 8");
#pragma unroll 1
    for (int k0 = 0; k0 < D / 8; k0 += kWideKsteps)
      score_ksteps<NT, L, kWideKsteps, true>(s, dp, a, b, a2, b2, k0, g, t);
  }
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
// Two blocks an SM to D = 128, one above.  Block z of tf_split<D>()
// writes dQ columns [z D/split, (z + 1) D/split); block z = 0 d_bias.
template <int D, typename BT>
__global__ void __launch_bounds__(kTfThreads, D <= 128 ? 2 : 1)
    flash_dq_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, Bias bias,
                           float* __restrict__ d_bias,
                           const int* __restrict__ kv_valid,
                           const int* __restrict__ seed, int tq, int tk,
                           float scale, int causal, uint32_t threshold,
                           float keep_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr bool kBias = kHasBias<BT>;
  constexpr int L = D + 4;          // row stride of every tile, floats
  constexpr int TK = tf_tile<D>();  // keys of a K/V tile
  constexpr int NT = TK / 8;        // 8-key tiles of S; k-steps of dS K
  constexpr int DT = D / 8;         // k-steps of S and dP; 8-column dQ tiles
  constexpr int DO = DT / tf_split<D>();  // the block's 8-column tiles
  // its first (0 to D = 128, known to the compiler: one block a row)
  const int n0 = tf_split<D>() > 1 ? blockIdx.z * DO : 0;
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);  // [64][L]
  float* do_s = q_s + kTfRows * L;                 // [64][L]
  float* k_s = do_s + kTfRows * L;                 // [2][TK][L]
  float* v_s = k_s + 2 * TK * L;                   // [2][TK][L]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int bh = blockIdx.y, q0 = blockIdx.x * kTfRows, qw0 = q0 + 16 * warp;
  const long qoff = static_cast<long>(bh) * tq;
  const long koff = static_cast<long>(bh) * tk;
  const int valid = valid_keys(kv_valid, bh, tk);
  const bool drop = seed != nullptr;
  // the two query rows of this thread's accumulator registers, with their
  // lse, delta and dropout key; a row past T takes lse = +inf (p = 0)
  const int qrow[2] = {qw0 + g, qw0 + g + 8};
  const uint32_t row_key =
      drop ? dropout_row_key(static_cast<uint32_t>(seed[0]), bh) : 0u;
  float lr[2], dl[2];
  uint32_t qkey[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qrow[h] < tq;
    lr[h] = in ? lse[qoff + qrow[h]] : INFINITY;
    dl[h] = in ? delta[qoff + qrow[h]] : 0.f;
    qkey[h] = drop ? dropout_q_key(row_key, qrow[h]) : 0u;
  }
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  // d_bias (block z = 0 only) in pairs of keys (8 bytes) when it can be
  if (n0 != 0) d_bias = nullptr;
  const bool db_pairs = kBias && d_bias != nullptr && tk % 2 == 0 &&
                        (reinterpret_cast<uintptr_t>(d_bias) & 7) == 0;
  const uint32_t k_a = hp::smem_addr(k_s), v_a = hp::smem_addr(v_s);
  auto copy_kv = [&](int kt, int st) {
    copy_rows_f32<D, TK, L, kTfThreads, (D > 128)>(
        k_a + 4 * st * TK * L, k + koff * D, kt * TK, tk, tid);
    copy_rows_f32<D, TK, L, kTfThreads, (D > 128)>(
        v_a + 4 * st * TK * L, v + koff * D, kt * TK, tk, tid);
  };

  // the key tiles of rows below `end`: up to kv_valid, and to the diagonal
  // when causal.  A warp computes a prefix of the block's tiles.
  const int n_valid = (valid + TK - 1) / TK;
  auto tiles_below = [&](int end) {
    return causal ? min(n_valid, (end - 1) / TK + 1) : n_valid;
  };
  const int n_tiles = tiles_below(min(q0 + kTfRows, tq));
  const int n_w = qw0 < tq ? tiles_below(min(qw0 + 16, tq)) : 0;
  if (n_tiles > 0) {
    copy_rows_f32<D, kTfRows, L, kTfThreads>(hp::smem_addr(q_s), q + qoff * D,
                                             q0, tq, tid);
    copy_rows_f32<D, kTfRows, L, kTfThreads>(hp::smem_addr(do_s),
                                             dout + qoff * D, q0, tq, tid);
    copy_kv(0, 0);
  }
  hp::cp_async_commit();

  float acc[DO][4];
#pragma unroll
  for (int n = 0; n < DO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const float* qw = q_s + 16 * warp * L;
  const float* dow = do_s + 16 * warp * L;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TK, st = kt & 1;
    hp::cp_async_wait<0>();
    // tile kt (and Q, dO) is in shared memory, and every warp is done with
    // tile kt - 1, whose stage the next copy overwrites
    __syncthreads();
    if (kt + 1 < n_tiles) copy_kv(kt + 1, st ^ 1);
    hp::cp_async_commit();
    if (kt >= n_w) continue;

    const float* ks = k_s + st * TK * L;
    const float* vs = v_s + st * TK * L;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    // S = Q K^T (A = the warp's Q rows g and g + 8, B = K row 8j + g) and
    // dP = dO V^T
    score_products<D, NT, L>(s, dp, qw, ks, dow, vs, g, t);

    // s <- d_bias = p (z/(1-r) dp - delta); dS is d_bias * scale
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2, kp = k0 + 8 * j + 2 * t + (i & 1);
        const bool ok = kp < valid && (!causal || kp <= qrow[h]);
        float x = s[j][i] * scale;
        if constexpr (kBias)
          x += ok && qrow[h] < tq
                   ? bias_value<BT>(bias.ptr, plane +
                                                  static_cast<long>(qrow[h]) *
                                                      tk +
                                                  kp)
                   : 0.f;
        const float p = ok ? expf(x - lr[h]) : 0.f;
        float gd = dp[j][i];
        if (drop)
          gd = dropout_keep(qkey[h], kp, threshold) ? gd * keep_scale : 0.f;
        s[j][i] = p * (gd - dl[h]);
      }
    // d_bias from the float32 registers: a quad of lanes holds 8
    // consecutive keys of a row, 32 bytes
    if constexpr (kBias) {
      if (d_bias != nullptr) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kp = k0 + 8 * j + 2 * t;
            if (qrow[h] >= tq || kp >= tk) continue;
            float* row = d_bias + (qoff + qrow[h]) * tk;
            if (db_pairs) {
              *reinterpret_cast<float2*>(row + kp) =
                  make_float2(s[j][2 * h], s[j][2 * h + 1]);
            } else {
              row[kp] = s[j][2 * h];
              if (kp + 1 < tk) row[kp + 1] = s[j][2 * h + 1];
            }
          }
        __syncwarp();  // converged again before the warp's mma.sync
      }
    }

    // dQ += dS K: A = dS's registers as they stand (rows g, g + 8; keys
    // 8j + 2t and 8j + 2t + 1 as reduction elements t and t + 4), B = K's
    // rows 8j + 2t and 8j + 2t + 1, column 8n + g
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      split_frag(s[j][0] * scale, s[j][2] * scale, s[j][1] * scale,
                 s[j][3] * scale, ah, al);
      const float* k2 = ks + (8 * j + 2 * t) * L + 8 * n0 + g;
#pragma unroll
      for (int n = 0; n < DO; ++n)
        mma_3xtf32(acc[n], ah, al, k2[8 * n], k2[L + 8 * n]);
    }
  }

  // d_bias of the key tiles the warp never computed (past kv_valid, above
  // the diagonal): zeros, a row at a time over the warp's lanes
  if constexpr (kBias) {
    if (d_bias != nullptr) {
      for (int r = 0; r < 16 && qw0 + r < tq; ++r) {
        float* row = d_bias + (qoff + qw0 + r) * tk;
        for (int c = n_w * TK + lane; c < tk; c += 32) row[c] = 0.f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    float* orow = dq + (qoff + qrow[h]) * D + 8 * n0;
#pragma unroll
    for (int n = 0; n < DO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
// Block z of tf_split<D>() writes dK and dV columns
// [z D/split, (z + 1) D/split).
template <int D, typename BT>
__global__ void __launch_bounds__(kTfThreads, D <= 128 ? 2 : 1)
    flash_dkv_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            Bias bias, const int* __restrict__ kv_valid,
                            const int* __restrict__ seed, int tq, int tk,
                            float scale, int causal, uint32_t threshold,
                            float keep_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr bool kBias = kHasBias<BT>;
  constexpr int L = D + 4;          // row stride of every tile, floats
  constexpr int TQ = tf_tile<D>();  // queries of a Q/dO tile
  constexpr int NT = TQ / 8;        // 8-query tiles of S^T; k-steps of dV, dK
  constexpr int DT = D / 8;         // k-steps of S^T, dP^T; 8-column tiles
  constexpr int DO = DT / tf_split<D>();  // the block's 8-column tiles
  // its first (0 to D = 128, known to the compiler: one block a row)
  const int n0 = tf_split<D>() > 1 ? blockIdx.z * DO : 0;
  extern __shared__ float4 smem_f4[];
  float* k_s = reinterpret_cast<float*>(smem_f4);  // [64][L]
  float* v_s = k_s + kTfRows * L;                  // [64][L]
  float* q_s = v_s + kTfRows * L;                  // [2][TQ][L]
  float* do_s = q_s + 2 * TQ * L;                  // [2][TQ][L]
  float* lse_s = do_s + 2 * TQ * L;                // [2][TQ]
  float* dl_s = lse_s + 2 * TQ;                    // [2][TQ] delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int bh = blockIdx.y, k0 = blockIdx.x * kTfRows, kw0 = k0 + 16 * warp;
  const long qoff = static_cast<long>(bh) * tq;
  const long koff = static_cast<long>(bh) * tk;
  const int valid = valid_keys(kv_valid, bh, tk);
  const bool drop = seed != nullptr;
  // the two key rows of this thread's accumulator registers
  const int krow[2] = {kw0 + g, kw0 + g + 8};
  const uint32_t row_key =
      drop ? dropout_row_key(static_cast<uint32_t>(seed[0]), bh) : 0u;
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  const uint32_t q_a = hp::smem_addr(q_s), do_a = hp::smem_addr(do_s),
                 lse_a = hp::smem_addr(lse_s), dl_a = hp::smem_addr(dl_s);
  // query tile qt's Q, dO, lse and delta into ring stage st
  auto copy_q = [&](int qt, int st) {
    const int r0 = qt * TQ;
    copy_rows_f32<D, TQ, L, kTfThreads, (D > 128)>(
        q_a + 4 * st * TQ * L, q + qoff * D, r0, tq, tid);
    copy_rows_f32<D, TQ, L, kTfThreads, (D > 128)>(
        do_a + 4 * st * TQ * L, dout + qoff * D, r0, tq, tid);
    hp::copy_floats(lse_a + 4 * st * TQ, lse + qoff + r0, TQ, tq - r0, tid);
    hp::copy_floats(dl_a + 4 * st * TQ, delta + qoff + r0, TQ, tq - r0,
                    tid - TQ);
  };

  // a key tile wholly past kv_valid runs no query tile and writes zeros
  const int n_qt = k0 < valid ? (tq + TQ - 1) / TQ : 0;
  const int qt0 = causal ? k0 / TQ : 0;
  if (qt0 < n_qt) {
    copy_rows_f32<D, kTfRows, L, kTfThreads>(hp::smem_addr(k_s), k + koff * D,
                                             k0, tk, tid);
    copy_rows_f32<D, kTfRows, L, kTfThreads>(hp::smem_addr(v_s), v + koff * D,
                                             k0, tk, tid);
    copy_q(qt0, 0);
  }
  hp::cp_async_commit();

  float dk_acc[DO][4], dv_acc[DO][4];
#pragma unroll
  for (int n = 0; n < DO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  const bool keys_in = kw0 < valid;  // the warp holds a valid key
  const float* kw = k_s + 16 * warp * L;
  const float* vw = v_s + 16 * warp * L;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * TQ, st = (qt - qt0) & 1;
    hp::cp_async_wait<0>();
    // tile qt (and K, V) is in shared memory, and every warp is done with
    // tile qt - 1, whose stage the next copy overwrites
    __syncthreads();
    if (qt + 1 < n_qt) copy_q(qt + 1, st ^ 1);
    hp::cp_async_commit();
    if (!keys_in || (causal && q0 + TQ - 1 < kw0)) continue;

    const float* qs = q_s + st * TQ * L;
    const float* dos = do_s + st * TQ * L;
    const float* lrow = lse_s + st * TQ;
    const float* drow = dl_s + st * TQ;
    // transposed scores: key rows, query columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    // S^T = K Q^T (A = the warp's K rows g and g + 8, B = Q row 8j + g)
    // and dP^T = V dO^T
    score_products<D, NT, L>(s, dp, kw, qs, vw, dos, g, t);

    // s <- the dropped p^T, dp <- ds^T = p^T o (z/(1-r) dp^T - delta) scale
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e, qp = q0 + c;
        const float lq = lrow[c], dlq = drow[c];
        const uint32_t qkey = drop ? dropout_q_key(row_key, qp) : 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * h + e, kp = krow[h];
          const bool ok = qp < tq && kp < valid && (!causal || kp <= qp);
          float x = s[j][i] * scale;
          if constexpr (kBias)
            x += ok ? bias_value<BT>(bias.ptr,
                                     plane + static_cast<long>(qp) * tk + kp)
                    : 0.f;
          const float p = ok ? expf(x - lq) : 0.f;
          float pd = p, gd = dp[j][i];
          if (drop) {
            const bool keep = dropout_keep(qkey, kp, threshold);
            pd = keep ? p * keep_scale : 0.f;
            gd = keep ? gd * keep_scale : 0.f;
          }
          s[j][i] = pd;
          dp[j][i] = p * (gd - dlq) * scale;
        }
      }

    // dV += P^T dO and dK += dS^T Q: A = the registers as they stand (key
    // rows g, g + 8; queries 8j + 2t and 8j + 2t + 1 as reduction elements
    // t and t + 4), B = dO's or Q's rows 8j + 2t and 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      const float* o2 = dos + (8 * j + 2 * t) * L + 8 * n0 + g;
      split_frag(s[j][0], s[j][2], s[j][1], s[j][3], ah, al);
#pragma unroll
      for (int n = 0; n < DO; ++n)
        mma_3xtf32(dv_acc[n], ah, al, o2[8 * n], o2[L + 8 * n]);
      const float* q2 = qs + (8 * j + 2 * t) * L + 8 * n0 + g;
      split_frag(dp[j][0], dp[j][2], dp[j][1], dp[j][3], ah, al);
#pragma unroll
      for (int n = 0; n < DO; ++n)
        mma_3xtf32(dk_acc[n], ah, al, q2[8 * n], q2[L + 8 * n]);
    }
  }

  // key rows past kv_valid (or in a tile that ran no query tile) hold 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= tk) continue;
    float* krow_o = dk + (koff + krow[h]) * D + 8 * n0;
    float* vrow_o = dv + (koff + krow[h]) * D + 8 * n0;
#pragma unroll
    for (int n = 0; n < DO; ++n) {
      *reinterpret_cast<float2*>(krow_o + 8 * n + 2 * t) =
          make_float2(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      *reinterpret_cast<float2*>(vrow_o + 8 * n + 2 * t) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv in bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcKeys = 128;    // key rows of a block: 2 warpgroups of 64
constexpr int kTcQ = 64;        // query rows of a Q/dO tile
constexpr int kTcThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // bytes a block may have on an H100
// A staged bias row (one query, 128 keys) is 528 bytes in float32 and 272
// in 16-bit types: a pad after the keys, so that the 8 keys x 4 queries a
// warp reads at once fall in different banks.
constexpr int kBiasRow32 = 528, kBiasRow16 = 272;
constexpr int kBiasStage = kTcQ * kBiasRow32;  // bytes

// The wide head dims (192, 256).  dK and dV (dQ) of a warpgroup's 64 rows
// are D/2 float32 registers a thread each: at most two 64-column blocks
// of them fit beside S and dP (the D = 128 instances' budget), so a block
// accumulates at most kTcOut column blocks and the grid's z dimension
// covers the rest, each block recomputing S and dP (which need all D).
// dq stages its bias in shared memory to D = 128 only (above, the tiles
// leave no room for two stages of it): its wide instances read it from
// device memory (dk/dv: dkv_stage_bias).
template <int D>
constexpr int kTcOut =
    hp::TileShape<D>::kBlocks < 2 ? hp::TileShape<D>::kBlocks : 2;
template <int D>
__host__ __device__ constexpr int tc_split() {
  return (hp::TileShape<D>::kBlocks + kTcOut<D> - 1) / kTcOut<D>;
}
template <int D>
constexpr bool kTcStageBias = D <= 128;

// K and V (128 rows each), St stages of Q and dO (64 rows each), bf16;
// then St stages of lse and delta (64 floats each) and with a staged bias
// (kStaged) St stages of its (64 x 128) tile; 1024 bytes of slack to
// align the tiles to the swizzle atom.
template <int D, bool kStaged, int St>
__host__ __device__ constexpr size_t dkv_tc_bytes() {
  return 1024 + 2 * D * (2 * kTcKeys + 2 * St * kTcQ) + 2 * 4 * St * kTcQ +
         (kStaged ? St * kBiasStage : 0);
}
// Where dk/dv stages its bias (BT, flash_common.cuh): to D = 128 always;
// above, a float32 bias in one stage beside a one-stage ring (231,936
// bytes at D = 256), a 16-bit one read from device memory.  These are
// the choices ptxas compiled without a spill: read from device memory, a
// float32 bias spilled the D = 192 and 256 instances (40-56 bytes);
// staged, a 16-bit one spilled the D = 256 instance (4 bytes).
template <int D, typename BT>
__host__ __device__ constexpr bool dkv_stage_bias() {
  return kHasBias<BT> &&
         (D <= 128 || (sizeof(BT) == 4 && dkv_tc_bytes<D, true, 1>() <=
                                              kMaxSmem));
}
// Two stages of the Q/dO ring where they fit (to D = 128; at D = 192
// unless a float32 bias is staged), else one: the copy of a tile then
// waits for the products of the one before.
template <int D, typename BT>
__host__ __device__ constexpr int dkv_tc_stages() {
  return dkv_tc_bytes<D, dkv_stage_bias<D, BT>(), 2>() <= kMaxSmem ? 2 : 1;
}
template <int D, typename BT>
__host__ __device__ constexpr size_t dkv_tc_smem_bytes() {
  return dkv_tc_bytes<D, dkv_stage_bias<D, BT>(), dkv_tc_stages<D, BT>()>();
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
// Block z writes column blocks [z kTcOut, (z + 1) kTcOut) of dK and dV.
template <int D, typename BT>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, Bias bias,
                        const int* __restrict__ kv_valid,
                        const int* __restrict__ seed, int tq, int tk,
                        float scale, int causal, uint32_t threshold,
                        float keep_scale) {
  using S = hp::TileShape<D>;
  constexpr bool kBias = kHasBias<BT>;
  constexpr bool kStage = dkv_stage_bias<D, BT>();
  constexpr int St = dkv_tc_stages<D, BT>();
  constexpr int kOut = kTcOut<D>;
  constexpr int kKvBytes = kTcKeys * D * 2, kQBytes = kTcQ * D * 2;
  constexpr int kBElt = sizeof(BT);
  constexpr int kBStride = kBElt == 4 ? kBiasRow32 : kBiasRow16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (((hp::smem_addr(smem_raw) + 1023) & ~1023u) -
                              hp::smem_addr(smem_raw));
  const uint32_t k_s = hp::smem_addr(smem);     // [128][D], swizzled
  const uint32_t v_s = k_s + kKvBytes;          // [128][D]
  const uint32_t q_s = v_s + kKvBytes;          // [St][64][D]
  const uint32_t do_s = q_s + St * kQBytes;     // [St][64][D]
  const float* lse_s =                          // [St][64]
      reinterpret_cast<const float*>(smem + 2 * kKvBytes + 2 * St * kQBytes);
  const float* dl_s = lse_s + St * kTcQ;        // [St][64]
  const uint32_t b_s = do_s + St * kQBytes + 2 * 4 * St * kTcQ;  // [St] rows
  const uint8_t* b_g = smem + (b_s - k_s);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTcKeys, kw0 = k0 + 64 * wg;
  // the block's first column block (0 to D = 128, known to the
  // compiler: the unsplit instances' products are those of one block)
  const int b0 = tc_split<D>() > 1 ? blockIdx.z * kOut : 0;
  const long qoff = static_cast<long>(bh) * tq;
  const long koff = static_cast<long>(bh) * tk;
  const int valid = valid_keys(kv_valid, bh, tk);
  // the two key rows of this thread's accumulator registers
  const int krow[2] = {kw0 + 16 * ((tid % 128) / 32) + lane / 4,
                       kw0 + 16 * ((tid % 128) / 32) + lane / 4 + 8};
  const uint32_t row_key =
      seed != nullptr ? dropout_row_key(static_cast<uint32_t>(seed[0]), bh)
                      : 0u;
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  const bool b_chunks = kStage && bias_rows_aligned<BT>(bias, tk);

  // a key tile wholly past kv_valid runs no Q tile and writes zeros
  const int n_qt = k0 < valid ? (tq + kTcQ - 1) / kTcQ : 0;
  const int qt0 = causal ? k0 / kTcQ : 0;
  auto copy_q = [&](int qt, int st) {
    hp::copy_tile<D, kTcQ, kTcThreads>(q_s + st * kQBytes, q + qoff * D,
                                       qt * kTcQ, tq, tid);
    hp::copy_tile<D, kTcQ, kTcThreads>(do_s + st * kQBytes, dout + qoff * D,
                                       qt * kTcQ, tq, tid);
    const uint32_t rows = hp::smem_addr(lse_s + st * kTcQ);
    hp::copy_floats(rows, lse + qoff + qt * kTcQ, kTcQ, tq - qt * kTcQ, tid);
    hp::copy_floats(rows + 4 * St * kTcQ, delta + qoff + qt * kTcQ, kTcQ,
                    tq - qt * kTcQ, tid - kTcQ);
    if constexpr (kStage)  // bias[q][k] of these queries and the block's keys
      stage_bias_async<kTcQ, kTcKeys, kTcThreads, BT>(
          b_s + st * kBiasStage, kBStride, bias, plane, qt * kTcQ, k0, tq, tk,
          b_chunks, tid);
  };
  if (qt0 < n_qt) {
    hp::copy_tile<D, kTcKeys, kTcThreads>(k_s, k + koff * D, k0, tk, tid);
    hp::copy_tile<D, kTcKeys, kTcThreads>(v_s, v + koff * D, k0, tk, tid);
    copy_q(qt0, 0);
  }
  hp::cp_async_commit();

  float dk_acc[kOut][S::kCols / 2], dv_acc[kOut][S::kCols / 2];
#pragma unroll
  for (int b = 0; b < kOut; ++b)
#pragma unroll
    for (int i = 0; i < S::kCols / 2; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;
  const bool keys_in = kw0 < valid;  // the warpgroup holds a valid key

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTcQ, st = St == 2 ? (qt - qt0) & 1 : 0;
    if constexpr (St == 2) {
      if (qt + 1 < n_qt) {  // the next tile's copy, into the other stage
        copy_q(qt + 1, st ^ 1);
        hp::cp_async_commit();
        hp::cp_async_wait<1>();
      } else {
        hp::cp_async_wait<0>();
      }
    } else {
      if (qt > qt0) {  // the one stage is free: the loop's last barrier
        copy_q(qt, 0);
        hp::cp_async_commit();
      }
      hp::cp_async_wait<0>();
    }
    hp::fence_async_smem();
    __syncthreads();  // tile qt (and K, V) is in shared memory

    if (keys_in && (!causal || q0 + kTcQ - 1 >= kw0)) {
      const uint32_t qst = q_s + st * kQBytes, dost = do_s + st * kQBytes;
      // transposed scores: key rows, query columns
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss(s, hp::desc_k_major<D, kTcKeys>(k_s, 64 * wg, kk),
                         hp::desc_k_major<D, kTcQ>(qst, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss(dp, hp::desc_k_major<D, kTcKeys>(v_s, 64 * wg, kk),
                         hp::desc_k_major<D, kTcQ>(dost, 0, kk), kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait();
      hp::fence_regs(s);
      hp::fence_regs(dp);

      const float* lrow = lse_s + st * kTcQ;
      const float* drow = dl_s + st * kTcQ;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + e, qp = q0 + c;
          const float lse2 = lrow[c] * kLog2e, dl = drow[c];
          const uint32_t qkey =
              seed != nullptr ? dropout_q_key(row_key, qp) : 0u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e, kp = krow[h];
            const bool ok =
                qp < tq && kp < valid && (!causal || kp <= qp);
            float x = s[i] * scale;
            if constexpr (kStage)
              x += lds_bias<BT>(b_g + st * kBiasStage + c * kBStride +
                                (kp - k0) * kBElt);
            else if constexpr (kBias)
              x += ok ? bias_value<BT>(bias.ptr,
                                       plane + static_cast<long>(qp) * tk + kp)
                      : 0.f;
            const float p = ok ? exp2f(fmaf(x, kLog2e, -lse2)) : 0.f;
            float pd = p, g = dp[i];
            if (seed != nullptr) {
              const bool keep = dropout_keep(qkey, kp, threshold);
              pd = keep ? p * keep_scale : 0.f;
              g = keep ? g * keep_scale : 0.f;
            }
            s[i] = pd;                         // dropped p^T
            dp[i] = p * (g - dl) * scale;      // ds^T
          }
        }

      // dV += P^T dO and dK += dS^T Q: A from registers (bf16), B = dO or Q
      // read MN-major from shared memory (the block's column blocks).  Both
      // A operands are built before the products: an in-flight product's
      // registers are not rewritten.
      uint32_t ap[kTcQ / 16][4], ad[kTcQ / 16][4];
#pragma unroll
      for (int j = 0; j < kTcQ / 16; ++j) {
        hp::to_a_frag(s, j, ap[j]);
        hp::to_a_frag(dp, j, ad[j]);
      }
#pragma unroll
      for (int b = 0; b < kOut; ++b) {
        hp::fence_regs(dv_acc[b]);
        hp::fence_regs(dk_acc[b]);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcQ / 16; ++j)
#pragma unroll
        for (int b = 0; b < kOut; ++b) {
          if (b0 + b >= S::kBlocks) break;  // the last block's short split
          hp::wgmma_rs(dv_acc[b], ap[j],
                       hp::desc_mn_major<D, kTcQ>(dost, b0 + b, j));
          hp::wgmma_rs(dk_acc[b], ad[j],
                       hp::desc_mn_major<D, kTcQ>(qst, b0 + b, j));
        }
      hp::wgmma_commit();
      hp::wgmma_wait();
#pragma unroll
      for (int b = 0; b < kOut; ++b) {
        hp::fence_regs(dv_acc[b]);
        hp::fence_regs(dk_acc[b]);
      }
    }
    __syncthreads();  // the stage is free for the copy of a later tile
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= tk) continue;
    __nv_bfloat16* krow_o = dk + (koff + krow[h]) * D;
    __nv_bfloat16* vrow_o = dv + (koff + krow[h]) * D;
#pragma unroll
    for (int b = 0; b < kOut; ++b) {
      if (b0 + b >= S::kBlocks) break;
#pragma unroll
      for (int i = 0; i < S::kCols / 2; i += 4) {
        const int c = (b0 + b) * S::kCols + 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(krow_o + c) =
            hp::pack_bf16(dk_acc[b][i + 2 * h], dk_acc[b][i + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(vrow_o + c) =
            hp::pack_bf16(dv_acc[b][i + 2 * h], dv_acc[b][i + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq in bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kDqRows = 128;  // query rows of a block: 2 warpgroups of 64
constexpr int kDqKeys = 64;   // keys of a K/V tile
// A staged bias row holds 72 elements: 64 keys and a pad, so that the 8
// rows a warp reads at once fall in different banks (as in the forward).
constexpr int kDqBiasLd = 72;
constexpr int kDqBiasStage = kDqRows * kDqBiasLd * 4;  // bytes

// Q and dO (128 rows each), St stages of K and V (64 rows each), bf16;
// then with a staged bias St stages of its (128 x 64) tile; 1024 bytes of
// slack to align the tiles to the swizzle atom.
template <int D, bool kBias, int St>
__host__ __device__ constexpr size_t dq_tc_bytes() {
  return 1024 + 2 * D * (2 * kDqRows + 2 * St * kDqKeys) +
         (kBias && kTcStageBias<D> ? St * kDqBiasStage : 0);
}
// Two stages of the K/V ring where they fit (every D but 256), else one.
template <int D, bool kBias>
__host__ __device__ constexpr int dq_tc_stages() {
  return dq_tc_bytes<D, kBias, 2>() <= kMaxSmem ? 2 : 1;
}
template <int D, bool kBias>
__host__ __device__ constexpr size_t dq_tc_smem_bytes() {
  return dq_tc_bytes<D, kBias, dq_tc_stages<D, kBias>()>();
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
// Two blocks a SM where they fit, D <= 64 without a bias (128 registers a
// thread, no spill; 66.5 KB of shared memory): one block's products then
// run under the other's element-wise work, 0.238 against 0.348 ms of
// device time at BERT's shape on an H100 (torch_flash_ab.py).  Block z
// writes column blocks [z kTcOut, (z + 1) kTcOut) of dQ; block z = 0
// writes d_bias.
template <int D, typename BT>
__global__ void __launch_bounds__(kTcThreads,
                                  D <= 64 && !kHasBias<BT> ? 2 : 1)
    flash_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, Bias bias,
                       float* __restrict__ d_bias,
                       const int* __restrict__ kv_valid,
                       const int* __restrict__ seed, int tq, int tk,
                       float scale, int causal, uint32_t threshold,
                       float keep_scale) {
  using S = hp::TileShape<D>;
  constexpr bool kBias = kHasBias<BT>;
  constexpr bool kStage = kBias && kTcStageBias<D>;
  constexpr int St = dq_tc_stages<D, kBias>();
  constexpr int kOut = kTcOut<D>;
  constexpr int kQBytes = kDqRows * D * 2, kKvBytes = kDqKeys * D * 2;
  constexpr int kBElt = sizeof(BT), kBStride = kDqBiasLd * kBElt;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (hp::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kQBytes;       // [128][D], swizzled, as q_s
  const uint32_t k_s = do_s + kQBytes;       // [St][64][D], swizzled
  const uint32_t v_s = k_s + St * kKvBytes;  // [St][64][D], swizzled
  const uint32_t b_s = v_s + St * kKvBytes;  // [St][128][kDqBiasLd] bias
  const uint8_t* b_g = smem_raw + (b_s - hp::smem_addr(smem_raw));

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kDqRows, qw0 = q0 + 64 * wg;
  // the block's first column block (0 to D = 128, known to the
  // compiler: the unsplit instances' products are those of one block)
  const int b0 = tc_split<D>() > 1 ? blockIdx.z * kOut : 0;
  const long qoff = static_cast<long>(bh) * tq;
  const long koff = static_cast<long>(bh) * tk;
  const int valid = valid_keys(kv_valid, bh, tk);
  // the two query rows of this thread's accumulator registers, with their
  // lse (in log2 units), delta and dropout key.  A row past T, or one that
  // the forward masked whole (lse -1e30), takes lse = +inf: p = exp2(-inf)
  // = 0 there, and so is ds, with no exp2 of a garbage -lse.
  const int qrow[2] = {qw0 + 16 * ((tid % 128) / 32) + lane / 4,
                       qw0 + 16 * ((tid % 128) / 32) + lane / 4 + 8};
  const bool drop = seed != nullptr;
  const uint32_t row_key =
      drop ? dropout_row_key(static_cast<uint32_t>(seed[0]), bh) : 0u;
  float lse2[2], dl[2];
  uint32_t qkey[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qrow[h] < tq;
    const float l = in ? lse[qoff + qrow[h]] : kNegInf;
    lse2[h] = l > kNegInf ? l * kLog2e : INFINITY;
    dl[h] = in ? delta[qoff + qrow[h]] : 0.f;
    qkey[h] = drop ? dropout_q_key(row_key, qrow[h]) : 0u;
  }
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  const bool b_chunks = kStage && bias_rows_aligned<BT>(bias, tk);
  // d_bias (written by block z = 0 only) in pairs of keys (8 bytes) when
  // its rows allow
  float* const db = b0 == 0 ? d_bias : nullptr;
  const bool db_pairs = kBias && db != nullptr && tk % 2 == 0 &&
                        (reinterpret_cast<uintptr_t>(db) & 7) == 0;
  // tile kt's K, V and (staged) bias into ring stage st
  auto copy_kv = [&](int kt, int st) {
    hp::copy_tile<D, kDqKeys, kTcThreads>(k_s + st * kKvBytes, k + koff * D,
                                          kt * kDqKeys, tk, tid);
    hp::copy_tile<D, kDqKeys, kTcThreads>(v_s + st * kKvBytes, v + koff * D,
                                          kt * kDqKeys, tk, tid);
    if constexpr (kStage)
      stage_bias_async<kDqRows, kDqKeys, kTcThreads, BT>(
          b_s + st * kDqBiasStage, kBStride, bias, plane, q0, kt * kDqKeys,
          tq, tk, b_chunks, tid);
  };

  // the key tiles of rows below `end`: up to kv_valid, and to the diagonal
  // when causal.  A warpgroup computes a prefix of the block's tiles.
  const int n_valid = (valid + kDqKeys - 1) / kDqKeys;
  auto tiles_below = [&](int end) {
    return causal ? min(n_valid, (end - 1) / kDqKeys + 1) : n_valid;
  };
  const int n_tiles = tiles_below(min(q0 + kDqRows, tq));
  const int n_wg = qw0 < tq ? tiles_below(min(qw0 + 64, tq)) : 0;
  if (n_tiles > 0) {
    hp::copy_tile<D, kDqRows, kTcThreads>(q_s, q + qoff * D, q0, tq, tid);
    hp::copy_tile<D, kDqRows, kTcThreads>(do_s, dout + qoff * D, q0, tq,
                                          tid);
    copy_kv(0, 0);
  }
  hp::cp_async_commit();

  float acc[kOut][S::kCols / 2];
#pragma unroll
  for (int b = 0; b < kOut; ++b)
#pragma unroll
    for (int i = 0; i < S::kCols / 2; ++i) acc[b][i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kDqKeys, st = St == 2 ? kt & 1 : 0;
    const uint32_t kst = k_s + st * kKvBytes, vst = v_s + st * kKvBytes;
    if constexpr (St == 2) {
      if (kt + 1 < n_tiles) {  // the next tile's copy, into the other stage
        copy_kv(kt + 1, st ^ 1);
        hp::cp_async_commit();
        hp::cp_async_wait<1>();
      } else {
        hp::cp_async_wait<0>();
      }
    } else {
      if (kt > 0) {  // the one stage is free: the loop's last barrier
        copy_kv(kt, 0);
        hp::cp_async_commit();
      }
      hp::cp_async_wait<0>();
    }
    hp::fence_async_smem();
    __syncthreads();  // tile kt (and Q, dO) is in shared memory

    if (kt < n_wg) {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss(s, hp::desc_k_major<D, kDqRows>(q_s, 64 * wg, kk),
                         hp::desc_k_major<D, kDqKeys>(kst, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss(dp, hp::desc_k_major<D, kDqRows>(do_s, 64 * wg, kk),
                         hp::desc_k_major<D, kDqKeys>(vst, 0, kk), kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait();
      hp::fence_regs(s);
      hp::fence_regs(dp);

      // s <- d_bias = p (z/(1-r) dp - delta), dp <- ds = d_bias * scale
      float2 bv = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const bool ok = kp < valid && (!causal || kp <= qrow[h]);
        float x = s[i] * scale;
        if constexpr (kStage) {
          if (i % 2 == 0)  // the pair of keys (kp, kp + 1) of row qrow[h]
            bv = lds_bias2<BT>(b_g + st * kDqBiasStage +
                               ((qrow[h] - q0) * kDqBiasLd + kp - k0) * kBElt);
          x += i % 2 ? bv.y : bv.x;
        } else if constexpr (kBias) {
          x += ok && qrow[h] < tq
                   ? bias_value<BT>(bias.ptr,
                                    plane + static_cast<long>(qrow[h]) * tk +
                                        kp)
                   : 0.f;
        }
        const float p = ok ? exp2f(fmaf(x, kLog2e, -lse2[h])) : 0.f;
        float g = dp[i];
        if (drop)
          g = dropout_keep(qkey[h], kp, threshold) ? g * keep_scale : 0.f;
        s[i] = p * (g - dl[h]);
        dp[i] = s[i] * scale;
      }
      // d_bias from the float32 registers: a quad of lanes holds 8
      // consecutive keys of a row, 32 bytes
      if constexpr (kBias) {
        if (db != nullptr) {
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int h = (i / 2) % 2;
            const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4);
            if (qrow[h] >= tq || kp >= tk) continue;
            float* row = db + (qoff + qrow[h]) * tk;
            if (db_pairs) {
              *reinterpret_cast<float2*>(row + kp) =
                  make_float2(s[i], s[i + 1]);
            } else {
              row[kp] = s[i];
              if (kp + 1 < tk) row[kp + 1] = s[i + 1];
            }
          }
          __syncwarp();  // converged again before the warpgroup's wgmma
        }
      }

      // dQ += dS K: A = dS from registers (bf16), B = K read MN-major from
      // the same shared-memory tile (the block's column blocks)
      uint32_t a[kDqKeys / 16][4];
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j) hp::to_a_frag(dp, j, a[j]);
#pragma unroll
      for (int b = 0; b < kOut; ++b) hp::fence_regs(acc[b]);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j)
#pragma unroll
        for (int b = 0; b < kOut; ++b) {
          if (b0 + b >= S::kBlocks) break;  // the last block's short split
          hp::wgmma_rs(acc[b], a[j],
                       hp::desc_mn_major<D, kDqKeys>(kst, b0 + b, j));
        }
      hp::wgmma_commit();
      hp::wgmma_wait();
#pragma unroll
      for (int b = 0; b < kOut; ++b) hp::fence_regs(acc[b]);
    }
    __syncthreads();  // the stage is free for the copy of a later tile
  }

  // d_bias of the key tiles the warpgroup never computed (past kv_valid,
  // above the diagonal): zeros, a warp a row
  if constexpr (kBias) {
    if (db != nullptr && qw0 < tq) {
      const int nr = min(64, tq - qw0), warp = (tid % 128) / 32;
      for (int r = warp; r < nr; r += 4) {
        float* row = db + (qoff + qw0 + r) * tk;
        for (int c = n_wg * kDqKeys + lane; c < tk; c += 32) row[c] = 0.f;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    __nv_bfloat16* row = dq + (qoff + qrow[h]) * D;
#pragma unroll
    for (int b = 0; b < kOut; ++b) {
      if (b0 + b >= S::kBlocks) break;
#pragma unroll
      for (int i = 0; i < S::kCols / 2; i += 4) {
        const int c = (b0 + b) * S::kCols + 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(row + c) =
            hp::pack_bf16(acc[b][i + 2 * h], acc[b][i + 2 * h + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Bias bias;
  float* d_bias;
  const int *kv_valid, *seed;
  int bh, tq, tk;
  float scale;
  int causal;
  uint32_t threshold;
  float keep_scale;
  cudaStream_t stream;
};

template <int D, typename BT>
cudaError_t launch_dq_tc(const Args& a) {
  const size_t smem = dq_tc_smem_bytes<D, kHasBias<BT>>();
  auto kernel = flash_dq_tc_kernel<D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tq + kDqRows - 1) / kDqRows, a.bh, tc_split<D>()),
           kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dq), a.bias, a.d_bias, a.kv_valid,
      a.seed, a.tq, a.tk, a.scale, a.causal, a.threshold, a.keep_scale);
  return cudaGetLastError();
}

template <int D, typename BT>
cudaError_t launch_dkv_tc(const Args& a) {
  const size_t smem = dkv_tc_smem_bytes<D, BT>();
  auto kernel = flash_dkv_tc_kernel<D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tk + kTcKeys - 1) / kTcKeys, a.bh, tc_split<D>()),
           kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.bias, a.kv_valid, a.seed, a.tq, a.tk, a.scale, a.causal, a.threshold,
      a.keep_scale);
  return cudaGetLastError();
}

template <int kKind, int D, typename BT>
cudaError_t launch_tf32x3(const Args& a) {
  const size_t smem = tf_smem_bytes<D, kKind>();
  if constexpr (kKind == 0) {
    auto kernel = flash_dq_tf32x3_kernel<D, BT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.tq + kTfRows - 1) / kTfRows, a.bh, tf_split<D>()),
             kTfThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dq), a.bias, a.d_bias,
        a.kv_valid, a.seed, a.tq, a.tk, a.scale, a.causal, a.threshold,
        a.keep_scale);
  } else {
    auto kernel = flash_dkv_tf32x3_kernel<D, BT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.tk + kTfRows - 1) / kTfRows, a.bh, tf_split<D>()),
             kTfThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.bias, a.kv_valid, a.seed, a.tq, a.tk, a.scale, a.causal,
        a.threshold, a.keep_scale);
  }
  return cudaGetLastError();
}

// kKind: 0 dq, 1 dk/dv; kF32: the float32 3xTF32 kernels, else the bf16
// tensor-core ones.  Both take the bias type as a template parameter.
template <bool kF32, int kKind, typename BT, int D>
cudaError_t launch(const Args& a) {
  if constexpr (kF32) return launch_tf32x3<kKind, D, BT>(a);
  else if constexpr (kKind == 0) return launch_dq_tc<D, BT>(a);
  else return launch_dkv_tc<D, BT>(a);
}

template <bool kF32, int kKind, typename BT>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
#ifdef TMX_HEAD_DIM  // a unit of one head dim (flash_attention_bwd_d*.cu)
    case TMX_HEAD_DIM: return launch<kF32, kKind, BT, TMX_HEAD_DIM>(a);
#else
    case 16: return launch<kF32, kKind, BT, 16>(a);
    case 32: return launch<kF32, kKind, BT, 32>(a);
    case 64: return launch<kF32, kKind, BT, 64>(a);
#endif
    default: return cudaErrorInvalidValue;
  }
}

template <bool kF32, int kKind>
cudaError_t dispatch(int d, const Args& a) {
  if (a.bias.ptr == nullptr) return dispatch_d<kF32, kKind, NoBias>(d, a);
  if (a.bias.dtype == 1)
    return dispatch_d<kF32, kKind, __nv_bfloat16>(d, a);
  if (a.bias.dtype == 2) return dispatch_d<kF32, kKind, __half>(d, a);
  return dispatch_d<kF32, kKind, float>(d, a);
}
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// float32 runs the 3xTF32 kernel, bfloat16 the wgmma one (q, k, v, dout
// and the outputs 16-byte aligned in both); *route is set to the kernel
// launched.
template <int kKind>
int run(const Args& a, int d, int dtype, const void* out0, const void* out1,
        int* route) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.bh > 65535)
    return cudaErrorInvalidValue;
  if (a.bias.ptr != nullptr &&
      (a.bias.planes < 1 || a.bh % a.bias.planes != 0 || a.bias.dtype < 0 ||
       a.bias.dtype > 2))
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.dout) || !aligned16(out0) || !aligned16(out1))
    return cudaErrorInvalidValue;
  *route = dtype == 0 ? 2 : 1;
  return dtype == 0 ? dispatch<true, kKind>(d, a)
                    : dispatch<false, kKind>(d, a);
}

}  // namespace

// dtype: 0 float32 (the 3xTF32 kernels), 1 bfloat16 (the wgmma kernels);
// q, k, v, dout and the outputs 16-byte aligned.  *route is set to the
// kernel launched: 1 wgmma, 2 3xTF32 (left as it is when nothing is
// launched; 0 is reserved).  kv_valid, seed and
// bias may be null (no key-padding mask; no dropout; no bias).  lse and
// delta are float32 (BH, T).  bias is (bias_planes, tq, tk) of bias_dtype
// (0 float32, 1 bfloat16, 2 float16); row bh reads plane bh % bias_planes.  d_bias, float32 (BH, tq, tk), may
// be null when there is a bias and its gradient is not wanted.
extern "C" int tmx_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const void* bias,
    int bias_planes, int bias_dtype, float* d_bias, const int* kv_valid,
    const int* seed, int bh, int tq, int tk, int d, float scale, int causal,
    uint32_t threshold, float keep_scale, int dtype, void* stream,
    int* route) {
  Args a{q,         k,          v,       dout,
         lse,       delta,      dq,      nullptr,
         nullptr,   {bias, bias_planes, bias_dtype},
         d_bias,    kv_valid,   seed,    bh,
         tq,        tk,         scale,   causal,
         threshold, keep_scale, static_cast<cudaStream_t>(stream)};
  return run<0>(a, d, dtype, dq, dq, route);
}

extern "C" int tmx_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const void* bias, int bias_planes, int bias_dtype, const int* kv_valid,
    const int* seed, int bh, int tq, int tk, int d, float scale, int causal,
    uint32_t threshold, float keep_scale, int dtype, void* stream,
    int* route) {
  Args a{q,         k,          v,       dout,
         lse,       delta,      nullptr, dk,
         dv,        {bias, bias_planes, bias_dtype},
         nullptr,   kv_valid,   seed,    bh,
         tq,        tk,         scale,   causal,
         threshold, keep_scale, static_cast<cudaStream_t>(stream)};
  return run<1>(a, d, dtype, dk, dv, route);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
