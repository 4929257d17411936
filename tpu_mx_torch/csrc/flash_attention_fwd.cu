// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma), float32 on FFMA.
//
// Replaces the forward Pallas TPU kernel tpu_mx/kernels/flash_attention.py::
// _fwd_kernel (launched by _fwd): O = softmax(q k^T * scale [masks]) v over
// (BH, T, D) tensors, blockwise with an online softmax, plus the per-row
// logsumexp that the backward kernels (flash_attention_bwd.cu) read.
// Options, as in the reference:
//   - causal: query row i sees key columns j <= i (_score_mask);
//   - kv_valid (BH,) int32: key columns >= kv_valid[bh] are masked and the
//     K-tile loop stops at ceil(valid / 64), as _run_cond skips whole
//     blocks;
//   - dropout: the keep mask of flash_common.cuh, drawn element by element
//     from (seed, bh, q, k).  The normalizer l sums the un-dropped
//     probabilities; kept ones are scaled by 1/(1-rate) before they
//     multiply V (_block_attn / _fwd_kernel).
//   - bias: an additive (planes, T, Tk) bias (flash_common.cuh), added to
//     the scaled scores before the masks (_fwd_kernel: s * scale + bias).
// Statistics stay float32; O is written in q's type, lse in float32.  The
// running max starts at the finite kNegInf; masked scores are kNegInf, or
// -inf under a bias (a bias can push real scores to kNegInf), so a row with
// no finite score gets out = 0 and lse = -1e30.  Any T is taken: rows past
// T or Tk are masked (zero-filled on load, never written).
//
// Bound on the H100.  Attention does 4*T*Tk*D*BH floating-point operations
// (QK^T and PV; about half under a causal mask) against 2*(2*T + 2*Tk)*D*BH
// bytes of bf16 q, k, v and o: T operations per byte at T = Tk.  At BERT's
// shape (BH=384, T=512, D=64, kv_valid 384-512) that is 22.5 GFLOP and
// 100 MB: 0.023 ms at the 989 TFLOP/s bf16 tensor-core rate, 0.030 ms of
// device memory, so the call is bound by bytes at the roofline; at the
// float32 FFMA rate (67 TFLOP/s) the same work takes 0.34 ms.  In practice
// the per-element work on the scores bounds it: exp2, the masks and, with
// dropout, the integer hash of every (q, k) (on an H100 at that shape the
// kernel takes about 0.11 ms without dropout and 0.16 ms with it).  A bias
// adds planes*T*Tk elements read once (a float32 plane per row is 402.7 MB
// at BERT's shape).
//
// bf16 design (flash_fwd_tc_kernel):
//   - grid (ceil(T/128), BH); 256 threads, two warpgroups of 64 query rows
//     (wgmma's M).  Q is copied into shared memory once;
//   - K and V tiles of 64 keys flow through a 2-stage ring in shared memory:
//     the copy of tile j+1 (cp.async, 16 bytes a thread, zero-filled past
//     Tk) is issued before tile j is computed, so its latency hides behind
//     tile j's products.  Tiles are stored in the swizzled layout wgmma
//     reads (hopper.cuh); tiles wholly past kv_valid or above the causal
//     diagonal of the block are never copied, and a warpgroup skips a tile
//     above its own diagonal;
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory,
//     D/16 instructions into 32 float32 registers a thread;
//   - the online softmax runs on those registers: the accumulator layout
//     (hopper.cuh) gives each register its (row, key); the 4 threads of a
//     quad share a row, so the row max and row sum take two
//     __shfl_xor_sync each.  Masks, the dropout hash and the bias are
//     applied per register;
//   - the bias tile (128 rows x 64 keys, in its own type, a template
//     parameter) is staged with K/V into the same ring stage: cp.async in
//     16-byte chunks when its rows start 16-byte aligned (Tk * element
//     size a multiple of 16), else element by element by the threads.
//     Rows hold 72 elements, so the pairs of keys a warp reads for its 8
//     rows hit distinct banks;
//   - P (after the dropout scale) is rounded to bf16 in registers and is
//     the A operand of O += P V (register-sourced wgmma, V read MN-major
//     from shared memory); O stays in float32 registers, rescaled by
//     exp(m_old - m_new) before each tile, and is written once in bf16.
//   The products round only P to bf16 (q, k, v are bf16 already); the
//   plain version keeps P in float32, so outputs differ by about one bf16
//   rounding of P (tolerance 2e-2 * max|ref| on the card).
// float32 design (flash_fwd_kernel), kept exact to float32 rounding for the
// serving prefill, whose gates are logits within 2e-4 of the CPU with TF32
// off (tensor cores would round its operands):
//   - grid (ceil(T/64), BH); 256 threads own a 64-row query tile and loop
//     over 64-row K/V tiles; Q, K and V are staged in shared memory as
//     float32 (rows padded to D+1 floats so the 16 columns a warp reads
//     fall in 16 banks); each thread computes a 4x4 block of scores and a
//     4 x D/16 block of the output with FFMA;
//   - the running (m, l) of each row live in shared memory, the output
//     accumulator in registers; the bias tile is staged into the score
//     tile with the K/V tile.
// The C entry point sends bfloat16 to the tensor-core kernel and float32 to
// the FFMA kernel, and reports which through *route; nothing else falls
// back.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tmx_flash;

constexpr int kPs = kBk + 1;  // padded probability-row stride

// kDrop: dropout on (seed != null); kBias: a bias (bias.ptr != null).
// Template parameters, so the serving prefill's instance carries neither.
template <int D, bool kDrop, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_valid,
                     const int* __restrict__ seed, Bias bias, int tq, int tk,
                     float scale, int causal, uint32_t threshold,
                     float keep_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = D + 1;     // padded q/k row stride
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // [kBq][QS]
  float* k_s = q_s + kBq * QS;     // [kBk][QS]
  float* v_s = k_s + kBk * QS;     // [kBk][D]
  float* p_s = v_s + kBk * D;      // [kBq][kPs] scores, then probs
  float* m_s = p_s + kBq * kPs;    // [kBq] running max
  float* l_s = m_s + kBq;          // [kBq] running denominator
  float* a_s = l_s + kBq;          // [kBq] this tile's rescale

  const int bh = blockIdx.y, q0 = blockIdx.x * kBq, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float* qb = q + static_cast<long>(bh) * tq * D;
  const float* kb = k + static_cast<long>(bh) * tk * D;
  const float* vb = v + static_cast<long>(bh) * tk * D;
  const int valid = valid_keys(kv_valid, bh, tk);
  // the softmax lanes: 4 neighbouring threads share one query row
  const int srow = tid / 4, part = tid % 4;
  const uint32_t qkey =
      kDrop ? dropout_q_key(
                  dropout_row_key(static_cast<uint32_t>(seed[0]), bh),
                  q0 + srow)
            : 0u;

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r * QS + d] =
        q0 + r < tq ? qb[static_cast<long>(q0 + r) * D + d] : 0.f;
  }
  if (tid < kBq) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int n_tiles = (valid + kBk - 1) / kBk;
  if (causal) n_tiles = min(n_tiles, (q0 + kBq - 1) / kBk + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the previous tile's readers are done
    stage_rows2<D, kBk>(k_s, QS, kb, v_s, D, vb, k0, tk);
    if (kBias) stage_bias<false>(p_s, kPs, bias, bh, q0, k0, tq, tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = kpos < valid && (!causal || kpos <= q0 + r);
        if (kBias)
          p_s[r * kPs + c] = ok ? s[i][j] * scale + p_s[r * kPs + c]
                                : -INFINITY;
        else
          p_s[r * kPs + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax over row srow.  m starts at the finite kNegInf, so
       // m_new is finite and masked scores get p = 0 exactly: -inf ones
       // always; kNegInf ones (no bias) because every row's m is far above
       // kNegInf from the first tile on, which holds key 0 (kv_valid >= 1).
      float* prow = p_s + srow * kPs;
      float mx = kNegInf;
      for (int j = 0; j < kBk / 4; ++j) mx = fmaxf(mx, prow[part + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[srow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < kBk / 4; ++j) {
        const int c = part + 4 * j;
        const float p = expf(prow[c] - m_new);
        sum += p;  // the normalizer uses the un-dropped probability
        if (kDrop)
          prow[c] = dropout_keep(qkey, k0 + c, threshold) ? p * keep_scale
                                                          : 0.f;
        else
          prow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[srow] = alpha;
        l_s[srow] = l_s[srow] * alpha + sum;
        m_s[srow] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
    for (int kk = 0; kk < kBk; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = v_s[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < tq) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      float* orow = o + (static_cast<long>(bh) * tq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
    }
  }
  if (tid < kBq && q0 + tid < tq)
    lse[static_cast<long>(bh) * tq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace hp = tmx_hopper;

constexpr int kTcBq = 128;      // query rows of a block: 2 warpgroups of 64
// keys of a K/V tile: 64 and 128 measured within the calls' spread of each
// other (each faster in one call), so the smaller tile stays
constexpr int kTcBk = 64;
constexpr int kTcThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
// A staged bias row holds 72 elements: 64 keys and a pad, so that the 8
// rows a warp reads at once fall in different banks.
constexpr int kBiasLd = 72;
constexpr int kBiasStage = kTcBq * kBiasLd * 4;  // bytes, float32 or less

// Q (128 rows), then K and V (2 stages of 64 rows each), bf16, then with a
// bias 2 stages of its (128 x 64) tile; 1024 bytes of slack to align the
// tiles to the swizzle atom.
template <int D, bool kBias>
constexpr size_t tc_smem_bytes() {
  return 1024 + 2 * D * (kTcBq + 4 * kTcBk) + (kBias ? 2 * kBiasStage : 0);
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
template <int D, bool kDrop, typename BT>
__global__ void __launch_bounds__(kTcThreads,
                                  D <= 64 && !kHasBias<BT> ? 2 : 1)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse,
                        const int* __restrict__ kv_valid,
                        const int* __restrict__ seed, Bias bias, int tq,
                        int tk, float scale, int causal, uint32_t threshold,
                        float keep_scale) {
  using S = hp::TileShape<D>;
  constexpr bool kBias = kHasBias<BT>;
  constexpr int kQBytes = kTcBq * D * 2, kKvBytes = kTcBk * D * 2;
  constexpr int kBElt = sizeof(BT), kBStride = kBiasLd * kBElt;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (hp::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;        // [2][64][D], swizzled
  const uint32_t v_s = k_s + 2 * kKvBytes;   // [2][64][D], swizzled
  const uint32_t b_s = v_s + 2 * kKvBytes;   // [2][128][kBiasLd] bias
  const uint8_t* b_g = smem_raw + (b_s - hp::smem_addr(smem_raw));

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTcBq, qw0 = q0 + 64 * wg;
  const __nv_bfloat16* qb = q + static_cast<long>(bh) * tq * D;
  const __nv_bfloat16* kb = k + static_cast<long>(bh) * tk * D;
  const __nv_bfloat16* vb = v + static_cast<long>(bh) * tk * D;
  const int valid = valid_keys(kv_valid, bh, tk);
  // the two query rows of this thread's accumulator registers
  const int qrow[2] = {qw0 + 16 * ((tid % 128) / 32) + lane / 4,
                       qw0 + 16 * ((tid % 128) / 32) + lane / 4 + 8};
  uint32_t qkey[2] = {0u, 0u};
  if (kDrop) {
    const uint32_t row = dropout_row_key(static_cast<uint32_t>(seed[0]), bh);
    qkey[0] = dropout_q_key(row, qrow[0]);
    qkey[1] = dropout_q_key(row, qrow[1]);
  }
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  const bool b_chunks = kBias && bias_rows_aligned<BT>(bias, tk);
  // tile kt's K, V and bias into ring stage st
  auto copy_kv = [&](int kt, int st) {
    hp::copy_tile<D, kTcBk, kTcThreads>(k_s + st * kKvBytes, kb, kt * kTcBk,
                                        tk, tid);
    hp::copy_tile<D, kTcBk, kTcThreads>(v_s + st * kKvBytes, vb, kt * kTcBk,
                                        tk, tid);
    if constexpr (kBias)
      stage_bias_async<kTcBq, kTcBk, kTcThreads, BT>(
          b_s + st * kBiasStage, kBStride, bias, plane, q0, kt * kTcBk, tq,
          tk, b_chunks, tid);
  };

  int n_tiles = (valid + kTcBk - 1) / kTcBk;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTcBq, tq) - 1) / kTcBk + 1);
  hp::copy_tile<D, kTcBq, kTcThreads>(q_s, qb, q0, tq, tid);
  if (n_tiles > 0) copy_kv(0, 0);
  hp::cp_async_commit();

  float acc[S::kBlocks][S::kCols / 2];
#pragma unroll
  for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
    for (int i = 0; i < S::kCols / 2; ++i) acc[b][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bool rows_in = qw0 < tq;  // the warpgroup holds rows below T

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTcBk, st = kt & 1;
    if (kt + 1 < n_tiles) {  // the next tile's copy, into the other stage
      copy_kv(kt + 1, st ^ 1);
      hp::cp_async_commit();
      hp::cp_async_wait<1>();
    } else {
      hp::cp_async_wait<0>();
    }
    hp::fence_async_smem();
    __syncthreads();  // tile kt (and Q) is in shared memory

    if (rows_in && (!causal || k0 <= qw0 + 63)) {
      constexpr int kS = kTcBk / 2;  // score registers a thread
      float s[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) s[i] = 0.f;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss(s, hp::desc_k_major<D, kTcBq>(q_s, 64 * wg, kk),
                         hp::desc_k_major<D, kTcBk>(k_s + st * kKvBytes, 0, kk),
                         kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait();
      hp::fence_regs(s);

      float mx[2] = {kNegInf, kNegInf};
      float2 bv = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int h = (i / 2) % 2;
        const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const bool ok = kp < valid && (!causal || kp <= qrow[h]);
        if constexpr (kBias) {
          if (i % 2 == 0)  // the pair of keys (kp, kp + 1) of row qrow[h]
            bv = lds_bias2<BT>(b_g + st * kBiasStage +
                               ((qrow[h] - q0) * kBiasLd + kp - k0) * kBElt);
          s[i] = ok ? s[i] * scale + (i % 2 ? bv.y : bv.x) : -INFINITY;
        } else {
          s[i] = ok ? s[i] * scale : kNegInf;
        }
        mx[h] = fmaxf(mx[h], s[i]);
      }
      float alpha[2], mneg[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);  // finite: m starts finite
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        mneg[h] = -m_new * kLog2e;
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int h = (i / 2) % 2;
        const float p = exp2f(fmaf(s[i], kLog2e, mneg[h]));
        sum[h] += p;  // the normalizer uses the un-dropped probability
        if (kDrop) {
          const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          s[i] = dropout_keep(qkey[h], kp, threshold) ? p * keep_scale : 0.f;
        } else {
          s[i] = p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
        for (int i = 0; i < S::kCols / 2; ++i) acc[b][i] *= alpha[(i / 2) % 2];

      uint32_t a[kTcBk / 16][4];  // P in bf16: the A operand of P V
#pragma unroll
      for (int j = 0; j < kTcBk / 16; ++j) hp::to_a_frag(s, j, a[j]);
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b) hp::fence_regs(acc[b]);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcBk / 16; ++j)
#pragma unroll
        for (int b = 0; b < S::kBlocks; ++b)
          hp::wgmma_rs(acc[b], a[j],
                       hp::desc_mn_major<D, kTcBk>(v_s + st * kKvBytes, b, j));
      hp::wgmma_commit();
      hp::wgmma_wait();
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b) hp::fence_regs(acc[b]);
    }
    __syncthreads();  // stage st is free for the copy of tile kt + 2
  }

  if (!rows_in) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<long>(bh) * tq + qrow[h]) * D;
#pragma unroll
    for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
      for (int i = 0; i < S::kCols / 2; i += 4) {
        const int c = b * S::kCols + 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(orow + c) = hp::pack_bf16(
            acc[b][i + 2 * h] * inv, acc[b][i + 2 * h + 1] * inv);
      }
    if (lane % 4 == 0)
      lse[static_cast<long>(bh) * tq + qrow[h]] =
          m[h] + logf(fmaxf(l[h], 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int *kv_valid, *seed;
  Bias bias;
  int bh, tq, tk;
  float scale;
  int causal;
  uint32_t threshold;
  float keep_scale;
  cudaStream_t stream;
};

template <int D, bool kDrop, bool kBias>
cudaError_t launch(const Args& a) {
  const size_t smem = sizeof(float) * (kBq * (D + 1) + kBk * (D + 1) +
                                       kBk * D + kBq * kPs + 3 * kBq);
  auto kernel = flash_fwd_kernel<D, kDrop, kBias>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((a.tq + kBq - 1) / kBq, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.kv_valid,
      a.seed, a.bias, a.tq, a.tk, a.scale, a.causal, a.threshold,
      a.keep_scale);
  return cudaGetLastError();
}

template <bool kDrop, bool kBias>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<16, kDrop, kBias>(a);
    case 32: return launch<32, kDrop, kBias>(a);
    case 64: return launch<64, kDrop, kBias>(a);
    case 128: return launch<128, kDrop, kBias>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, bool kDrop, typename BT>
cudaError_t launch_tc(const Args& a) {
  const size_t smem = tc_smem_bytes<D, kHasBias<BT>>();
  auto kernel = flash_fwd_tc_kernel<D, kDrop, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tq + kTcBq - 1) / kTcBq, a.bh), kTcThreads, smem,
           a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.lse, a.kv_valid, a.seed, a.bias,
      a.tq, a.tk, a.scale, a.causal, a.threshold, a.keep_scale);
  return cudaGetLastError();
}

template <bool kDrop, typename BT>
cudaError_t dispatch_tc_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_tc<16, kDrop, BT>(a);
    case 32: return launch_tc<32, kDrop, BT>(a);
    case 64: return launch_tc<64, kDrop, BT>(a);
    case 128: return launch_tc<128, kDrop, BT>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDrop>
cudaError_t dispatch_tc_bias(int d, const Args& a) {
  if (a.bias.ptr == nullptr) return dispatch_tc_d<kDrop, NoBias>(d, a);
  if (a.bias.dtype == 1) return dispatch_tc_d<kDrop, __nv_bfloat16>(d, a);
  if (a.bias.dtype == 2) return dispatch_tc_d<kDrop, __half>(d, a);
  return dispatch_tc_d<kDrop, float>(d, a);
}

// float32 runs the FFMA kernel, bfloat16 the tensor-core one.
template <bool kTc>
cudaError_t dispatch(int d, const Args& a) {
  const bool drop = a.seed != nullptr, biased = a.bias.ptr != nullptr;
  if (kTc) return drop ? dispatch_tc_bias<true>(d, a)
                       : dispatch_tc_bias<false>(d, a);
  if (drop && biased) return dispatch_d<true, true>(d, a);
  if (drop) return dispatch_d<true, false>(d, a);
  if (biased) return dispatch_d<false, true>(d, a);
  return dispatch_d<false, false>(d, a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 float32 (FFMA kernel), 1 bfloat16 (tensor-core kernel; q, k, v
// and o 16-byte aligned).  kv_valid, seed and bias may be null (no
// key-padding mask; no dropout; no bias).  bias is (bias_planes, tq, tk)
// of bias_dtype (0 float32, 1 bfloat16, 2 float16); row bh reads plane
// bh % bias_planes.  *route is set to the kernel launched: 0 FFMA,
// 1 wgmma (left as it is when nothing is launched).
extern "C" int tmx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const void* bias, int bias_planes,
                                       int bias_dtype, const int* kv_valid,
                                       const int* seed, int bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       uint32_t threshold, float keep_scale,
                                       int dtype, void* stream, int* route) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535) return cudaErrorInvalidValue;
  if (bias != nullptr && (bias_planes < 1 || bh % bias_planes != 0 ||
                          bias_dtype < 0 || bias_dtype > 2))
    return cudaErrorInvalidValue;
  Args a{q,         k,          v,     o,
         lse,       kv_valid,   seed,  {bias, bias_planes, bias_dtype},
         bh,        tq,         tk,    scale,
         causal,    threshold,  keep_scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    *route = 0;
    return dispatch<false>(d, a);
  }
  if (dtype == 1) {
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
      return cudaErrorInvalidValue;
    *route = 1;
    return dispatch<true>(d, a);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
