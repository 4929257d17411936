// Flash-attention forward for Hopper (sm_90a), on the tensor cores: bf16
// with wgmma, float32 with split-precision (3xTF32) mma.sync.
//
// Replaces the forward Pallas TPU kernel tpu_mx/kernels/flash_attention.py::
// _fwd_kernel (launched by _fwd): O = softmax(q k^T * scale [masks]) v over
// (BH, T, D) tensors, blockwise with an online softmax, plus the per-row
// logsumexp that the backward kernels (flash_attention_bwd.cu) read.
// Options, as in the reference:
//   - causal: query row i sees key columns j <= i (_score_mask);
//   - kv_valid (BH,) int32: key columns >= kv_valid[bh] are masked and the
//     K-tile loop stops at the last tile holding a valid key, as _run_cond
//     skips whole blocks;
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
// device memory, so the call is bound by bytes at the roofline.  In
// practice the per-element work on the scores bounds it: exp2, the masks
// and, with dropout, the integer hash of every (q, k) (on an H100 at that
// shape the kernel takes about 0.11 ms without dropout and 0.16 ms with
// it).  A bias adds planes*T*Tk elements read once (a float32 plane per row
// is 402.7 MB at BERT's shape).  The float32 serving prefill (BH=32,
// D=128, causal) is bound by operations at every prompt length past a few
// hundred tokens: 3 TF32 products per product at 495 TFLOP/s (0.208 ms at
// T=2048), against 0.513 ms for one product at the 67 TFLOP/s FFMA rate.
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
// float32 design (flash_fwd_tf32x3_kernel), for the serving prefill, whose
// gates are logits within 2e-4 of the CPU and the kernel within 1e-4 of
// the plain version with TF32 off: one TF32 pass would round q, k, v and
// P to 10 mantissa bits (a different result, not a faster one), so every
// operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and
// each product is a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, accumulated in
// float32.  hi + lo is within 2^-22 of |x|, and the omitted a_lo*b_lo
// is under 2^-22 of |a b|, so a product keeps about 21 bits before the
// float32 sums.  Both roundings are two integer operations on the bit
// pattern (a cvt.rna.tf32.f32 instruction took 30% more device time on
// an H100):
//   - mma.sync.m16n8k8 TF32, not wgmma: TF32 wgmma reads B only K-major
//     from shared memory, so O += P V would need a transposed copy of every
//     V tile, and the lo halves a second copy of K and V (4 x 32 KB a stage
//     at D=128, no room for two stages beside Q).  With mma.sync the
//     threads load their own fragments with ld.shared from padded rows and
//     split them in registers: shared memory holds one float32 copy of
//     each tile and V needs no transpose;
//   - grid (ceil(T/64), BH); 128 threads, 4 warps of 16 query rows; Q is
//     copied into shared memory once and split at fragment load;
//   - K and V tiles of 32 keys flow through a 2-stage cp.async ring (16
//     bytes a thread, zero-filled past Tk); the copy of tile j+1 is issued
//     right after the one barrier of tile j, so it runs under tile j's
//     products.  Tiles past kv_valid or above the block's causal diagonal
//     are never copied, and a warp skips a tile above its own diagonal.
//     32-key tiles keep a block at 103 KB of shared memory at D=128, so two
//     blocks (8 warps) share an SM;
//   - inside an instruction the order of the 8 reduction elements is free
//     as long as A and B agree, so a thread's pair (2t, 2t+1) of them is
//     read as one float2: Q and K rows are D+8 floats apart (each 16-lane
//     phase of a 64-bit load hits 32 distinct banks), and the S fragment
//     (keys 2t, 2t+1 of a row) is the A fragment of P V as it stands, with
//     V's rows 2t and 2t+1 as B (V rows D+4 floats apart: the 4 rows and 8
//     columns a warp reads fall in distinct banks).  No shuffle, no shared
//     memory between S and P V;
//   - the online softmax runs on the accumulator registers: (row, key) of
//     each register from the m16n8 layout, the row max and sum reduced
//     over the quad with two __shfl_xor_sync each, (m, l) in registers;
//     masks, the dropout keep bit and the bias (read from device memory in
//     its own type, a template parameter) apply per register.
// The C entry point sends bfloat16 to the wgmma kernel and float32 to the
// 3xTF32 kernel, and reports which through *route; nothing else falls back.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace hp = tmx_hopper;

namespace {

using namespace tmx_flash;

// ---------------------------------------------------------------------------
// float32: split-precision TF32 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------
constexpr int kF32Warps = 4;
constexpr int kF32Rows = 16 * kF32Warps;  // query rows of a block
constexpr int kF32Keys = 32;              // keys of a K/V tile
constexpr int kF32Threads = 32 * kF32Warps;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t f32tc_smem_bytes() {
  // Q [64][D+8], then 2 stages of K [32][D+8] and V [32][D+4], float32
  return sizeof(float) *
         (kF32Rows * (D + 8) + 2 * kF32Keys * (D + 8) + 2 * kF32Keys * (D + 4));
}

// x split into hi, x rounded to TF32 (10 mantissa bits) to nearest with
// ties away from zero (the bit pattern's low 13 bits rounded on the
// magnitude, as cvt.rna.tf32.f32 rounds), and lo, the exact x - hi
// rounded the same way.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in three TF32 products, the small ones first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Issue the copy of rows [r0, r0 + R) of a (rows, D) float32 operand into
// shared memory at `dst`, rows kLd floats apart, 16 bytes a thread; rows
// past `rows` are zero-filled (source size 0, address clamped to row 0).
template <int D, int R, int kLd>
__device__ __forceinline__ void copy_rows_f32(uint32_t dst, const float* src,
                                              int r0, int rows, int tid) {
  constexpr int kChunks = D / 4, kN = R * kChunks;
#pragma unroll
  for (int it = 0; it < (kN + kF32Threads - 1) / kF32Threads; ++it) {
    const int i = tid + it * kF32Threads;
    if (kN % kF32Threads != 0 && i >= kN) break;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = r0 + r < rows;
    const float* from = src + (in ? static_cast<long>(r0 + r) * D + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + 4 * (r * kLd + c)),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

template <typename BT>
__device__ __forceinline__ float bias_value(const void* base, long i) {
  if constexpr (std::is_same_v<BT, float>)
    return __ldg(static_cast<const float*>(base) + i);
  else if constexpr (std::is_same_v<BT, __nv_bfloat16>)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  else
    return __half2float(static_cast<const __half*>(base)[i]);
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
template <int D, bool kDrop, typename BT>
__global__ void __launch_bounds__(kF32Threads, 2)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse,
                            const int* __restrict__ kv_valid,
                            const int* __restrict__ seed, Bias bias, int tq,
                            int tk, float scale, int causal,
                            uint32_t threshold, float keep_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr bool kBias = kHasBias<BT>;
  constexpr int QL = D + 8, KL = D + 8, VL = D + 4;  // row strides, floats
  constexpr int NT = kF32Keys / 8;  // 8-key tiles of S, k-steps of P V
  constexpr int DT = D / 8;         // k-steps of S, 8-column tiles of O
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);  // [64][QL]
  float* k_s = q_s + kF32Rows * QL;                // [2][32][KL]
  float* v_s = k_s + 2 * kF32Keys * KL;            // [2][32][VL]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int bh = blockIdx.y, q0 = blockIdx.x * kF32Rows, qw0 = q0 + 16 * warp;
  // the two query rows of this thread's accumulator registers
  const int qrow[2] = {qw0 + g, qw0 + g + 8};
  const float* qb = q + static_cast<long>(bh) * tq * D;
  const float* kb = k + static_cast<long>(bh) * tk * D;
  const float* vb = v + static_cast<long>(bh) * tk * D;
  const int valid = valid_keys(kv_valid, bh, tk);
  uint32_t qkey[2] = {0u, 0u};
  if (kDrop) {
    const uint32_t row = dropout_row_key(static_cast<uint32_t>(seed[0]), bh);
    qkey[0] = dropout_q_key(row, qrow[0]);
    qkey[1] = dropout_q_key(row, qrow[1]);
  }
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  const uint32_t q_a = hp::smem_addr(q_s), k_a = hp::smem_addr(k_s),
                 v_a = hp::smem_addr(v_s);
  auto copy_kv = [&](int kt, int st) {
    copy_rows_f32<D, kF32Keys, KL>(k_a + 4 * st * kF32Keys * KL, kb,
                                   kt * kF32Keys, tk, tid);
    copy_rows_f32<D, kF32Keys, VL>(v_a + 4 * st * kF32Keys * VL, vb,
                                   kt * kF32Keys, tk, tid);
  };

  int n_tiles = (valid + kF32Keys - 1) / kF32Keys;
  if (causal)
    n_tiles = min(n_tiles, (min(q0 + kF32Rows, tq) - 1) / kF32Keys + 1);
  copy_rows_f32<D, kF32Rows, QL>(q_a, qb, q0, tq, tid);
  if (n_tiles > 0) copy_kv(0, 0);
  hp::cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bool rows_in = qw0 < tq;  // the warp holds rows below T
  const float* qw = q_s + 16 * warp * QL;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Keys, st = kt & 1;
    hp::cp_async_wait<0>();
    // tile kt (and Q) is in shared memory, and every warp is done with
    // tile kt - 1, whose stage the next copy overwrites
    __syncthreads();
    if (kt + 1 < n_tiles) copy_kv(kt + 1, st ^ 1);
    hp::cp_async_commit();
    if (!rows_in || (causal && k0 > qw0 + 15)) continue;

    const float* ks = k_s + st * kF32Keys * KL;
    const float* vs = v_s + st * kF32Keys * VL;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      // A: rows g and g + 8, reduction elements (2t, 2t + 1) of the step
      const float2 x0 =
          *reinterpret_cast<const float2*>(qw + g * QL + 8 * kk + 2 * t);
      const float2 x1 =
          *reinterpret_cast<const float2*>(qw + (g + 8) * QL + 8 * kk + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // B: key 8j + g, the same elements
        const float2 y = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * KL + 8 * kk + 2 * t);
        mma_3xtf32(s[j], ah, al, y.x, y.y);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2;
        const int kp = k0 + 8 * j + 2 * t + (i & 1);
        const bool ok = kp < valid && (!causal || kp <= qrow[h]);
        if constexpr (kBias) {
          const float b =
              ok && qrow[h] < tq
                  ? bias_value<BT>(bias.ptr,
                                   plane + static_cast<long>(qrow[h]) * tk + kp)
                  : 0.f;
          s[j][i] = ok ? s[j][i] * scale + b : -INFINITY;
        } else {
          s[j][i] = ok ? s[j][i] * scale : kNegInf;
        }
        mx[h] = fmaxf(mx[h], s[j][i]);
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
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2;
        const float p = exp2f(fmaf(s[j][i], kLog2e, mneg[h]));
        sum[h] += p;  // the normalizer uses the un-dropped probability
        if (kDrop) {
          const int kp = k0 + 8 * j + 2 * t + (i & 1);
          s[j][i] = dropout_keep(qkey[h], kp, threshold) ? p * keep_scale : 0.f;
        } else {
          s[j][i] = p;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i / 2];

#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // A: P's registers as they stand (rows g, g + 8; keys 8j + 2t and
      // 8j + 2t + 1 as reduction elements t and t + 4)
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* v0 = vs + (8 * j + 2 * t) * VL + g;
#pragma unroll
      for (int n = 0; n < DT; ++n)  // B: V rows 8j + 2t, 8j + 2t + 1
        mma_3xtf32(acc[n], ph, pl, v0[8 * n], v0[VL + 8 * n]);
    }
  }

  if (!rows_in) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    float* orow = o + (static_cast<long>(bh) * tq + qrow[h]) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (t == 0)
      lse[static_cast<long>(bh) * tq + qrow[h]] =
          m[h] + logf(fmaxf(l[h], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcBq = 128;      // query rows of a block: 2 warpgroups of 64
// keys of a K/V tile: 64 and 128 measured within the calls' spread of each
// other (each faster in one call), so the smaller tile stays
constexpr int kTcBk = 64;
constexpr int kTcThreads = 256;
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

// kF32: the float32 3xTF32 kernel, else the bf16 wgmma one.
template <bool kF32, int D, bool kDrop, typename BT>
cudaError_t launch(const Args& a) {
  if constexpr (kF32) {
    const size_t smem = f32tc_smem_bytes<D>();
    auto kernel = flash_fwd_tf32x3_kernel<D, kDrop, BT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.tq + kF32Rows - 1) / kF32Rows, a.bh), kF32Threads, smem,
             a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
        a.kv_valid, a.seed, a.bias, a.tq, a.tk, a.scale, a.causal,
        a.threshold, a.keep_scale);
  } else {
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
  }
  return cudaGetLastError();
}

template <bool kF32, bool kDrop, typename BT>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<kF32, 16, kDrop, BT>(a);
    case 32: return launch<kF32, 32, kDrop, BT>(a);
    case 64: return launch<kF32, 64, kDrop, BT>(a);
    case 128: return launch<kF32, 128, kDrop, BT>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kF32, bool kDrop>
cudaError_t dispatch_bias(int d, const Args& a) {
  if (a.bias.ptr == nullptr) return dispatch_d<kF32, kDrop, NoBias>(d, a);
  if (a.bias.dtype == 1)
    return dispatch_d<kF32, kDrop, __nv_bfloat16>(d, a);
  if (a.bias.dtype == 2) return dispatch_d<kF32, kDrop, __half>(d, a);
  return dispatch_d<kF32, kDrop, float>(d, a);
}

template <bool kF32>
cudaError_t dispatch(int d, const Args& a) {
  return a.seed != nullptr ? dispatch_bias<kF32, true>(d, a)
                           : dispatch_bias<kF32, false>(d, a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 float32 (3xTF32 kernel), 1 bfloat16 (wgmma kernel); q, k, v
// and o 16-byte aligned.  kv_valid, seed and bias may be null (no
// key-padding mask; no dropout; no bias).  bias is (bias_planes, tq, tk)
// of bias_dtype (0 float32, 1 bfloat16, 2 float16); row bh reads plane
// bh % bias_planes.  *route is set to the kernel launched: 1 wgmma,
// 2 3xTF32 (left as it is when nothing is launched; 0, FFMA, is the
// backward's float32 route).
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
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
  *route = dtype == 0 ? 2 : 1;
  return dtype == 0 ? dispatch<true>(d, a) : dispatch<false>(d, a);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
