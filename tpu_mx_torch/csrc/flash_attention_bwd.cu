// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// each in bf16 on the tensor cores (wgmma) and in float32 on FFMA.
//
// Replaces the backward Pallas TPU kernels of tpu_mx/kernels/
// flash_attention.py, both launched by _bwd:
//   - flash_dq_tc_kernel (bf16) and flash_dq_kernel (float32)
//       <- _bwd_dq_kernel:  dq = ds K, with
//       s  = q k^T * scale (masked),  p = exp(s - lse),  dp = dO V^T,
//       dp <- z/(1-r) * dp  (the regenerated keep mask z),
//       ds = p o (dp - delta) * scale;
//   - flash_dkv_tc_kernel (bf16) and flash_dkv_kernel (float32)
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
// (past kv_valid, above the causal diagonal) get 0.
//
// Bound on the H100: operations.  Non-causal, dq does 3 products of
// 2*T*Tk_valid*D operations per head (QK^T, dO V^T, dS K) and dk/dv 4
// (QK^T, dO V^T, P^T dO, dS^T Q), against a few bytes per element of q, k,
// v, dO, dq, dk, dv.  At BERT's shape (BH=384, T=512, D=64, kv_valid
// 384-512) dk/dv is 45.9 GFLOP: 0.046 ms at the 989 TFLOP/s bf16
// tensor-core rate, 0.69 ms at the 67 TFLOP/s float32 FFMA rate; dq's
// three products take 0.035 ms, just under the 0.036 ms its bytes take.
// In practice the bf16 kernels are held back by their registers and by
// the element-wise work between the products (exp2, the masks, the
// dropout hash): dk/dv (about 0.33 ms there on an H100) needs 167
// registers a thread at D=64 (dk, dv, S^T and dP^T alone are 128), so one
// block of two warpgroups runs per SM and each warpgroup's products wait
// for its own element-wise work; dq (about 0.24 ms) fits in 128 at D<=64
// without a bias (S, dP and dQ are 96), so two blocks share an SM.  ptxas
// (CUDA 12.9): dq 106-179 registers without a bias, 160-236 with one,
// no spill.
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
// FFMA designs (float32):
//   - dq: grid (ceil(T/64), BH); 256 threads own 64 query rows, with their
//     q and dO staged in shared memory, and loop over 64-row K/V tiles up
//     to ceil(valid/64) (and the causal diagonal).  Each thread computes a
//     4x4 block of s and dp, writes ds to shared memory, and accumulates a
//     4 x D/16 block of dq in registers;
//     With a bias, its tile is staged into the ds tile with K and V, and
//     d_bias is written from registers (16 consecutive keys a half-warp);
//   - dk/dv, float32: grid (ceil(Tk/64), BH); 256 threads own 64 key rows,
//     with their k and v staged, and loop over 64-row Q tiles (from the
//     diagonal when causal).  They compute the transposed scores, write
//     the dropped probabilities and ds transposed to shared memory, and
//     accumulate 4 x D/16 blocks of dk and dv.  Key tiles wholly past
//     kv_valid run no Q tile and write zeros; key rows past kv_valid in a
//     partial tile get p = ds = 0, hence zeros too (the outputs are not
//     pre-zeroed).  With a bias, its tile is staged transposed into the p
//     tile, read along the key axis so that the loads coalesce.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tmx_flash;

constexpr int kPs = kBk + 1;  // padded row stride of the ds / p tiles

// kBias: a bias (bias.ptr != null); d_bias may then be null (not wanted).
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Bias bias, float* __restrict__ d_bias,
                    const int* __restrict__ kv_valid,
                    const int* __restrict__ seed, int tq, int tk, float scale,
                    int causal, uint32_t threshold, float keep_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // [kBq][QS]
  float* do_s = q_s + kBq * QS;    // [kBq][QS]
  float* k_s = do_s + kBq * QS;    // [kBk][QS]
  float* v_s = k_s + kBk * QS;     // [kBk][QS]
  float* ds_s = v_s + kBk * QS;    // [kBq][kPs]
  float* lse_s = ds_s + kBq * kPs; // [kBq]
  float* dl_s = lse_s + kBq;       // [kBq] delta

  const int bh = blockIdx.y, q0 = blockIdx.x * kBq, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long qoff = static_cast<long>(bh) * tq;
  const long koff = static_cast<long>(bh) * tk;
  const int valid = valid_keys(kv_valid, bh, tk);
  const bool drop = seed != nullptr;
  uint32_t qkey[4];
  {
    const uint32_t row =
        drop ? dropout_row_key(static_cast<uint32_t>(seed[0]), bh) : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qkey[i] = drop ? dropout_q_key(row, q0 + ty * 4 + i) : 0u;
  }

  stage_rows2<D, kBq>(q_s, QS, q + qoff * D, do_s, QS, dout + qoff * D, q0,
                      tq);
  if (tid < kBq) {
    const bool in = q0 + tid < tq;
    lse_s[tid] = in ? lse[qoff + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[qoff + q0 + tid] : 0.f;
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
    stage_rows2<D, kBk>(k_s, QS, k + koff * D, v_s, QS, v + koff * D, k0,
                        tk);
    if (kBias) stage_bias<false>(ds_s, kPs, bias, bh, q0, k0, tq, tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty * 4 + i) * QS + d];
        ov[i] = do_s[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * QS + d];
        vv[j] = v_s[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool ok = kpos < valid && (!causal || kpos <= q0 + r);
        float p;
        if (kBias)
          p = ok ? expf(s[i][j] * scale + ds_s[r * kPs + c] - lse_s[r]) : 0.f;
        else
          p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        float g = dp[i][j];
        if (drop) g = dropout_keep(qkey[i], kpos, threshold) ? g * keep_scale
                                                             : 0.f;
        const float db = p * (g - dl_s[r]);
        if (kBias && d_bias != nullptr && q0 + r < tq && kpos < tk)
          d_bias[(qoff + q0 + r) * tk + kpos] = ok ? db : 0.f;
        ds_s[r * kPs + c] = db * scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kBk; ++kk) {
      float dv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = ds_s[(ty * 4 + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = k_s[kk * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] += dv[i] * kv[j];
    }
  }
  if (kBias && d_bias != nullptr) {  // the key tiles the loop never visited
    const int c0 = n_tiles * kBk, nc = tk - c0, nr = min(kBq, tq - q0);
    for (long i = tid; i < static_cast<long>(nr) * nc; i += kThreads) {
      const int r = static_cast<int>(i / nc), c = static_cast<int>(i % nc);
      d_bias[(qoff + q0 + r) * tk + c0 + c] = 0.f;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < tq) {
      float* row = dq + (qoff + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) row[tx + 16 * j] = acc[i][j];
    }
  }
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Bias bias,
                     const int* __restrict__ kv_valid,
                     const int* __restrict__ seed, int tq, int tk,
                     float scale, int causal, uint32_t threshold,
                     float keep_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [kBk][QS]
  float* v_s = k_s + kBk * QS;     // [kBk][QS]
  float* q_s = v_s + kBk * QS;     // [kBq][QS]
  float* do_s = q_s + kBq * QS;    // [kBq][QS]
  float* pt_s = do_s + kBq * QS;   // [kBk][kPs] dropped p, transposed
  float* dst_s = pt_s + kBk * kPs; // [kBk][kPs] ds, transposed
  float* lse_s = dst_s + kBk * kPs;// [kBq]
  float* dl_s = lse_s + kBq;       // [kBq] delta

  const int bh = blockIdx.y, k0 = blockIdx.x * kBk, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long qoff = static_cast<long>(bh) * tq;
  const long koff = static_cast<long>(bh) * tk;
  const int valid = valid_keys(kv_valid, bh, tk);
  const bool drop = seed != nullptr;
  const uint32_t row_key =
      drop ? dropout_row_key(static_cast<uint32_t>(seed[0]), bh) : 0u;

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // a key tile wholly past kv_valid runs no Q tile and writes zeros
  const int n_qt = k0 < valid ? (tq + kBq - 1) / kBq : 0;
  const int qt0 = causal ? k0 / kBq : 0;
  if (qt0 < n_qt)
    stage_rows2<D, kBk>(k_s, QS, k + koff * D, v_s, QS, v + koff * D, k0,
                        tk);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBq;
    __syncthreads();  // the previous tile's readers are done
    stage_rows2<D, kBq>(q_s, QS, q + qoff * D, do_s, QS, dout + qoff * D,
                        q0, tq);
    if (kBias) stage_bias<true>(pt_s, kPs, bias, bh, q0, k0, tq, tk);
    if (tid < kBq) {
      const bool in = q0 + tid < tq;
      lse_s[tid] = in ? lse[qoff + q0 + tid] : 0.f;
      dl_s[tid] = in ? delta[qoff + q0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed scores: key rows ty*4+i, query columns tx+16j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = k_s[(ty * 4 + i) * QS + d];
        vv[i] = v_s[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = q_s[(tx + 16 * j) * QS + d];
        ov[j] = do_s[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] += kv[i] * qv[j];
          dpt[i][j] += vv[i] * ov[j];
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, qpos = q0 + c;
      const uint32_t qkey = drop ? dropout_q_key(row_key, qpos) : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, kpos = k0 + r;
        const bool ok =
            qpos < tq && kpos < valid && (!causal || kpos <= qpos);
        float p;
        if (kBias)  // pt_s holds the bias, transposed: [key][query]
          p = ok ? expf(st[i][j] * scale + pt_s[r * kPs + c] - lse_s[c])
                 : 0.f;
        else
          p = ok ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        float pd = p, g = dpt[i][j];
        if (drop) {
          const bool keep = dropout_keep(qkey, kpos, threshold);
          pd = keep ? p * keep_scale : 0.f;
          g = keep ? g * keep_scale : 0.f;
        }
        pt_s[r * kPs + c] = pd;
        dst_s[r * kPs + c] = p * (g - dl_s[c]) * scale;
      }
    }
    __syncthreads();

    for (int rr = 0; rr < kBq; ++rr) {
      float pv[4], dsv[4], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt_s[(ty * 4 + i) * kPs + rr];
        dsv[i] = dst_s[(ty * 4 + i) * kPs + rr];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        ov[j] = do_s[rr * QS + tx + 16 * j];
        qv[j] = q_s[rr * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          dv_acc[i][j] += pv[i] * ov[j];
          dk_acc[i][j] += dsv[i] * qv[j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (k0 + r < tk) {
      float* krow = dk + (koff + k0 + r) * D;
      float* vrow = dv + (koff + k0 + r) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        krow[tx + 16 * j] = dk_acc[i][j];
        vrow[tx + 16 * j] = dv_acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv in bf16: tensor cores
// ---------------------------------------------------------------------------
namespace hp = tmx_hopper;

constexpr int kTcKeys = 128;    // key rows of a block: 2 warpgroups of 64
constexpr int kTcQ = 64;        // query rows of a Q/dO tile
constexpr int kTcThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
// A staged bias row (one query, 128 keys) is 528 bytes in float32 and 272
// in 16-bit types: a pad after the keys, so that the 8 keys x 4 queries a
// warp reads at once fall in different banks.
constexpr int kBiasRow32 = 528, kBiasRow16 = 272;
constexpr int kBiasStage = kTcQ * kBiasRow32;  // bytes

// K and V (128 rows each), 2 stages of Q and dO (64 rows each), bf16; then
// 2 stages of lse and delta (64 floats each) and with a bias 2 stages of
// its (64 x 128) tile; 1024 bytes of slack to align the tiles to the
// swizzle atom.
template <int D, bool kBias>
constexpr size_t dkv_tc_smem_bytes() {
  return 1024 + 2 * D * (2 * kTcKeys + 4 * kTcQ) + 4 * 4 * kTcQ +
         (kBias ? 2 * kBiasStage : 0);
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
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
  constexpr int kKvBytes = kTcKeys * D * 2, kQBytes = kTcQ * D * 2;
  constexpr int kBElt = sizeof(BT);
  constexpr int kBStride = kBElt == 4 ? kBiasRow32 : kBiasRow16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (((hp::smem_addr(smem_raw) + 1023) & ~1023u) -
                              hp::smem_addr(smem_raw));
  const uint32_t k_s = hp::smem_addr(smem);     // [128][D], swizzled
  const uint32_t v_s = k_s + kKvBytes;          // [128][D]
  const uint32_t q_s = v_s + kKvBytes;          // [2][64][D]
  const uint32_t do_s = q_s + 2 * kQBytes;      // [2][64][D]
  const float* lse_s =                          // [2][64]
      reinterpret_cast<const float*>(smem + 2 * kKvBytes + 4 * kQBytes);
  const float* dl_s = lse_s + 2 * kTcQ;         // [2][64]
  const uint32_t b_s = do_s + 2 * kQBytes + 4 * 4 * kTcQ;  // [2][64] rows
  const uint8_t* b_g = smem + (b_s - k_s);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTcKeys, kw0 = k0 + 64 * wg;
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
  const bool b_chunks = kBias && bias_rows_aligned<BT>(bias, tk);

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
    hp::copy_floats(rows + 4 * 2 * kTcQ, delta + qoff + qt * kTcQ, kTcQ,
                    tq - qt * kTcQ, tid - kTcQ);
    if constexpr (kBias)  // bias[q][k] of these queries and the block's keys
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

  float dk_acc[S::kBlocks][S::kCols / 2], dv_acc[S::kBlocks][S::kCols / 2];
#pragma unroll
  for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
    for (int i = 0; i < S::kCols / 2; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;
  const bool keys_in = kw0 < valid;  // the warpgroup holds a valid key

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTcQ, st = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {  // the next tile's copy, into the other stage
      copy_q(qt + 1, st ^ 1);
      hp::cp_async_commit();
      hp::cp_async_wait<1>();
    } else {
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
            if constexpr (kBias)
              x += lds_bias<BT>(b_g + st * kBiasStage + c * kBStride +
                                (kp - k0) * kBElt);
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
      // read MN-major from shared memory.  Both A operands are built before
      // the products: an in-flight product's registers are not rewritten.
      uint32_t ap[kTcQ / 16][4], ad[kTcQ / 16][4];
#pragma unroll
      for (int j = 0; j < kTcQ / 16; ++j) {
        hp::to_a_frag(s, j, ap[j]);
        hp::to_a_frag(dp, j, ad[j]);
      }
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b) {
        hp::fence_regs(dv_acc[b]);
        hp::fence_regs(dk_acc[b]);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcQ / 16; ++j)
#pragma unroll
        for (int b = 0; b < S::kBlocks; ++b) {
          hp::wgmma_rs(dv_acc[b], ap[j],
                       hp::desc_mn_major<D, kTcQ>(dost, b, j));
          hp::wgmma_rs(dk_acc[b], ad[j],
                       hp::desc_mn_major<D, kTcQ>(qst, b, j));
        }
      hp::wgmma_commit();
      hp::wgmma_wait();
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b) {
        hp::fence_regs(dv_acc[b]);
        hp::fence_regs(dk_acc[b]);
      }
    }
    __syncthreads();  // stage st is free for the copy of tile qt + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= tk) continue;
    __nv_bfloat16* krow_o = dk + (koff + krow[h]) * D;
    __nv_bfloat16* vrow_o = dv + (koff + krow[h]) * D;
#pragma unroll
    for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
      for (int i = 0; i < S::kCols / 2; i += 4) {
        const int c = b * S::kCols + 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(krow_o + c) =
            hp::pack_bf16(dk_acc[b][i + 2 * h], dk_acc[b][i + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(vrow_o + c) =
            hp::pack_bf16(dv_acc[b][i + 2 * h], dv_acc[b][i + 2 * h + 1]);
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

// Q and dO (128 rows each), 2 stages of K and V (64 rows each), bf16; then
// with a bias 2 stages of its (128 x 64) tile; 1024 bytes of slack to align
// the tiles to the swizzle atom.
template <int D, bool kBias>
constexpr size_t dq_tc_smem_bytes() {
  return 1024 + 2 * D * (2 * kDqRows + 4 * kDqKeys) +
         (kBias ? 2 * kDqBiasStage : 0);
}

// BT: the bias element type (flash_common.cuh), NoBias without a bias.
// Two blocks a SM where they fit, D <= 64 without a bias (128 registers a
// thread, no spill; 66.5 KB of shared memory): one block's products then
// run under the other's element-wise work, 0.238 against 0.348 ms of
// device time at BERT's shape on an H100 (torch_flash_ab.py).
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
  constexpr int kQBytes = kDqRows * D * 2, kKvBytes = kDqKeys * D * 2;
  constexpr int kBElt = sizeof(BT), kBStride = kDqBiasLd * kBElt;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (hp::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kQBytes;       // [128][D], swizzled, as q_s
  const uint32_t k_s = do_s + kQBytes;       // [2][64][D], swizzled
  const uint32_t v_s = k_s + 2 * kKvBytes;   // [2][64][D], swizzled
  const uint32_t b_s = v_s + 2 * kKvBytes;   // [2][128][kDqBiasLd] bias
  const uint8_t* b_g = smem_raw + (b_s - hp::smem_addr(smem_raw));

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kDqRows, qw0 = q0 + 64 * wg;
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
  const bool b_chunks = kBias && bias_rows_aligned<BT>(bias, tk);
  // d_bias rows written in pairs of keys (8 bytes) when they can be
  const bool db_pairs = kBias && d_bias != nullptr && tk % 2 == 0 &&
                        (reinterpret_cast<uintptr_t>(d_bias) & 7) == 0;
  // tile kt's K, V and bias into ring stage st
  auto copy_kv = [&](int kt, int st) {
    hp::copy_tile<D, kDqKeys, kTcThreads>(k_s + st * kKvBytes, k + koff * D,
                                          kt * kDqKeys, tk, tid);
    hp::copy_tile<D, kDqKeys, kTcThreads>(v_s + st * kKvBytes, v + koff * D,
                                          kt * kDqKeys, tk, tid);
    if constexpr (kBias)
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

  float acc[S::kBlocks][S::kCols / 2];
#pragma unroll
  for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
    for (int i = 0; i < S::kCols / 2; ++i) acc[b][i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kDqKeys, st = kt & 1;
    const uint32_t kst = k_s + st * kKvBytes, vst = v_s + st * kKvBytes;
    if (kt + 1 < n_tiles) {  // the next tile's copy, into the other stage
      copy_kv(kt + 1, st ^ 1);
      hp::cp_async_commit();
      hp::cp_async_wait<1>();
    } else {
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
        if constexpr (kBias) {
          if (i % 2 == 0)  // the pair of keys (kp, kp + 1) of row qrow[h]
            bv = lds_bias2<BT>(b_g + st * kDqBiasStage +
                               ((qrow[h] - q0) * kDqBiasLd + kp - k0) * kBElt);
          x += i % 2 ? bv.y : bv.x;
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
        if (d_bias != nullptr) {
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int h = (i / 2) % 2;
            const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4);
            if (qrow[h] >= tq || kp >= tk) continue;
            float* row = d_bias + (qoff + qrow[h]) * tk;
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
      // the same shared-memory tile
      uint32_t a[kDqKeys / 16][4];
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j) hp::to_a_frag(dp, j, a[j]);
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b) hp::fence_regs(acc[b]);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j)
#pragma unroll
        for (int b = 0; b < S::kBlocks; ++b)
          hp::wgmma_rs(acc[b], a[j], hp::desc_mn_major<D, kDqKeys>(kst, b, j));
      hp::wgmma_commit();
      hp::wgmma_wait();
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b) hp::fence_regs(acc[b]);
    }
    __syncthreads();  // stage st is free for the copy of tile kt + 2
  }

  // d_bias of the key tiles the warpgroup never computed (past kv_valid,
  // above the diagonal): zeros, a warp a row
  if constexpr (kBias) {
    if (d_bias != nullptr && qw0 < tq) {
      const int nr = min(64, tq - qw0), warp = (tid % 128) / 32;
      for (int r = warp; r < nr; r += 4) {
        float* row = d_bias + (qoff + qw0 + r) * tk;
        for (int c = n_wg * kDqKeys + lane; c < tk; c += 32) row[c] = 0.f;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    __nv_bfloat16* row = dq + (qoff + qrow[h]) * D;
#pragma unroll
    for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
      for (int i = 0; i < S::kCols / 2; i += 4) {
        const int c = b * S::kCols + 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(row + c) =
            hp::pack_bf16(acc[b][i + 2 * h], acc[b][i + 2 * h + 1]);
      }
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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

template <int D, bool kBias>
cudaError_t launch_dq(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * kBq * (D + 1) + kBq * kPs + 2 * kBq);
  auto kernel = flash_dq_kernel<D, kBias>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tq + kBq - 1) / kBq, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.bias, a.d_bias,
      a.kv_valid, a.seed, a.tq, a.tk, a.scale, a.causal, a.threshold,
      a.keep_scale);
  return cudaGetLastError();
}

template <int D, bool kBias>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * kBk * (D + 1) + 2 * kBk * kPs + 2 * kBq);
  auto kernel = flash_dkv_kernel<D, kBias>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tk + kBk - 1) / kBk, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.bias, a.kv_valid, a.seed, a.tq, a.tk, a.scale, a.causal,
      a.threshold, a.keep_scale);
  return cudaGetLastError();
}

template <int D, typename BT>
cudaError_t launch_dq_tc(const Args& a) {
  const size_t smem = dq_tc_smem_bytes<D, kHasBias<BT>>();
  auto kernel = flash_dq_tc_kernel<D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tq + kDqRows - 1) / kDqRows, a.bh), kTcThreads, smem,
           a.stream>>>(
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
  const size_t smem = dkv_tc_smem_bytes<D, kHasBias<BT>>();
  auto kernel = flash_dkv_tc_kernel<D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tk + kTcKeys - 1) / kTcKeys, a.bh), kTcThreads, smem,
           a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.bias, a.kv_valid, a.seed, a.tq, a.tk, a.scale, a.causal, a.threshold,
      a.keep_scale);
  return cudaGetLastError();
}

// kKind: 0 dq, 1 dk/dv.  The FFMA kernels (float32) take the bias type at
// run time; the tensor-core kernels (bf16) as a template parameter.
template <int kKind, bool kBias, int D>
cudaError_t launch_ffma(const Args& a) {
  if constexpr (kKind == 0) return launch_dq<D, kBias>(a);
  else return launch_dkv<D, kBias>(a);
}

template <int kKind, typename BT, int D>
cudaError_t launch_tc(const Args& a) {
  if constexpr (kKind == 0) return launch_dq_tc<D, BT>(a);
  else return launch_dkv_tc<D, BT>(a);
}

template <int kKind, bool kBias>
cudaError_t dispatch_ffma_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_ffma<kKind, kBias, 16>(a);
    case 32: return launch_ffma<kKind, kBias, 32>(a);
    case 64: return launch_ffma<kKind, kBias, 64>(a);
    case 128: return launch_ffma<kKind, kBias, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int kKind, typename BT>
cudaError_t dispatch_tc_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_tc<kKind, BT, 16>(a);
    case 32: return launch_tc<kKind, BT, 32>(a);
    case 64: return launch_tc<kKind, BT, 64>(a);
    case 128: return launch_tc<kKind, BT, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int kKind>
cudaError_t dispatch_tc(int d, const Args& a) {
  if (a.bias.ptr == nullptr) return dispatch_tc_d<kKind, NoBias>(d, a);
  if (a.bias.dtype == 1) return dispatch_tc_d<kKind, __nv_bfloat16>(d, a);
  if (a.bias.dtype == 2) return dispatch_tc_d<kKind, __half>(d, a);
  return dispatch_tc_d<kKind, float>(d, a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// float32 runs the FFMA kernel, bfloat16 the tensor-core one (its q, k, v,
// dout and outputs 16-byte aligned); *route is set to the kernel launched.
template <int kKind>
int run(const Args& a, int d, int dtype, const void* out0, const void* out1,
        int* route) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.bh > 65535)
    return cudaErrorInvalidValue;
  if (a.bias.ptr != nullptr &&
      (a.bias.planes < 1 || a.bh % a.bias.planes != 0 || a.bias.dtype < 0 ||
       a.bias.dtype > 2))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    *route = 0;
    return a.bias.ptr != nullptr ? dispatch_ffma_d<kKind, true>(d, a)
                                 : dispatch_ffma_d<kKind, false>(d, a);
  }
  if (dtype == 1) {
    if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
        !aligned16(a.dout) || !aligned16(out0) || !aligned16(out1))
      return cudaErrorInvalidValue;
    *route = 1;
    return dispatch_tc<kKind>(d, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (the FFMA kernels), 1 bfloat16 (the tensor-core
// kernels; q, k, v, dout and the outputs 16-byte aligned).  *route is set
// to the kernel launched: 0 FFMA, 1 wgmma (left as it is when nothing is
// launched).  kv_valid, seed and bias may be null (no key-padding mask; no
// dropout; no bias).  lse and delta are float32 (BH, T).  bias is
// (bias_planes, tq, tk) of bias_dtype (0 float32, 1 bfloat16, 2 float16);
// row bh reads plane bh % bias_planes.  d_bias, float32 (BH, tq, tk), may
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
