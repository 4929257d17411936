// Flash-attention forward for Hopper (sm_90a), float32 FFMA.
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
// q/k/v are float32 or bfloat16, converted to float32 on load; statistics
// and the accumulator stay float32; O is written in q's type, lse in
// float32.
//
// Bound on the H100: operations.  Attention does 4*T*Tk*D*BH floating-point
// operations (QK^T and PV; half that under a causal mask) against
// 2*(2*T + 2*Tk)*D*BH bytes of bf16 q, k, v and o: T operations per byte
// at T = Tk, above the bf16 tensor-core line (989 TFLOP/s over 3.35 TB/s,
// about 295) for T above ~300, and above the float32 line (67 TFLOP/s,
// about 20) for any prompt longer than ~40.  This first version runs them
// as plain float32 FFMA (no tensor cores, no TMA), so its ceiling is the
// 67 TFLOP/s float32 rate, and it stays within float32 rounding of the
// plain version.  A bias adds its planes*T*Tk elements, read once: a
// float32 bias with a plane per row is 402.7 MB at BERT's shape (BH=384,
// T=512), 0.12 ms of device memory, which then bounds the call by bytes.
// Design:
//   - grid (ceil(T/64), BH); 256 threads own a 64-row query tile.  The TPU
//     grid's sequential K axis becomes a loop over 64-row K/V tiles; tiles
//     wholly above the causal diagonal or past kv_valid are never loaded;
//   - Q, K and V tiles are staged in shared memory as float32 (rows padded
//     to D+1 floats so the 16 columns a warp reads fall in 16 banks); each
//     thread computes a 4x4 block of scores and a 4 x D/16 block of the
//     output;
//   - the running (m, l) of each row live in shared memory, the output
//     accumulator in registers; ragged tails are masked, so any T is taken;
//   - the bias tile is staged into the score tile with the K/V tile, so its
//     loads are in flight together with theirs; each thread then adds the
//     elements it owns.  A bias may make real scores -inf, so masked
//     scores are -inf there (not the finite kNegInf) and still get p = 0.
#include "flash_common.cuh"

namespace {

using namespace tmx_flash;

constexpr int kPs = kBk + 1;  // padded probability-row stride

// kDrop: dropout on (seed != null); kBias: a bias (bias.ptr != null).
// Template parameters, so the serving prefill's instance carries neither.
template <int D, typename T, bool kDrop, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + static_cast<long>(bh) * tq * D;
  const T* kb = k + static_cast<long>(bh) * tk * D;
  const T* vb = v + static_cast<long>(bh) * tk * D;
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
        q0 + r < tq ? to_f32(qb[static_cast<long>(q0 + r) * D + d]) : 0.f;
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
      T* orow = o + (static_cast<long>(bh) * tq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
  }
  if (tid < kBq && q0 + tid < tq)
    lse[static_cast<long>(bh) * tq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
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

template <int D, typename T, bool kDrop, bool kBias>
cudaError_t launch(const Args& a) {
  const size_t smem = sizeof(float) * (kBq * (D + 1) + kBk * (D + 1) +
                                       kBk * D + kBq * kPs + 3 * kBq);
  auto kernel = flash_fwd_kernel<D, T, kDrop, kBias>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((a.tq + kBq - 1) / kBq, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.kv_valid,
      a.seed, a.bias, a.tq, a.tk, a.scale, a.causal, a.threshold,
      a.keep_scale);
  return cudaGetLastError();
}

template <typename T, bool kDrop, bool kBias>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<16, T, kDrop, kBias>(a);
    case 32: return launch<32, T, kDrop, kBias>(a);
    case 64: return launch<64, T, kDrop, kBias>(a);
    case 128: return launch<128, T, kDrop, kBias>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int d, const Args& a) {
  const bool drop = a.seed != nullptr, biased = a.bias.ptr != nullptr;
  if (drop && biased) return dispatch_d<T, true, true>(d, a);
  if (drop) return dispatch_d<T, true, false>(d, a);
  if (biased) return dispatch_d<T, false, true>(d, a);
  return dispatch_d<T, false, false>(d, a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  kv_valid, seed and bias may be null (no
// key-padding mask; no dropout; no bias).  bias is (bias_planes, tq, tk)
// of bias_dtype (0 float32, 1 bfloat16, 2 float16); row bh reads plane
// bh % bias_planes.
extern "C" int tmx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const void* bias, int bias_planes,
                                       int bias_dtype, const int* kv_valid,
                                       const int* seed, int bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       uint32_t threshold, float keep_scale,
                                       int dtype, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535) return cudaErrorInvalidValue;
  if (bias != nullptr && (bias_planes < 1 || bh % bias_planes != 0 ||
                          bias_dtype < 0 || bias_dtype > 2))
    return cudaErrorInvalidValue;
  Args a{q,         k,          v,     o,
         lse,       kv_valid,   seed,  {bias, bias_planes, bias_dtype},
         bh,        tq,         tk,    scale,
         causal,    threshold,  keep_scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(d, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(d, a);
  return cudaErrorInvalidValue;
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
