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
// plain version.
// Design:
//   - grid (ceil(T/64), BH); 256 threads own a 64-row query tile.  The TPU
//     grid's sequential K axis becomes a loop over 64-row K/V tiles; tiles
//     wholly above the causal diagonal or past kv_valid are never loaded;
//   - Q, K and V tiles are staged in shared memory as float32 (rows padded
//     to D+1 floats so the 16 columns a warp reads fall in 16 banks); each
//     thread computes a 4x4 block of scores and a 4 x D/16 block of the
//     output;
//   - the running (m, l) of each row live in shared memory, the output
//     accumulator in registers; ragged tails are masked, so any T is taken.
#include "flash_common.cuh"

namespace {

using namespace tmx_flash;

constexpr int kPs = kBk + 1;  // padded probability-row stride

// kDrop: dropout on (seed != null); a template parameter, so the serving
// prefill's instance carries no per-element dropout code.
template <int D, typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_valid,
                     const int* __restrict__ seed, int tq, int tk, float scale,
                     int causal, uint32_t threshold, float keep_scale) {
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
        p_s[r * kPs + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax over row srow.  Masked scores (kNegInf) get
       // p = exp(kNegInf - m) = 0 exactly: every row's m is finite from
       // the first tile on, which always holds key 0 (kv_valid >= 1).
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

template <int D, typename T, bool kDrop>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kv_valid, const int* seed, int bh,
                   int tq, int tk, float scale, int causal, uint32_t threshold,
                   float keep_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBq * (D + 1) + kBk * (D + 1) +
                                       kBk * D + kBq * kPs + 3 * kBq);
  auto kernel = flash_fwd_kernel<D, T, kDrop>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((tq + kBq - 1) / kBq, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kv_valid, seed, tq,
      tk, scale, causal, threshold, keep_scale);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, float* lse, const int* kv_valid, const int* seed,
                     int bh, int tq, int tk, float scale, int causal,
                     uint32_t threshold, float keep_scale, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<16, T, kDrop>(q, k, v, o, lse, kv_valid, seed, bh, tq, tk,
                                  scale, causal, threshold, keep_scale, s);
    case 32:
      return launch<32, T, kDrop>(q, k, v, o, lse, kv_valid, seed, bh, tq, tk,
                                  scale, causal, threshold, keep_scale, s);
    case 64:
      return launch<64, T, kDrop>(q, k, v, o, lse, kv_valid, seed, bh, tq, tk,
                                  scale, causal, threshold, keep_scale, s);
    case 128:
      return launch<128, T, kDrop>(q, k, v, o, lse, kv_valid, seed, bh, tq,
                                   tk, scale, causal, threshold, keep_scale,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_drop(int d, const void* q, const void* k, const void* v,
                          void* o, float* lse, const int* kv_valid,
                          const int* seed, int bh, int tq, int tk,
                          float scale, int causal, uint32_t threshold,
                          float keep_scale, cudaStream_t s) {
  if (seed != nullptr)
    return dispatch<T, true>(d, q, k, v, o, lse, kv_valid, seed, bh, tq, tk,
                             scale, causal, threshold, keep_scale, s);
  return dispatch<T, false>(d, q, k, v, o, lse, kv_valid, seed, bh, tq, tk,
                            scale, causal, threshold, keep_scale, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  kv_valid and seed may be null (no
// key-padding mask; no dropout).
extern "C" int tmx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const int* kv_valid, const int* seed,
                                       int bh, int tq, int tk, int d,
                                       float scale, int causal,
                                       uint32_t threshold, float keep_scale,
                                       int dtype, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_drop<float>(d, q, k, v, o, lse, kv_valid, seed, bh, tq,
                                tk, scale, causal, threshold, keep_scale, s);
  if (dtype == 1)
    return dispatch_drop<__nv_bfloat16>(d, q, k, v, o, lse, kv_valid, seed,
                                        bh, tq, tk, scale, causal, threshold,
                                        keep_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
