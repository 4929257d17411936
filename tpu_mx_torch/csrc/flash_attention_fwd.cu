// Flash-attention forward for Hopper (sm_90a), float32 FFMA.
//
// Replaces the forward Pallas TPU kernel tpu_mx/kernels/flash_attention.py::
// _fwd_kernel (launched by _fwd): O = softmax(q k^T * scale [causal]) v over
// (BH, T, D) tensors, blockwise with an online softmax, plus the per-row
// logsumexp that the backward kernels (a later slice) will read.  The
// causal mask is the reference's: query row i sees key columns j <= i.
//
// Bound on the H100: operations.  Causal attention does about 2*T*T*D*BH
// floating-point operations (QK^T and PV over the half of the square below
// the diagonal) against 16*T*D*BH bytes of q, k, v and o: T/8 operations
// per byte, above the float32 line (67 TFLOP/s over 3.35 TB/s, about 20)
// for any prompt longer than 160.  This first version runs them as plain
// float32 FFMA (no TF32, no wgmma), so its ceiling is the 67 TFLOP/s
// float32 rate and it stays within float32 rounding of the reference.
// Design:
//   - grid (ceil(T/64), BH); 256 threads own a 64-row query tile.  The TPU
//     grid's sequential K axis becomes a loop over 64-row K/V tiles, and
//     tiles wholly above the causal diagonal are never loaded;
//   - Q, K and V tiles are staged in shared memory (rows padded to D+1
//     floats so the 16 columns a warp reads fall in 16 banks); each thread
//     computes a 4x4 block of scores and a 4 x D/16 block of the output;
//   - the running (m, l) of each row live in shared memory, the output
//     accumulator in registers; the ragged tail (T not a multiple of 64) is
//     masked, so any T is taken.
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;
constexpr int kPs = kBk + 1;       // padded probability-row stride
constexpr float kNegInf = -1e30f;  // finite, as in the reference

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, float scale,
                     int causal) {
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

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r * QS + d] = q0 + r < tq ? qb[static_cast<long>(q0 + r) * D + d] : 0.f;
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

  int n_tiles = (tk + kBk - 1) / kBk;
  if (causal) n_tiles = min(n_tiles, (q0 + kBq - 1) / kBk + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBk * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < tk;
      const long at = static_cast<long>(k0 + r) * D + d;
      k_s[r * QS + d] = ok ? kb[at] : 0.f;
      v_s[r * D + d] = ok ? vb[at] : 0.f;
    }
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
        const bool ok = kpos < tk && (!causal || kpos <= q0 + r);
        p_s[r * kPs + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: 4 neighbouring lanes share one row
      const int r = tid / 4, part = tid % 4;
      float mx = kNegInf;
      for (int j = 0; j < kBk / 4; ++j)
        mx = fmaxf(mx, p_s[r * kPs + part + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < kBk / 4; ++j) {
        const float p = expf(p_s[r * kPs + part + 4 * j] - m_new);
        p_s[r * kPs + part + 4 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
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

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int tq, int tk, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBq * (D + 1) + kBk * (D + 1) +
                                       kBk * D + kBq * kPs + 3 * kBq);
  auto kernel = flash_fwd_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((tq + kBq - 1) / kBq, bh), kThreads, smem, stream>>>(
      q, k, v, o, lse, tq, tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tmx_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int bh, int tq, int tk, int d,
                                       float scale, int causal,
                                       void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    case 32:
      return launch<32>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    case 64:
      return launch<64>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
