// Flash-attention backward for Hopper (sm_90a), float32 FFMA: two kernels.
//
// Replaces the backward Pallas TPU kernels of tpu_mx/kernels/
// flash_attention.py, both launched by _bwd:
//   - flash_dq_kernel  <- _bwd_dq_kernel:  dq = ds K, with
//       s  = q k^T * scale (masked),  p = exp(s - lse),  dp = dO V^T,
//       dp <- z/(1-r) * dp  (the regenerated keep mask z),
//       ds = p o (dp - delta) * scale;
//   - flash_dkv_kernel <- _bwd_dkv_kernel: dv = (z/(1-r) * p)^T dO and
//       dk = ds^T q.
// delta = rowsum(dO o O) (float32, (BH, T)) and lse come from the caller,
// as in the reference.  The masks (causal, kv_valid) and the keep mask are
// those of the forward (flash_common.cuh), so the three kernels agree bit
// for bit on which probabilities were dropped.  Inputs are float32 or
// bfloat16, converted to float32 on load; accumulators are float32; dq,
// dk and dv are written in q's type.
// With an additive bias (flash_common.cuh) both kernels add it to the
// scaled scores before the masks, as the forward does, and the dq kernel
// can also write d_bias = p o (dp - delta) (_bwd_dq_kernel: ds before its
// scale), a (BH, T, Tk) float32 array that the caller reduces to the
// bias's shape.  d_bias is not pre-zeroed, so the dq kernel writes every
// element of its rows: masked columns and the key tiles it never visits
// (past kv_valid, above the causal diagonal) get 0.
//
// Bound on the H100: operations.  Non-causal, dq does 3 products of
// 2*T*Tk_valid*D operations per head (QK^T, dO V^T, dS K) and dk/dv 4
// (QK^T, dO V^T, P^T dO, dS^T Q), against a few bytes per element of
// q, k, v, dO, dq, dk, dv: far above the float32 line (about 20 operations
// per byte) at BERT's T = 512.  As in the forward, this first version
// runs them as plain float32 FFMA, so its ceiling is 67 TFLOP/s.
// Design:
//   - dq: grid (ceil(T/64), BH); 256 threads own 64 query rows, with their
//     q and dO staged in shared memory, and loop over 64-row K/V tiles up
//     to ceil(valid/64) (and the causal diagonal).  Each thread computes a
//     4x4 block of s and dp, writes ds to shared memory, and accumulates a
//     4 x D/16 block of dq in registers;
//     With a bias, its tile is staged into the ds tile with K and V, and
//     d_bias is written from registers (16 consecutive keys a half-warp);
//   - dk/dv: grid (ceil(Tk/64), BH); 256 threads own 64 key rows, with
//     their k and v staged, and loop over 64-row Q tiles (from the
//     diagonal when causal).  They compute the transposed scores, write
//     the dropped probabilities and ds transposed to shared memory, and
//     accumulate 4 x D/16 blocks of dk and dv.  Key tiles wholly past
//     kv_valid run no Q tile and write zeros; key rows past kv_valid in a
//     partial tile get p = ds = 0, hence zeros too (the outputs are not
//     pre-zeroed).  With a bias, its tile is staged transposed into the p
//     tile, read along the key axis so that the loads coalesce.
#include "flash_common.cuh"

namespace {

using namespace tmx_flash;

constexpr int kPs = kBk + 1;  // padded row stride of the ds / p tiles

// kBias: a bias (bias.ptr != null); d_bias may then be null (not wanted).
template <int D, typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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
      T* row = dq + (qoff + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j]);
    }
  }
}

template <int D, typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Bias bias,
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
      T* krow = dk + (koff + k0 + r) * D;
      T* vrow = dv + (koff + k0 + r) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        krow[tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
        vrow[tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
      }
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

template <int D, typename T, bool kBias>
cudaError_t launch_dq(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * kBq * (D + 1) + kBq * kPs + 2 * kBq);
  auto kernel = flash_dq_kernel<D, T, kBias>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tq + kBq - 1) / kBq, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.bias, a.d_bias, a.kv_valid, a.seed,
      a.tq, a.tk, a.scale, a.causal, a.threshold, a.keep_scale);
  return cudaGetLastError();
}

template <int D, typename T, bool kBias>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * kBk * (D + 1) + 2 * kBk * kPs + 2 * kBq);
  auto kernel = flash_dkv_kernel<D, T, kBias>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.tk + kBk - 1) / kBk, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.bias,
      a.kv_valid, a.seed, a.tq, a.tk, a.scale, a.causal, a.threshold,
      a.keep_scale);
  return cudaGetLastError();
}

template <bool kDq, typename T, bool kBias>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16:
      return kDq ? launch_dq<16, T, kBias>(a) : launch_dkv<16, T, kBias>(a);
    case 32:
      return kDq ? launch_dq<32, T, kBias>(a) : launch_dkv<32, T, kBias>(a);
    case 64:
      return kDq ? launch_dq<64, T, kBias>(a) : launch_dkv<64, T, kBias>(a);
    case 128:
      return kDq ? launch_dq<128, T, kBias>(a) : launch_dkv<128, T, kBias>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq, typename T>
cudaError_t dispatch_bias(int d, const Args& a) {
  if (a.bias.ptr != nullptr) return dispatch_d<kDq, T, true>(d, a);
  return dispatch_d<kDq, T, false>(d, a);
}

template <bool kDq>
int dispatch(int d, int dtype, const Args& a) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.bh > 65535)
    return cudaErrorInvalidValue;
  if (a.bias.ptr != nullptr &&
      (a.bias.planes < 1 || a.bh % a.bias.planes != 0 || a.bias.dtype < 0 ||
       a.bias.dtype > 2))
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_bias<kDq, float>(d, a);
  if (dtype == 1) return dispatch_bias<kDq, __nv_bfloat16>(d, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  kv_valid, seed and bias may be null (no
// key-padding mask; no dropout; no bias).  lse and delta are float32
// (BH, T).  bias is (bias_planes, tq, tk) of bias_dtype (0 float32,
// 1 bfloat16, 2 float16); row bh reads plane bh % bias_planes.  d_bias,
// float32 (BH, tq, tk), may be null when there is a bias and its gradient
// is not wanted.
extern "C" int tmx_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const void* bias,
    int bias_planes, int bias_dtype, float* d_bias, const int* kv_valid,
    const int* seed, int bh, int tq, int tk, int d, float scale, int causal,
    uint32_t threshold, float keep_scale, int dtype, void* stream) {
  Args a{q,         k,          v,       dout,
         lse,       delta,      dq,      nullptr,
         nullptr,   {bias, bias_planes, bias_dtype},
         d_bias,    kv_valid,   seed,    bh,
         tq,        tk,         scale,   causal,
         threshold, keep_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(d, dtype, a);
}

extern "C" int tmx_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const void* bias, int bias_planes, int bias_dtype, const int* kv_valid,
    const int* seed, int bh, int tq, int tk, int d, float scale, int causal,
    uint32_t threshold, float keep_scale, int dtype, void* stream) {
  Args a{q,         k,          v,       dout,
         lse,       delta,      nullptr, dk,
         dv,        {bias, bias_planes, bias_dtype},
         nullptr,   kv_valid,   seed,    bh,
         tq,        tk,         scale,   causal,
         threshold, keep_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(d, dtype, a);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
