// Flash-attention backward for Hopper (sm_90a) at head dims of 320 and
// more: the dq and dk/dv kernels, one runtime-D instance a kernel and dtype,
// D passed as an argument (any multiple of 64), a translation unit and a
// library of its own.
//
// Replaces, at those head dims, the backward Pallas TPU kernels of
// tpu_mx/kernels/flash_attention.py (_bwd_dq_kernel and _bwd_dkv_kernel,
// launched by _bwd), whose gate takes any head dim that is a multiple of
// 64.  The arithmetic per score element is that of flash_attention_bwd.cu's
// float32 kernels (its header says what each step does):
//   s = q k^T * scale + bias (masked), p = exp(s - lse), dp = dO V^T,
//   dp <- z/(1-r) dp, d_bias = p o (dp - delta), ds = d_bias * scale,
//   dq = ds K, dv = (z/(1-r) p)^T dO, dk = ds^T q;
// d_bias, dk and dv are written whole (zeros where nothing was computed),
// as there.
//
// Design (flash_dn.cuh says why the templated instances stop at 256):
//   - dq: grid (ceil(T/64), BH, D/64); 4 warps of 16 query rows; block z
//     accumulates dQ's columns [64z, 64z + 64) and block z = 0 writes
//     d_bias.  For each key tile of 64 keys, S = Q K^T and dP = dO V^T are
//     summed over D in 64-column chunks of Q, K, dO and V streamed through
//     shared memory (four 64 x 64 tiles), dS is computed on the registers,
//     then the block's 64 columns of the K tile are copied and dQ += dS K;
//   - dk/dv: grid (ceil(Tk/64), BH, D/64); 4 warps of 16 key rows; block z
//     accumulates dK's and dV's columns [64z, 64z + 64).  For each query
//     tile of 64 queries (from the diagonal when causal), S^T = K Q^T and
//     dP^T = V dO^T are summed over D in 64-column chunks, the query tile's
//     lse and delta staged beside them, P^T and dS^T computed on the
//     registers (the query index is the column), then the block's 64
//     columns of the dO and Q tiles are copied and dV += P^T dO,
//     dK += dS^T Q;
//   - every column block recomputes S and dP: D/64 times the score
//     products of a kernel that keeps all of dQ (dK, dV) resident.
// Bound on the H100: operations.  dq does 2*T*Tk*D*BH*(2*D/64 + 1) and
// dk/dv 2*T*Tk*D*BH*(2*D/64 + 2) against 6 and 8 T*Tk*D*BH for one pass
// (about half of each under a causal mask): 5.67x and 4.5x at D = 512.
// bf16 on mma.sync.m16n8k16, float32 on 3xTF32 (flash_dn.cuh).
// The C entry points send bfloat16 to the mma.sync kernels (route 3) and
// float32 to the 3xTF32 ones (route 2); nothing else falls back.
#include "flash_dn.cuh"

namespace hp = tmx_hopper;

namespace {

using namespace tmx_dn;

template <typename T>
constexpr size_t dq_smem_bytes() {
  return 4 * tile_bytes<T>();  // Q, dO, K, V chunks
}

template <typename T>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO chunks, then the query tile's lse and delta
  return 4 * tile_bytes<T>() + 2 * sizeof(float) * kRows;
}

// T: float or __nv_bfloat16; BT: the bias element type, NoBias without a
// bias.
template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_dn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       Bias bias, float* __restrict__ d_bias,
                       const int* __restrict__ kv_valid,
                       const int* __restrict__ seed, int tq, int tk, int d,
                       float scale, int causal, uint32_t threshold,
                       float keep_scale) {
  constexpr bool kBias = kHasBias<BT>;
  constexpr int L = kLd<T>;
  extern __shared__ float4 smem_f4[];
  T* q_s = reinterpret_cast<T*>(smem_f4);  // [64][L] each
  T* do_s = q_s + kRows * L;
  T* k_s = do_s + kRows * L;
  T* v_s = k_s + kRows * L;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows, qw0 = q0 + 16 * warp;
  const int c0 = blockIdx.z * kChunk;  // the block's dQ columns
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
  if (c0 != 0) d_bias = nullptr;  // block z = 0 writes d_bias

  // the key tiles of rows below `end`: up to kv_valid, and to the diagonal
  // when causal.  A warp computes a prefix of the block's tiles.
  const int n_valid = (valid + kChunk - 1) / kChunk;
  auto tiles_below = [&](int end) {
    return causal ? min(n_valid, (end - 1) / kChunk + 1) : n_valid;
  };
  const int n_tiles = tiles_below(min(q0 + kRows, tq));
  const int n_w = qw0 < tq ? tiles_below(min(qw0 + 16, tq)) : 0;

  float acc[8][4], s[8][4], dp[8][4];
  zero(acc);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kChunk;
    const bool skip = kt >= n_w;
    zero(s);
    zero(dp);
    for (int c = 0; c < d; c += kChunk) {
      __syncthreads();  // every warp is done with the tiles' last chunk
      copy_chunk<T>(hp::smem_addr(q_s), q + qoff * d, q0, tq, d, c, tid);
      copy_chunk<T>(hp::smem_addr(do_s), dout + qoff * d, q0, tq, d, c, tid);
      copy_chunk<T>(hp::smem_addr(k_s), k + koff * d, k0, tk, d, c, tid);
      copy_chunk<T>(hp::smem_addr(v_s), v + koff * d, k0, tk, d, c, tid);
      chunk_ready();
      if (!skip) {
        score_chunk<T>(s, q_s + 16 * warp * L, k_s, g, t);
        score_chunk<T>(dp, do_s + 16 * warp * L, v_s, g, t);
      }
    }
    __syncthreads();
    copy_chunk<T>(hp::smem_addr(k_s), k + koff * d, k0, tk, d, c0, tid);
    chunk_ready();
    if (skip) continue;

    // s <- d_bias = p (z/(1-r) dp - delta); dS is d_bias * scale
#pragma unroll
    for (int j = 0; j < 8; ++j)
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
    if constexpr (kBias) {
      if (d_bias != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kp = k0 + 8 * j + 2 * t;
            if (qrow[h] >= tq || kp >= tk) continue;
            float* row = d_bias + (qoff + qrow[h]) * tk;
            row[kp] = s[j][2 * h];
            if (kp + 1 < tk) row[kp + 1] = s[j][2 * h + 1];
          }
        __syncwarp();  // converged again before the warp's mma.sync
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= scale;
    out_chunk<T>(acc, s, k_s, g, t);
  }

  // d_bias of the key tiles the warp never computed (past kv_valid, above
  // the diagonal): zeros, a row at a time over the warp's lanes
  if constexpr (kBias) {
    if (d_bias != nullptr) {
      for (int r = 0; r < 16 && qw0 + r < tq; ++r) {
        float* row = d_bias + (qoff + qw0 + r) * tk;
        for (int c = n_w * kChunk + lane; c < tk; c += 32) row[c] = 0.f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    T* orow = dq + (qoff + qrow[h]) * d + c0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store2(orow + 8 * n + 2 * t, acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_dn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, Bias bias,
                        const int* __restrict__ kv_valid,
                        const int* __restrict__ seed, int tq, int tk, int d,
                        float scale, int causal, uint32_t threshold,
                        float keep_scale) {
  constexpr bool kBias = kHasBias<BT>;
  constexpr int L = kLd<T>;
  extern __shared__ float4 smem_f4[];
  T* k_s = reinterpret_cast<T*>(smem_f4);  // [64][L] each
  T* v_s = k_s + kRows * L;
  T* q_s = v_s + kRows * L;
  T* do_s = q_s + kRows * L;
  float* lse_s = reinterpret_cast<float*>(do_s + kRows * L);  // [64]
  float* dl_s = lse_s + kRows;                                // [64] delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows, kw0 = k0 + 16 * warp;
  const int c0 = blockIdx.z * kChunk;  // the block's dK and dV columns
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

  // a key tile wholly past kv_valid runs no query tile and writes zeros
  const int n_qt = k0 < valid ? (tq + kChunk - 1) / kChunk : 0;
  const int qt0 = causal ? k0 / kChunk : 0;
  const bool keys_in = kw0 < valid;  // the warp holds a valid key

  float dk_acc[8][4], dv_acc[8][4], s[8][4], dp[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kChunk;
    const bool skip = !keys_in || (causal && q0 + kChunk - 1 < kw0);
    zero(s);
    zero(dp);
    for (int c = 0; c < d; c += kChunk) {
      __syncthreads();  // every warp is done with the tiles' last chunk
      copy_chunk<T>(hp::smem_addr(k_s), k + koff * d, k0, tk, d, c, tid);
      copy_chunk<T>(hp::smem_addr(v_s), v + koff * d, k0, tk, d, c, tid);
      copy_chunk<T>(hp::smem_addr(q_s), q + qoff * d, q0, tq, d, c, tid);
      copy_chunk<T>(hp::smem_addr(do_s), dout + qoff * d, q0, tq, d, c, tid);
      if (c == 0) {
        hp::copy_floats(hp::smem_addr(lse_s), lse + qoff + q0, kRows,
                        tq - q0, tid);
        hp::copy_floats(hp::smem_addr(dl_s), delta + qoff + q0, kRows,
                        tq - q0, tid - kRows);
      }
      chunk_ready();
      if (!skip) {
        // transposed scores: key rows, query columns
        score_chunk<T>(s, k_s + 16 * warp * L, q_s, g, t);
        score_chunk<T>(dp, v_s + 16 * warp * L, do_s, g, t);
      }
    }

    // s <- the dropped p^T, dp <- ds^T = p^T o (z/(1-r) dp^T - delta) scale
    if (!skip) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cq = 8 * j + 2 * t + e, qp = q0 + cq;
          const float lq = lse_s[cq], dlq = dl_s[cq];
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
    }
    __syncthreads();  // lse and delta are read; the tiles are free
    copy_chunk<T>(hp::smem_addr(q_s), q + qoff * d, q0, tq, d, c0, tid);
    copy_chunk<T>(hp::smem_addr(do_s), dout + qoff * d, q0, tq, d, c0, tid);
    chunk_ready();
    if (skip) continue;
    out_chunk<T>(dv_acc, s, do_s, g, t);
    out_chunk<T>(dk_acc, dp, q_s, g, t);
  }

  // key rows past kv_valid (or in a tile that ran no query tile) hold 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= tk) continue;
    T* krow_o = dk + (koff + krow[h]) * d + c0;
    T* vrow_o = dv + (koff + krow[h]) * d + c0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store2(krow_o + 8 * n + 2 * t, dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      store2(vrow_o + 8 * n + 2 * t, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
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
  int bh, tq, tk, d;
  float scale;
  int causal;
  uint32_t threshold;
  float keep_scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// kKind: 0 dq, 1 dk/dv.
template <int kKind, typename T, typename BT>
cudaError_t launch(const Args& a) {
  if constexpr (kKind == 0) {
    constexpr size_t smem = dq_smem_bytes<T>();
    auto kernel = flash_dq_dn_kernel<T, BT>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.tq + kRows - 1) / kRows, a.bh, a.d / kChunk), kThreads,
             smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(a.dq), a.bias, a.d_bias, a.kv_valid, a.seed,
        a.tq, a.tk, a.d, a.scale, a.causal, a.threshold, a.keep_scale);
  } else {
    constexpr size_t smem = dkv_smem_bytes<T>();
    auto kernel = flash_dkv_dn_kernel<T, BT>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.tk + kRows - 1) / kRows, a.bh, a.d / kChunk), kThreads,
             smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.bias,
        a.kv_valid, a.seed, a.tq, a.tk, a.d, a.scale, a.causal, a.threshold,
        a.keep_scale);
  }
  return cudaGetLastError();
}

template <int kKind, typename T>
cudaError_t dispatch(const Args& a) {
  if (a.bias.ptr == nullptr) return launch<kKind, T, NoBias>(a);
  if (a.bias.dtype == 1) return launch<kKind, T, __nv_bfloat16>(a);
  if (a.bias.dtype == 2) return launch<kKind, T, __half>(a);
  return launch<kKind, T, float>(a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kKind>
int run(const Args& a, int dtype, const void* out0, const void* out1,
        int* route) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.bh > 65535 || a.d < kChunk ||
      a.d % kChunk != 0 || a.d / kChunk > 65535)
    return cudaErrorInvalidValue;
  if (a.bias.ptr != nullptr &&
      (a.bias.planes < 1 || a.bh % a.bias.planes != 0 || a.bias.dtype < 0 ||
       a.bias.dtype > 2))
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.dout) || !aligned16(out0) || !aligned16(out1))
    return cudaErrorInvalidValue;
  *route = dtype == 0 ? 2 : 3;
  return dtype == 0 ? dispatch<kKind, float>(a)
                    : dispatch<kKind, __nv_bfloat16>(a);
}

}  // namespace

// The C interface of flash_attention_bwd.cu, for any head dim d that is a
// positive multiple of 64.  dtype: 0 float32 (3xTF32 kernels, *route = 2),
// 1 bfloat16 (mma.sync kernels, *route = 3).
extern "C" int tmx_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const void* bias,
    int bias_planes, int bias_dtype, float* d_bias, const int* kv_valid,
    const int* seed, int bh, int tq, int tk, int d, float scale, int causal,
    uint32_t threshold, float keep_scale, int dtype, void* stream,
    int* route) {
  Args a{q,       k,       v,        dout,    lse,
         delta,   dq,      nullptr,  nullptr, {bias, bias_planes, bias_dtype},
         d_bias,  kv_valid, seed,    bh,      tq,
         tk,      d,       scale,    causal,  threshold,
         keep_scale, static_cast<cudaStream_t>(stream)};
  return run<0>(a, dtype, dq, dq, route);
}

extern "C" int tmx_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const void* bias, int bias_planes, int bias_dtype, const int* kv_valid,
    const int* seed, int bh, int tq, int tk, int d, float scale, int causal,
    uint32_t threshold, float keep_scale, int dtype, void* stream,
    int* route) {
  Args a{q,       k,       v,        dout,    lse,
         delta,   nullptr, dk,       dv,      {bias, bias_planes, bias_dtype},
         nullptr, kv_valid, seed,    bh,      tq,
         tk,      d,       scale,    causal,  threshold,
         keep_scale, static_cast<cudaStream_t>(stream)};
  return run<1>(a, dtype, dk, dv, route);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
