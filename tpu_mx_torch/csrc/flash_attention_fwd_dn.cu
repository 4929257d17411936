// Flash-attention forward for Hopper (sm_90a) at head dims of 320 and more:
// one runtime-D instance a dtype, D passed as an argument (any multiple of
// 64), a translation unit and a library of its own.
//
// Replaces, at those head dims, the forward Pallas TPU kernel
// tpu_mx/kernels/flash_attention.py::_fwd_kernel (launched by _fwd), whose
// gate supported() takes any head dim that is a multiple of 64: O =
// softmax(q k^T * scale [masks]) v over (BH, T, D) tensors with the per-row
// logsumexp, the masks, dropout and bias of flash_attention_fwd.cu (its
// header says what each does), computed the same way per score element.
//
// Design (flash_dn.cuh says why the templated instances stop at 256):
//   - grid (ceil(T/64), BH, D/64); 128 threads, 4 warps of 16 query rows;
//     block z accumulates O's columns [64z, 64z + 64) in 32 float32
//     registers a thread; block z = 0 writes lse;
//   - for each key tile of 64 keys (up to kv_valid, to the diagonal when
//     causal), S = Q K^T is summed over D in 64-column chunks of Q and K
//     streamed through shared memory (two 64 x 64 tiles), then the online
//     softmax runs on S's registers as in the templated instances (row max
//     and sum over the quad by two __shfl_xor_sync, masks, the dropout keep
//     bit, the bias read from device memory in its own type), then the
//     block's 64 columns of the V tile are copied and O += P V;
//   - every column block recomputes S and the statistics: the score
//     products are done D/64 times (the recompute; PERF.md has its cost).
// Bound on the H100: operations once T passes a few hundred.  The single
// pass does 4*T*Tk*D*BH (about half under a causal mask); this design does
// 2*T*Tk*D*BH*(D/64) + 2*T*Tk*D*BH, 4.5x at D = 512.  bf16 runs
// mma.sync.m16n8k16 at up to the 989 TFLOP/s rate; float32 three TF32
// products a product at 495.
// The C entry point sends bfloat16 to the mma.sync kernel (route 3) and
// float32 to the 3xTF32 one (route 2); nothing else falls back.
#include "flash_dn.cuh"

namespace hp = tmx_hopper;

namespace {

using namespace tmx_dn;

template <typename T>
constexpr size_t fwd_smem_bytes() {
  return 2 * tile_bytes<T>();  // the Q (later V) tile and the K tile
}

// T: float or __nv_bfloat16 (q, k, v and o); BT: the bias element type
// (flash_common.cuh), NoBias without a bias.
template <typename T, bool kDrop, typename BT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_dn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse,
                        const int* __restrict__ kv_valid,
                        const int* __restrict__ seed, Bias bias, int tq,
                        int tk, int d, float scale, int causal,
                        uint32_t threshold, float keep_scale) {
  constexpr bool kBias = kHasBias<BT>;
  constexpr int L = kLd<T>;
  extern __shared__ float4 smem_f4[];
  T* a_s = reinterpret_cast<T*>(smem_f4);  // [64][L]: a Q chunk, a V chunk
  T* b_s = a_s + kRows * L;                // [64][L]: a K chunk
  const uint32_t a_a = hp::smem_addr(a_s), b_a = hp::smem_addr(b_s);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows, qw0 = q0 + 16 * warp;
  const int c0 = blockIdx.z * kChunk;  // the block's output columns
  const int qrow[2] = {qw0 + g, qw0 + g + 8};
  const T* qb = q + static_cast<long>(bh) * tq * d;
  const T* kb = k + static_cast<long>(bh) * tk * d;
  const T* vb = v + static_cast<long>(bh) * tk * d;
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
  int n_tiles = (valid + kChunk - 1) / kChunk;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRows, tq) - 1) / kChunk + 1);
  const bool rows_in = qw0 < tq;  // the warp holds rows below T

  float acc[8][4], s[8][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kChunk;
    const bool skip = !rows_in || (causal && k0 > qw0 + 15);
    zero(s);
    for (int c = 0; c < d; c += kChunk) {
      __syncthreads();  // every warp is done with the tiles' last chunk
      copy_chunk<T>(a_a, qb, q0, tq, d, c, tid);
      copy_chunk<T>(b_a, kb, k0, tk, d, c, tid);
      chunk_ready();
      if (!skip) score_chunk<T>(s, a_s + 16 * warp * L, b_s, g, t);
    }
    __syncthreads();
    copy_chunk<T>(a_a, vb, k0, tk, d, c0, tid);
    chunk_ready();
    if (skip) continue;

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
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
    for (int j = 0; j < 8; ++j)
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
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i / 2];
    out_chunk<T>(acc, s, a_s, g, t);
  }

  if (!rows_in) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    T* orow = o + (static_cast<long>(bh) * tq + qrow[h]) * d + c0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store2(orow + 8 * n + 2 * t, acc[n][2 * h] * inv,
             acc[n][2 * h + 1] * inv);
    if (t == 0 && c0 == 0)
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
  int bh, tq, tk, d;
  float scale;
  int causal;
  uint32_t threshold;
  float keep_scale;
  cudaStream_t stream;
};

template <typename T, bool kDrop, typename BT>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = fwd_smem_bytes<T>();
  auto kernel = flash_fwd_dn_kernel<T, kDrop, BT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((a.tq + kRows - 1) / kRows, a.bh, a.d / kChunk), kThreads,
           smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.kv_valid,
      a.seed, a.bias, a.tq, a.tk, a.d, a.scale, a.causal, a.threshold,
      a.keep_scale);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t dispatch_bias(const Args& a) {
  if (a.bias.ptr == nullptr) return launch<T, kDrop, NoBias>(a);
  if (a.bias.dtype == 1) return launch<T, kDrop, __nv_bfloat16>(a);
  if (a.bias.dtype == 2) return launch<T, kDrop, __half>(a);
  return launch<T, kDrop, float>(a);
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  return a.seed != nullptr ? dispatch_bias<T, true>(a)
                           : dispatch_bias<T, false>(a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The C interface of flash_attention_fwd.cu, for any head dim d that is a
// positive multiple of 64.  dtype: 0 float32 (3xTF32 kernel, *route = 2),
// 1 bfloat16 (mma.sync kernel, *route = 3); q, k, v and o 16-byte aligned.
extern "C" int tmx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const void* bias, int bias_planes,
                                       int bias_dtype, const int* kv_valid,
                                       const int* seed, int bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       uint32_t threshold, float keep_scale,
                                       int dtype, void* stream, int* route) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535 || d < kChunk ||
      d % kChunk != 0 || d / kChunk > 65535)
    return cudaErrorInvalidValue;
  if (bias != nullptr && (bias_planes < 1 || bh % bias_planes != 0 ||
                          bias_dtype < 0 || bias_dtype > 2))
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
  Args a{q,      k,         v,          o,     lse,
         kv_valid, seed,    {bias, bias_planes, bias_dtype},
         bh,     tq,        tk,         d,     scale,
         causal, threshold, keep_scale, static_cast<cudaStream_t>(stream)};
  *route = dtype == 0 ? 2 : 3;
  return dtype == 0 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
