// Paged-attention decode for Hopper (sm_90a) at head dims of 320 and more:
// one runtime-D instance a query and pool type, D passed as an argument, a
// translation unit and a library of its own.
//
// Replaces, at those head dims, the Pallas TPU kernel
// tpu_mx/kernels/paged_attention.py::_kernel (launched by _kernel_call),
// whose gate supported() takes any head dim that is a multiple of 64.  The
// contract is paged_attention.cu's (its header): a (B, Tq, H, D) query
// window, float32 or bfloat16, over (N, BS, H, D) pools of float32,
// bfloat16 or float16 named by a (B, NB) block table; query t of row b sees
// keys at positions < lengths[b] - (Tq - 1 - t); float32 math; the window
// walked in chunks of kTqMax = 8 rows, a split and a merge launch a chunk;
// the same float32 partials, split over the keys in splits of 64 from the
// table's width (no read back: capturable in a CUDA graph).
//
// Why paged_attention.cu stops at D = 256: a lane owns D/32 output columns
// of every window row in registers (acc[8][D/32]) and its 3-stage ring of
// 16-key K/V tiles takes 3 * 2 * 16 * D * 4 bytes, 384 KB of float32 at
// D = 1024.  The design here keeps registers fixed whatever D is:
//   - grid (B, H, S), 128 threads; a split's 64 keys in three passes over
//     shared memory holding the chunk's queries as float32 (Tq x D) and the
//     split's scores (8 x 64):
//       1. scores: warp w takes keys w, w + 4, ...; its lanes read the key
//          row from the pool in order (coalesced, D elements) and sum its
//          products with each window row's query; five xor-shuffles finish
//          each dot product;
//       2. statistics: a warp a window row, a lane two keys: the row's max
//          m over the split, p = e^(s - m) (0 past the row's causal
//          limit), l = sum p;
//       3. output: thread x owns columns x, x + 128, ...; it walks the
//          split's keys reading V's column x from the pool (coalesced over
//          the threads) and sums p v for every window row;
//   - the split writes (m, l) and acc to the float32 partials and the merge
//     launch folds them, as paged_attention.cu's does (runtime D).
// Bound on the H100: memory, as at the smaller head dims: every K/V byte of
// the visited blocks is read once (K in pass 1, V in pass 3).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSplitKeys = 64;    // keys of a split
constexpr int kTqMax = 8;
constexpr float kNegInf = -1e30f;  // finite, as in the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;   // bytes a block may have on an H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ long part_row(int b, int s, int t, int h,
                                         int splits, int tq, int heads) {
  return (((static_cast<long>(b) * splits + s) * tq + t) * heads + h);
}

size_t split_smem_bytes(int d) {
  // the chunk's queries (float32), the split's scores, then (m, l) a row
  return sizeof(float) * (kTqMax * d + kTqMax * kSplitKeys + 2 * kTqMax);
}

// q points at the chunk's first row; rows of a sequence are tq_all (the
// whole window) apart; the chunk's rows see keys below lengths[b] - shift.
template <typename QT, typename T>
__global__ void __launch_bounds__(kThreads)
    paged_split_dn_kernel(const QT* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_ml,
                          float* __restrict__ part_acc, int tq, int tq_all,
                          int shift, int heads, int bs, int nb, int splits,
                          int d, float scale) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);  // [tq][d]
  float* p_s = q_s + kTqMax * d;                    // [kTqMax][64]
  float* ml_s = p_s + kTqMax * kSplitKeys;          // m [8], l [8]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long total = static_cast<long>(gridDim.x) * splits * tq * heads;
  float* m_out = part_ml;
  float* l_out = part_ml + total;
  const int length = lengths[b] - shift;
  // a length past the table's NB*BS slots walks the table and no further
  const int kv_end = min(length, nb * bs);
  const int start = s * kSplitKeys;
  if (start >= kv_end) {  // the split holds none of the row's keys
    if (tid < tq) {
      m_out[part_row(b, s, tid, h, splits, tq, heads)] = kNegInf;
      l_out[part_row(b, s, tid, h, splits, tq, heads)] = 0.f;
    }
    return;
  }
  const int n_keys = min(kSplitKeys, kv_end - start);
  const long row = static_cast<long>(heads) * d;  // one token's H*D values
  // pool offset of the split's key kk, head h
  auto key_at = [&](int kk) {
    const int pos = start + kk;
    return (static_cast<long>(__ldg(tables + static_cast<long>(b) * nb +
                                    pos / bs)) *
                bs +
            pos % bs) *
               row +
           static_cast<long>(h) * d;
  };
  const QT* qb = q + static_cast<long>(b) * tq_all * row + h * d;
  for (int i = tid; i < tq * d; i += kThreads)
    q_s[i] = to_f32(qb[static_cast<long>(i / d) * row + i % d]);
  __syncthreads();

  // 1. scores (masked past the row's causal limit)
  for (int kk = warp; kk < n_keys; kk += kWarps) {
    const T* kr = k_pool + key_at(kk);
    float dot[kTqMax];
#pragma unroll
    for (int t = 0; t < kTqMax; ++t) dot[t] = 0.f;
    for (int x = lane; x < d; x += 32) {
      const float kv = to_f32(kr[x]);
#pragma unroll
      for (int t = 0; t < kTqMax; ++t)
        if (t < tq) dot[t] = fmaf(q_s[t * d + x], kv, dot[t]);
    }
#pragma unroll
    for (int t = 0; t < kTqMax; ++t) {
      if (t >= tq) break;
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], o);
      if (lane == 0) p_s[t * kSplitKeys + kk] = dot[t] * scale;
    }
  }
  __syncthreads();

  // 2. statistics of each window row over the split
  for (int t = warp; t < tq; t += kWarps) {
    const int limit = length - (tq - 1) + t;  // keys below it are admitted
    float sc[2];
    bool ok[2];
    float mx = kNegInf;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kk = lane + 32 * e;
      ok[e] = kk < n_keys && start + kk < limit;
      sc[e] = ok[e] ? p_s[t * kSplitKeys + kk] : kNegInf;
      mx = fmaxf(mx, sc[e]);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = ok[e] ? exp2f((sc[e] - mx) * kLog2e) : 0.f;
      sum += p;
      p_s[t * kSplitKeys + lane + 32 * e] = p;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ml_s[t] = mx;
      ml_s[kTqMax + t] = sum;
    }
  }
  __syncthreads();

  // 3. acc = sum_k p v, a thread a column
  for (int x = tid; x < d; x += kThreads) {
    float a[kTqMax];
#pragma unroll
    for (int t = 0; t < kTqMax; ++t) a[t] = 0.f;
    for (int kk = 0; kk < n_keys; ++kk) {
      const float vv = to_f32(v_pool[key_at(kk) + x]);
#pragma unroll
      for (int t = 0; t < kTqMax; ++t)
        if (t < tq) a[t] = fmaf(p_s[t * kSplitKeys + kk], vv, a[t]);
    }
#pragma unroll
    for (int t = 0; t < kTqMax; ++t)
      if (t < tq)
        part_acc[part_row(b, s, t, h, splits, tq, heads) * d + x] = a[t];
  }
  if (tid < tq) {
    m_out[part_row(b, s, tid, h, splits, tq, heads)] = ml_s[tid];
    l_out[part_row(b, s, tid, h, splits, tq, heads)] = ml_s[kTqMax + tid];
  }
}

// Fold the S partials of row (b, h), as paged_attention.cu's merge: out =
// sum acc_s e^(m_s - M) / L in the queries' type, skipping splits with
// l = 0; out points at the chunk's first row, rows tq_all apart.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
    paged_merge_dn_kernel(const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc,
                          QT* __restrict__ out, int tq, int tq_all, int heads,
                          int splits, int d) {
  const int b = blockIdx.x, h = blockIdx.y;
  const long total = static_cast<long>(gridDim.x) * splits * tq * heads;
  const float* m_in = part_ml;
  const float* l_in = part_ml + total;
  for (int i = threadIdx.x; i < tq * d; i += kThreads) {
    const int t = i / d, x = i % d;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) {
      const long pr = part_row(b, s, t, h, splits, tq, heads);
      if (l_in[pr] > 0.f) mx = fmaxf(mx, m_in[pr]);
    }
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long pr = part_row(b, s, t, h, splits, tq, heads);
      const float ls = l_in[pr];
      if (ls > 0.f) {
        const float f = exp2f((m_in[pr] - mx) * kLog2e);
        sum += ls * f;
        a += part_acc[pr * d + x] * f;
      }
    }
    const float o = a / fmaxf(sum, 1e-30f);
    QT* at = out + ((static_cast<long>(b) * tq_all + t) * heads + h) * d + x;
    if constexpr (std::is_same_v<QT, float>)
      *at = o;
    else
      *at = __float2bfloat16(o);
  }
}

struct Args {
  const void* q;
  const void *k_pool, *v_pool;
  const int *tables, *lengths;
  void* out;
  float *part_ml, *part_acc;
  int b, tq, tq_all, shift, heads, bs, nb, splits, d;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename T>
cudaError_t launch(const Args& a) {
  const size_t smem = split_smem_bytes(a.d);
  auto kernel = paged_split_dn_kernel<QT, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.b, a.heads, a.splits), kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.tables, a.lengths, a.part_ml,
      a.part_acc, a.tq, a.tq_all, a.shift, a.heads, a.bs, a.nb, a.splits,
      a.d, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_dn_kernel<QT><<<dim3(a.b, a.heads), kThreads, 0, a.stream>>>(
      a.part_ml, a.part_acc, static_cast<QT*>(a.out), a.tq, a.tq_all,
      a.heads, a.splits, a.d);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_pool(int pool_dtype, const Args& a) {
  if (pool_dtype == 1) return launch<QT, __nv_bfloat16>(a);
  if (pool_dtype == 2) return launch<QT, __half>(a);
  return launch<QT, float>(a);
}

}  // namespace

// The C interface of paged_attention.cu, for any head dim d whose split
// fits a block's shared memory (d <= 7000 or so); *route = 0 (split-K).
extern "C" int tmx_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const int* tables,
                                   const int* lengths, void* out, int b,
                                   int tq, int heads, int d, int bs, int nb,
                                   float scale, int q_dtype, int pool_dtype,
                                   float* part_ml, float* part_acc,
                                   int splits, void* stream, int* route) {
  if (tq < 1 || b < 1 || bs < 1 || nb < 1 || d < 1 || heads < 1 ||
      heads > 65535 || splits > 65535 || q_dtype < 0 || q_dtype > 1 ||
      pool_dtype < 0 || pool_dtype > 2 ||
      split_smem_bytes(d) > static_cast<size_t>(kMaxSmem) ||
      splits != (static_cast<long>(nb) * bs + kSplitKeys - 1) / kSplitKeys)
    return cudaErrorInvalidValue;
  const long row = static_cast<long>(heads) * d * (q_dtype == 1 ? 2 : 4);
  for (int t0 = 0; t0 < tq; t0 += kTqMax) {
    const int n = tq - t0 < kTqMax ? tq - t0 : kTqMax;
    Args a{static_cast<const char*>(q) + t0 * row,
           k_pool,
           v_pool,
           tables,
           lengths,
           static_cast<char*>(out) + t0 * row,
           part_ml,
           part_acc,
           b,
           n,
           tq,
           tq - t0 - n,
           heads,
           bs,
           nb,
           splits,
           d,
           scale,
           static_cast<cudaStream_t>(stream)};
    const cudaError_t err = q_dtype == 1
                                ? dispatch_pool<__nv_bfloat16>(pool_dtype, a)
                                : dispatch_pool<float>(pool_dtype, a);
    if (err != cudaSuccess) return err;
  }
  *route = 0;
  return cudaSuccess;
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
