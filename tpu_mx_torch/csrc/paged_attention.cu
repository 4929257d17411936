// Paged-attention decode for Hopper (sm_90a), float32 math.
//
// Replaces the Pallas TPU kernel tpu_mx/kernels/paged_attention.py::_kernel
// (launched by _kernel_call): decode attention of a (B, Tq, H, D) query
// window over a paged KV pool (N, BS, H, D), each sequence's keys and
// values scattered over pool blocks named by its row of the (B, NB) block
// table.  Query t of row b sits at position lengths[b] - Tq + t and sees
// keys at positions < lengths[b] - (Tq - 1 - t).
//
// Bound on the H100: memory.  Every K/V byte of the visited blocks is
// read once and used for Tq (<= 8) dot products, far below the card's
// operations-per-byte line.  The design therefore walks only the blocks a
// sequence owns (ceil(length / BS) of them, never the padded table tail)
// and keeps every statistic on chip:
//   - grid (B, H): one block of 128 threads per (sequence, head).  The TPU
//     grid's sequential block axis becomes a loop inside the block, and the
//     block reads table[b, i] itself (there is no scalar prefetch here).
//   - per pool block: the BS x D key and value rows of head h (row stride
//     H*D in the pool) are staged in shared memory as float, so f32 and
//     bf16 pools share one code path;
//   - scores: 8 threads per key, each summing D/8 products, reduced with
//     warp shuffles; the key rows are padded to D+8 floats so the 32 lanes
//     of a warp hit 32 different banks;
//   - the online softmax (m, l) of each window row lives in shared memory,
//     the output accumulator in registers (thread d owns column d).
// Padded table entries past ceil(length / BS) are never read, and slots
// past the causal limit inside the last block get probability exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanesPerKey = 8;
constexpr int kKeysPerPass = kThreads / kLanesPerKey;
constexpr int kTqMax = 8;
constexpr float kNegInf = -1e30f;  // finite, as in the reference: no inf-inf

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const float* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const int* __restrict__ tables,
                           const int* __restrict__ lengths,
                           float* __restrict__ out, int tq, int heads, int bs,
                           int nb, float scale) {
  static_assert(D % kLanesPerKey == 0 && D <= kThreads, "head_dim");
  constexpr int KS = D + 8;  // padded key-row stride (see header)
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kTqMax][D]
  float* k_s = q_s + kTqMax * D;     // [bs][KS]
  float* v_s = k_s + bs * KS;        // [bs][D]
  float* p_s = v_s + bs * D;         // [kTqMax][bs] scores, then probs
  float* m_s = p_s + kTqMax * bs;    // [kTqMax] running max
  float* l_s = m_s + kTqMax;         // [kTqMax] running denominator
  float* a_s = l_s + kTqMax;         // [kTqMax] this block's rescale

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int length = lengths[b];
  const long row = static_cast<long>(heads) * D;  // one token's H*D values

  for (int i = tid; i < tq * D; i += kThreads) {
    const int t = i / D, d = i % D;
    q_s[t * D + d] = q[(static_cast<long>(b) * tq + t) * row + h * D + d];
  }
  if (tid < kTqMax) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kTqMax];
#pragma unroll
  for (int t = 0; t < kTqMax; ++t) acc[t] = 0.f;

  const int key = tid / kLanesPerKey, part = tid % kLanesPerKey;
  // a length past the table's NB*BS slots walks the table and no further
  // (the plain version's bound too): never a read past row b
  const int nblk = min((length + bs - 1) / bs, nb);
  for (int i = 0; i < nblk; ++i) {
    const long base =
        static_cast<long>(tables[b * nb + i]) * bs * row + h * D;
    for (int j = tid; j < bs * D; j += kThreads) {
      const int s = j / D, d = j % D;
      k_s[s * KS + d] = to_f32(k_pool[base + s * row + d]);
      v_s[s * D + d] = to_f32(v_pool[base + s * row + d]);
    }
    __syncthreads();

    for (int s0 = 0; s0 < bs; s0 += kKeysPerPass) {
      const int s = s0 + key;
      float dot[kTqMax];
#pragma unroll
      for (int t = 0; t < kTqMax; ++t) dot[t] = 0.f;
      if (s < bs) {
        for (int d = part; d < D; d += kLanesPerKey) {
          const float kv = k_s[s * KS + d];
#pragma unroll
          for (int t = 0; t < kTqMax; ++t)
            if (t < tq) dot[t] += q_s[t * D + d] * kv;
        }
      }
#pragma unroll
      for (int t = 0; t < kTqMax; ++t)
        for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
          dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], off);
      if (part == 0 && s < bs) {
        const int kpos = i * bs + s;
#pragma unroll
        for (int t = 0; t < kTqMax; ++t)
          if (t < tq)
            p_s[t * bs + s] =
                kpos < length - (tq - 1) + t ? dot[t] * scale : kNegInf;
      }
    }
    __syncthreads();

    if (tid < tq) {
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int s = 0; s < bs; ++s) m_new = fmaxf(m_new, p_s[tid * bs + s]);
      float sum = 0.f;
      for (int s = 0; s < bs; ++s) {
        const float p = expf(p_s[tid * bs + s] - m_new);
        p_s[tid * bs + s] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      a_s[tid] = alpha;
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int t = 0; t < kTqMax; ++t) {
        if (t < tq) {
          float a = acc[t] * a_s[t];
          for (int s = 0; s < bs; ++s) a += p_s[t * bs + s] * v_s[s * D + tid];
          acc[t] = a;
        }
      }
    }
    __syncthreads();  // k_s/v_s/p_s are overwritten by the next block
  }

  if (tid < D) {
#pragma unroll
    for (int t = 0; t < kTqMax; ++t)
      if (t < tq)
        out[(static_cast<long>(b) * tq + t) * row + h * D + tid] =
            acc[t] / fmaxf(l_s[t], 1e-30f);
  }
}

template <int D, typename T>
cudaError_t launch(const float* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, float* out, int b,
                   int tq, int heads, int bs, int nb, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      (kTqMax * D + bs * (D + 8) + bs * D + kTqMax * bs + 3 * kTqMax);
  auto kernel = paged_attention_kernel<D, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(b, heads), kThreads, smem, stream>>>(
      q, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, out, tq, heads, bs, nb, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const float* q, const void* k_pool,
                     const void* v_pool, const int* tables,
                     const int* lengths, float* out, int b, int tq, int heads,
                     int bs, int nb, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16, T>(q, k_pool, v_pool, tables, lengths, out, b, tq,
                           heads, bs, nb, scale, stream);
    case 32:
      return launch<32, T>(q, k_pool, v_pool, tables, lengths, out, b, tq,
                           heads, bs, nb, scale, stream);
    case 64:
      return launch<64, T>(q, k_pool, v_pool, tables, lengths, out, b, tq,
                           heads, bs, nb, scale, stream);
    case 128:
      return launch<128, T>(q, k_pool, v_pool, tables, lengths, out, b, tq,
                            heads, bs, nb, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tmx_paged_attention(const float* q, const void* k_pool,
                                   const void* v_pool, const int* tables,
                                   const int* lengths, float* out, int b,
                                   int tq, int heads, int d, int bs, int nb,
                                   float scale, int pool_bf16, void* stream) {
  if (tq < 1 || tq > kTqMax || b < 1 || bs < 1 || nb < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pool_bf16 ? dispatch<__nv_bfloat16>(d, q, k_pool, v_pool, tables,
                                             lengths, out, b, tq, heads, bs,
                                             nb, scale, s)
                   : dispatch<float>(d, q, k_pool, v_pool, tables, lengths,
                                     out, b, tq, heads, bs, nb, scale, s);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
