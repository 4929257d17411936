// What the flash-attention forward and backward kernels share: the
// staging of float32 tiles and of the bias, the masks, and the dropout
// keep mask.
//
// The keep mask replaces the reference's TPU PRNG draw (_keep_mask in
// tpu_mx/kernels/flash_attention.py), which cannot be reproduced off the
// TPU.  Here the decision for one score element is a pure function of
// (seed, bh, query index, key index), computed element by element, so it
// does not depend on tile sizes and the three kernels regenerate the same
// bits.  The hash is MurmurHash3's 32-bit finalizer, chained over the four
// words (all arithmetic mod 2^32):
//
//   row  = fmix32(seed ^ fmix32(bh + 0x9E3779B9))
//   qkey = fmix32(row ^ (q * 0x85EBCA77))
//   bits = fmix32(qkey ^ (k * 0xC2B2AE3D))
//   keep = bits >= threshold,  threshold = min(floor(rate * 2^32), 2^32 - 1)
//
// tpu_mx_torch/kernels/flash_attention.py::dropout_keep_mask computes the
// same bits in PyTorch integer arithmetic.
//
// The additive bias (_bias_spec in the reference) is a (planes, T, Tk)
// tensor of float32, bfloat16 or float16; row bh reads plane bh % planes
// (planes = BH: one plane per row, 1: shared, G: one per head).  A kernel
// stages the (kBq x kBk) tile it needs in shared memory, read along the
// key axis so that the loads coalesce.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tmx_flash {

constexpr int kBq = 64;            // query rows of a tile
constexpr int kBk = 64;            // key rows of a tile
constexpr int kThreads = 256;      // 16 x 16 threads, each a 4 x 4 block
constexpr float kNegInf = -1e30f;  // finite, as in the reference

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The per-(seed, bh) stream key, then the per-query-row key.
__device__ __forceinline__ uint32_t dropout_row_key(uint32_t seed, int bh) {
  return fmix32(seed ^ fmix32(static_cast<uint32_t>(bh) + 0x9E3779B9u));
}
__device__ __forceinline__ uint32_t dropout_q_key(uint32_t row, int q) {
  return fmix32(row ^ (static_cast<uint32_t>(q) * 0x85EBCA77u));
}
__device__ __forceinline__ bool dropout_keep(uint32_t qkey, int k,
                                             uint32_t threshold) {
  return fmix32(qkey ^ (static_cast<uint32_t>(k) * 0xC2B2AE3Du)) >= threshold;
}

// Number of valid keys of row bh: kv_valid[bh] clamped to [0, tk], or tk.
__device__ __forceinline__ int valid_keys(const int* kv_valid, int bh,
                                          int tk) {
  if (kv_valid == nullptr) return tk;
  return max(0, min(kv_valid[bh], tk));
}

// Copy rows [r0, r0 + kRows) of two float32 (rows, D) operands into shared
// memory, with row strides sa and sb; rows past `rows` are zero.  Both
// operands are staged in one unrolled loop so that many global loads are
// in flight at once: one block runs per SM (shared memory is the limit),
// and the tile's load latency is not hidden behind other blocks' work.
template <int D, int kRows>
__device__ __forceinline__ void stage_rows2(float* da, int sa, const float* a,
                                            float* db, int sb, const float* b,
                                            int r0, int rows) {
  static_assert(kRows * D % kThreads == 0, "tile must split evenly");
#pragma unroll 8
  for (int it = 0; it < kRows * D / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / D, d = i % D;
    const bool in = r0 + r < rows;
    const long at = static_cast<long>(r0 + r) * D + d;
    da[r * sa + d] = in ? a[at] : 0.f;
    db[r * sb + d] = in ? b[at] : 0.f;
  }
}

// The bias: a pointer to its first element, its element type (0 float32,
// 1 bfloat16, 2 float16) and its number of planes.
struct Bias {
  const void* ptr;
  int planes;
  int dtype;
};

__device__ __forceinline__ float bias_at(const Bias& b, long i) {
  if (b.dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(b.ptr)[i]);
  if (b.dtype == 2) return __half2float(static_cast<const __half*>(b.ptr)[i]);
  return static_cast<const float*>(b.ptr)[i];
}

// Stage the bias tile of query rows [q0, q0 + kBq) and key columns
// [k0, k0 + kBk) of row bh into dst as float32: dst[r * ld + c], or
// dst[c * ld + r] when kTrans (the dk/dv kernel's transposed scores).
// Consecutive threads read consecutive keys; elements past (tq, tk) are 0.
template <bool kTrans>
__device__ __forceinline__ void stage_bias(float* dst, int ld, const Bias& b,
                                           int bh, int q0, int k0, int tq,
                                           int tk) {
  const long plane =
      static_cast<long>(bh % b.planes) * tq * static_cast<long>(tk);
#pragma unroll 4
  for (int it = 0; it < kBq * kBk / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kBk, c = i % kBk;
    const bool in = q0 + r < tq && k0 + c < tk;
    const float x =
        in ? bias_at(b, plane + static_cast<long>(q0 + r) * tk + k0 + c)
           : 0.f;
    if (kTrans)
      dst[c * ld + r] = x;
    else
      dst[r * ld + c] = x;
  }
}

// --- the bias in the tensor-core kernels ------------------------------------
// Their bias element type BT is a template parameter (float, __nv_bfloat16
// or __half; NoBias without a bias): the bias tile is staged in shared
// memory in that type, rows `stride` bytes apart, next to the K/V
// (forward) or Q/dO (dk/dv) tiles of the same ring stage, and read back
// with no branch on the type (a run-time branch per element cost dk/dv
// more than the bias itself on an H100).
struct NoBias {};
template <typename BT>
constexpr bool kHasBias = !std::is_same_v<BT, NoBias>;

// Every row of the bias starts 16-byte aligned: the tile can be copied in
// 16-byte chunks.
template <typename BT>
__device__ __forceinline__ bool bias_rows_aligned(const Bias& b, int tk) {
  return (reinterpret_cast<uintptr_t>(b.ptr) & 15) == 0 &&
         (tk * sizeof(BT)) % 16 == 0;
}

// Stage the bias of query rows [q0, q0 + R) and key columns [k0, k0 + C)
// of the plane starting at element `plane` into shared memory at `dst`;
// elements past (tq, tk) are 0.  With 16-byte aligned rows (`chunks`) the
// copy is cp.async, in the caller's commit group; otherwise the threads
// load and store it element by element.
template <int R, int C, int kThreads, typename BT>
__device__ __forceinline__ void stage_bias_async(uint32_t dst, int stride,
                                                 const Bias& b, long plane,
                                                 int q0, int k0, int tq,
                                                 int tk, bool chunks,
                                                 int tid) {
  constexpr int kElt = sizeof(BT);
  const BT* base = static_cast<const BT*>(b.ptr);
  if (chunks) {
    constexpr int kPer = 16 / kElt, kRow = C / kPer;
#pragma unroll 4
    for (int i = tid; i < R * kRow; i += kThreads) {
      const int r = i / kRow, c = (i % kRow) * kPer;
      const bool in = q0 + r < tq && k0 + c < tk;
      const BT* from =
          base + (in ? plane + static_cast<long>(q0 + r) * tk + k0 + c : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst + r * stride + c * kElt),
                   "l"(from), "r"(in ? 16 : 0)
                   : "memory");
    }
    return;
  }
#pragma unroll 8
  for (int i = tid; i < R * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool in = q0 + r < tq && k0 + c < tk;
    const long at = plane + static_cast<long>(q0 + r) * tk + k0 + c;
    const uint32_t to = dst + r * stride + c * kElt;
    if constexpr (kElt == 4) {
      const uint32_t x = in ? reinterpret_cast<const uint32_t*>(base)[at] : 0u;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(to), "r"(x) : "memory");
    } else {
      const unsigned short x =
          in ? reinterpret_cast<const unsigned short*>(base)[at] : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(to), "h"(x) : "memory");
    }
  }
}

// One staged bias element, or two adjacent ones (keys c and c + 1), at `p`
// in shared memory, as float32.
template <typename BT>
__device__ __forceinline__ float lds_bias(const uint8_t* p);
template <>
__device__ __forceinline__ float lds_bias<float>(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}
template <>
__device__ __forceinline__ float lds_bias<__nv_bfloat16>(const uint8_t* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
template <>
__device__ __forceinline__ float lds_bias<__half>(const uint8_t* p) {
  return __half2float(*reinterpret_cast<const __half*>(p));
}
template <typename BT>
__device__ __forceinline__ float2 lds_bias2(const uint8_t* p);
template <>
__device__ __forceinline__ float2 lds_bias2<float>(const uint8_t* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 lds_bias2<__nv_bfloat16>(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 lds_bias2<__half>(const uint8_t* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

}  // namespace tmx_flash
