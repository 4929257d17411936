// What the flash-attention forward and backward kernels share: the
// masks, the dropout keep mask, the staging of the bias, and the float32
// kernels' split-precision (3xTF32) tensor-core products.
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
// (planes = BH: one plane per row, 1: shared, G: one per head).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tmx_flash {

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

// The bias: a pointer to its first element, its element type (0 float32,
// 1 bfloat16, 2 float16) and its number of planes.
struct Bias {
  const void* ptr;
  int planes;
  int dtype;
};

// --- the bias's element type -------------------------------------------------
// A kernel takes the bias element type BT as a template parameter (float,
// __nv_bfloat16 or __half; NoBias without a bias) and reads the bias with
// no branch on the type (a run-time branch per element cost the bf16
// dk/dv kernel more than the bias itself on an H100).  The bf16 kernels
// stage the bias tile in shared memory in that type, rows `stride` bytes
// apart, next to the K/V (forward, dq) or Q/dO (dk/dv) tiles of the same
// ring stage; the float32 kernels read it from device memory.
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

// One bias element at index i of `base`, as float32, read from device
// memory.
template <typename BT>
__device__ __forceinline__ float bias_value(const void* base, long i) {
  if constexpr (std::is_same_v<BT, float>)
    return __ldg(static_cast<const float*>(base) + i);
  else if constexpr (std::is_same_v<BT, __nv_bfloat16>)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  else
    return __half2float(static_cast<const __half*>(base)[i]);
}

// --- float32 on the tensor cores: split-precision TF32 (3xTF32) --------------
// One TF32 pass would round every operand to 10 mantissa bits (a different
// result, not a faster one), so every operand x is split into hi =
// rna_tf32(x) and lo = rna_tf32(x - hi), and each product is a_hi*b_hi +
// a_hi*b_lo + a_lo*b_hi, accumulated in float32 by mma.sync.m16n8k8.  hi +
// lo is within 2^-22 of |x|, and the omitted a_lo*b_lo is under 2^-22 of
// |a b|, so a product keeps about 21 bits before the float32 sums.  Both
// roundings are two integer operations on the bit pattern (a
// cvt.rna.tf32.f32 instruction took 30% more device time on an H100).
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) holds
// (t, g), (t + 4, g); the accumulator C (16 x 8) holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  Inside one instruction the
// order of the 8 reduction elements is free as long as A and B agree, so
// a C fragment is the A fragment of the next product as it stands
// ({c0, c2, c1, c3}, reduction elements t and t + 4 being columns 2t and
// 2t + 1), with B's rows 2t and 2t + 1.

// x split into hi, x rounded to TF32 (10 mantissa bits) to nearest with
// ties away from zero (the bit pattern's low 13 bits rounded on the
// magnitude, as cvt.rna.tf32.f32 rounds), and lo, the exact x - hi
// rounded the same way.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// The A fragment {a0, a1, a2, a3} split into hi and lo halves.
__device__ __forceinline__ void split_frag(float a0, float a1, float a2,
                                           float a3, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in three TF32 products, the small ones first; b = (b0, b1)
// is split here.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Issue the copy of rows [r0, r0 + R) of a (rows, D) float32 operand into
// shared memory at `dst`, rows kLd floats apart, 16 bytes a thread, by
// kThreads threads; rows past `rows` are zero-filled (source size 0,
// address clamped to row 0).
template <int D, int R, int kLd, int kThreads>
__device__ __forceinline__ void copy_rows_f32(uint32_t dst, const float* src,
                                              int r0, int rows, int tid) {
  constexpr int kChunks = D / 4, kN = R * kChunks;
#pragma unroll
  for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (kN % kThreads != 0 && i >= kN) break;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = r0 + r < rows;
    const float* from = src + (in ? static_cast<long>(r0 + r) * D + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + 4 * (r * kLd + c)),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

}  // namespace tmx_flash
