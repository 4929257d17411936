// Flash-attention forward for Hopper (sm_90a) at head dims of 320 and
// more: one runtime-D instance a dtype, D passed as an argument (any
// multiple of 64), a translation unit and a library of its own.
//
// Replaces, at those head dims, the forward Pallas TPU kernel
// tpu_mx/kernels/flash_attention.py::_fwd_kernel (launched by _fwd), whose
// gate supported() takes any head dim that is a multiple of 64: O =
// softmax(q k^T * scale [masks]) v over (BH, T, D) tensors with the per-row
// logsumexp, the masks, dropout and bias of flash_attention_fwd.cu (its
// header says what each does), computed the same way per score element.
//
// Design: the split-D design of flash_dn.cuh.  A cluster of blocks
// (split_d(d, 4, 1): D/512 blocks rounded up, each of two warpgroups of
// up to 256 columns; 1 block up to D = 512, 8 at D = 4096) owns 64 query
// rows and all of D; grid (cluster x row tiles, BH).  For each key tile
// of 64 keys (up to kv_valid, to the diagonal when causal):
//   - each warpgroup sums its partial S = Q K^T over its own 64-column
//     blocks of Q (bf16: resident) and K (streamed through its ring);
//   - the exchange sums the partials across the cluster: every
//     warpgroup holds S, runs the online softmax on it (masks, the
//     dropout keep bit, the bias read from device memory in its own
//     type) and O += P V on its own columns of O (V streamed; 128 float32
//     registers a thread at most);
//   - global warpgroup 0 writes lse.
// What it does about the column-block design (flash_dn.cuh, design 2):
//   1. the scores are no longer recomputed: each score product is done
//      once a pair of tiles, from slices (4.5x fewer operations at
//      D = 512, 8.5x at 1024), and each block reads only its own slice
//      of Q, K and V;
//   2. copies overlap compute: the ring keeps kRingTiles - 2 tiles'
//      copies in flight (four bf16, two float32) instead of waiting for
//      each chunk;
//   3. bf16 runs SS wgmma m64n64k16 for S and RS wgmma (P from registers)
//      for P V, not mma.sync; float32 stays 3xTF32 mma.sync, every k-step
//      summed apart.
// Bound on the H100: operations once T passes a few hundred, 4*T*Tk*D*BH
// (about half under a causal mask) at up to the 989 TFLOP/s bf16 rate,
// three TF32 products a product at 495 in float32.
// The C entry point sends bfloat16 to the wgmma kernel (route 1) and
// float32 to the 3xTF32 one (route 2); nothing else falls back.
#include "flash_dn.cuh"

namespace hp = tmx_hopper;

namespace {

using namespace tmx_dn;

// T: float or __nv_bfloat16 (q, k, v and o); BT: the bias element type
// (flash_common.cuh), NoBias without a bias.
template <typename T, bool kDrop, typename BT>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_fwd_dn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse,
                        const int* __restrict__ kv_valid,
                        const int* __restrict__ seed, Bias bias, int tq,
                        int tk, int d, float scale, int causal,
                        uint32_t threshold, float keep_scale) {
  constexpr bool kBias = kHasBias<BT>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr uint32_t kTile = kTileBytes<T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* base_g = smem_raw + (base - raw);

  const Split sp = split_d(d, kFwdCapBlocks, kFwdMinBlocks);
  const int half = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int rank = static_cast<int>(cluster_ctarank());
  const int w = 2 * rank + half;
  const int x = blockIdx.x / sp.cluster, pass = x % sp.passes;
  const int q0 = (x / sp.passes) * kRows;
  int b0, nb, sb0, snb;  // this warpgroup's blocks of O and of the scores
  slice_of(d, sp, pass, w, b0, nb);
  score_slice_of(d, sp, w, sb0, snb);
  const uint32_t region = wg_region_bytes<T>(kFwdTiles<T>, sp.wgs);
  const uint32_t part = kFwdTiles<T> * kTile;  // within a region
  // bf16 keeps its Q slice resident (past the ring) when it fits, which
  // it does up to D = 4096; float32 streams Q beside K
  const bool q_res = !kF32 && snb <= kFwdCapBlocks;
  const uint32_t slots = base + half * region;
  const uint32_t q_at = slots + kRingTiles<T> * kTile;
  Exchange exchange{base, region, part, sp.wgs, w, rank, tid,
                    sp.cluster == 1,
                    exchange_gathers(kFwdTiles<T> * kTile, sp.wgs), 0};

  const int bh = blockIdx.y;
  const int qrow[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const T* qb = q + static_cast<long>(bh) * tq * d;
  const T* kb = k + static_cast<long>(bh) * tk * d;
  const T* vb = v + static_cast<long>(bh) * tk * d;
  const int valid = valid_keys(kv_valid, bh, tk);
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  int n_tiles = (valid + kChunk - 1) / kChunk;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRows, tq) - 1) / kChunk + 1);

  // a key tile's stream: snb K blocks (each after its Q block unless Q is
  // resident), then nb V blocks
  const int per = q_res ? 1 : 2, tpt = per * snb + nb;
  const int total = n_tiles * tpt;
  auto issue = [&](int i, uint32_t dst) {
    if (i >= total) return;
    const int k0 = (i / tpt) * kChunk, s = i % tpt;
    if (s < per * snb) {
      const int c = (sb0 + s / per) * kChunk;
      if (per == 2 && s % 2 == 0)
        copy_block<T>(dst, qb, q0, tq, d, c, tid);
      else
        copy_block<T>(dst, kb, k0, tk, d, c, tid);
    } else {
      copy_block<T>(dst, vb, k0, tk, d, (b0 + s - per * snb) * kChunk, tid);
    }
  };
  if (q_res && n_tiles > 0) {  // committed with the ring's first tile
    for (int b = 0; b < snb; ++b)
      copy_block<T>(q_at + b * kTile, qb, q0, tq, d, (sb0 + b) * kChunk, tid);
  }
  Ring<T, decltype(issue)> ring{slots, half, 0, issue};
  ring.start();
  auto tile = [&](uint32_t at) {  // a ring tile as float32 (generic)
    return reinterpret_cast<const float*>(base_g + (at - base));
  };

  float acc[kFwdCapBlocks][32];
#pragma unroll
  for (int b = 0; b < kFwdCapBlocks; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  float s[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kChunk;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int b = 0; b < snb; ++b) {
      const uint32_t qt = q_res ? q_at + b * kTile : ring.acquire();
      const uint32_t kt_at = ring.acquire();
      if constexpr (kF32)
        score_f32(s, tile(qt) + 16 * warp * kLd<float>, tile(kt_at), g, t);
      else
        score_bf16(s, qt, kt_at);
    }
    exchange(s);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const int kp = k0 + 8 * (i / 4) + 2 * t + i % 2;
      const bool ok = kp < valid && (!causal || kp <= qrow[h]);
      if constexpr (kBias) {
        const float bv =
            ok && qrow[h] < tq
                ? bias_value<BT>(bias.ptr,
                                 plane + static_cast<long>(qrow[h]) * tk + kp)
                : 0.f;
        s[i] = ok ? s[i] * scale + bv : -INFINITY;
      } else {
        s[i] = ok ? s[i] * scale : kNegInf;
      }
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float alpha[2], mneg[2], sum[2] = {0.f, 0.f};
    uint32_t qkey[2] = {0u, 0u};  // (hashed again a tile: fewer registers)
    if (kDrop) {
      const uint32_t row =
          dropout_row_key(static_cast<uint32_t>(__ldg(seed)), bh);
      qkey[0] = dropout_q_key(row, qrow[0]);
      qkey[1] = dropout_q_key(row, qrow[1]);
    }
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
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const float p = exp2f(fmaf(s[i], kLog2e, mneg[h]));
      sum[h] += p;  // the normalizer uses the un-dropped probability
      if (kDrop) {
        const int kp = k0 + 8 * (i / 4) + 2 * t + i % 2;
        s[i] = dropout_keep(qkey[h], kp, threshold) ? p * keep_scale : 0.f;
      } else {
        s[i] = p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int b = 0; b < kFwdCapBlocks; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] *= alpha[(i / 2) % 2];

    // O += P V on this warpgroup's columns
    if constexpr (kF32) {
#pragma unroll
      for (int b = 0; b < kFwdCapBlocks; ++b)
        if (b < nb) out_f32(acc[b], s, tile(ring.acquire()), g, t);
    } else {
      uint32_t a[4][4];  // P in bf16: the A operand of P V
#pragma unroll
      for (int j = 0; j < 4; ++j) hp::to_a_frag(s, j, a[j]);
#pragma unroll
      for (int b = 0; b < kFwdCapBlocks; ++b)
        if (b < nb) out_bf16(acc[b], a, ring.acquire());
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= tq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    T* orow = o + (static_cast<long>(bh) * tq + qrow[h]) * d;
#pragma unroll
    for (int b = 0; b < kFwdCapBlocks; ++b) {
      if (b >= nb) break;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(orow + (b0 + b) * kChunk + 8 * n + 2 * t,
               acc[b][4 * n + 2 * h] * inv, acc[b][4 * n + 2 * h + 1] * inv);
    }
    if (t == 0 && w == 0 && pass == 0)
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
  const Split sp = split_d(a.d, kFwdCapBlocks, kFwdMinBlocks);
  const size_t smem =
      split_smem_bytes(wg_region_bytes<T>(kFwdTiles<T>, sp.wgs));
  auto kernel = flash_fwd_dn_kernel<T, kDrop, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(split_grid_x(sp, a.tq)), a.bh, 1);
  cfg.blockDim = dim3(kSplitThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sp.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.kv_valid,
      a.seed, a.bias, a.tq, a.tk, a.d, a.scale, a.causal, a.threshold,
      a.keep_scale);
  if (err != cudaSuccess) return err;
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
// 1 bfloat16 (wgmma kernel, *route = 1); q, k, v and o 16-byte aligned.
extern "C" int tmx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const void* bias, int bias_planes,
                                       int bias_dtype, const int* kv_valid,
                                       const int* seed, int bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       uint32_t threshold, float keep_scale,
                                       int dtype, void* stream, int* route) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535 || d < kChunk ||
      d % kChunk != 0)
    return cudaErrorInvalidValue;
  if (split_grid_x(split_d(d, kFwdCapBlocks, kFwdMinBlocks), tq) >
      2147483647L)
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
  *route = dtype == 0 ? 2 : 1;
  return dtype == 0 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a);
}

// The split the forward launches with at head dim d for `rows` query
// rows (write_split in flash_dn.cuh: the same for both dtypes); -1 when
// d is not a positive multiple of 64 or `n` ints cannot hold it.
extern "C" int tmx_flash_fwd_dn_split(int d, int rows, int* out, int n) {
  if (d < kChunk || d % kChunk != 0 || rows < 1) return -1;
  return write_split(d, split_d(d, kFwdCapBlocks, kFwdMinBlocks), rows, out,
                     n);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
