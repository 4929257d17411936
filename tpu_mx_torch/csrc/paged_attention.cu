// Paged-attention decode for Hopper (sm_90a), float32 math, split over the
// keys (flash-decoding).
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
// operations-per-byte line, so the kernel has to keep enough copies in
// flight on every SM.  One block per (sequence, head) walking the
// sequence's blocks one after another leaves most of the card idle at a
// decode batch (256 blocks of 8 warps' worth of loads on 132 SMs, one
// pool block in flight each).  The design:
//   - grid (B, H, S): the keys of a row are cut into S splits of 64 keys,
//     S = ceil(NB * BS / 64) from the table's width, which the host knows:
//     no device-to-host read of the lengths, so the launch can be captured
//     in a CUDA graph and replayed with new lengths and tables.  A split
//     that starts at or past min(length, NB * BS) writes m = -1e30, l = 0
//     for its rows and exits;
//   - inside a split, tiles of 16 keys (any BS: a key's pool block and
//     slot come from table[b, pos / BS] and pos % BS) flow through a
//     3-stage cp.async ring: 16-byte chunks of key rows H*D elements apart
//     in the pool, raw bfloat16 for a bfloat16 pool (converted at use).
//     The copy of tile i+2 is issued right after tile i's one barrier, so
//     two tiles are in flight under the products; keys past
//     min(length, NB*BS) are zero-filled, never read;
//   - each of the 4 warps takes 4 keys of a tile, 8 lanes a key: a lane
//     sums the products of its 16-byte chunks of the key row with the
//     query's, for every window row, and three xor-shuffles finish each
//     dot product.  Each warp keeps its own running (m, l) per window row
//     (reduced over its 4 keys by two xor-shuffles, never by a thread
//     looping over scores) and its own output accumulator: lane i owns
//     D/32 columns, and each key's probability reaches it by a shuffle;
//   - at the end of the split the 4 warps' (m, l, acc) are folded through
//     shared memory into the split's partial (float32 scratch of
//     (B, S, Tq, H) for m and l, (B, S, Tq, H, D) for acc);
//   - a second launch, grid (B, H), folds the S partials of each row:
//     M = max m_s, L = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M) / L,
//     skipping splits with l = 0 (empty ones never wrote acc).
// Both launches are issued by one C call on the caller's stream.  Padded
// table entries past the row's length are never read, and slots past a
// window row's causal limit get probability exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 16;      // keys of a ring stage: 4 a warp
constexpr int kSplitKeys = 64;     // keys of a split
constexpr int kStages = 3;
constexpr int kTqMax = 8;
constexpr float kNegInf = -1e30f;  // finite, as in the reference: no inf-inf
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// n consecutive elements at p (n * sizeof(T) bytes, aligned to that) as
// float32.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&x)[N]) {
  if constexpr (sizeof(T) * N == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        x[i] = __uint_as_float(u[i]);
      } else {
        x[2 * i] = __uint_as_float(u[i] << 16);
        x[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(p[i]);
  }
}

__device__ __forceinline__ long part_row(int b, int s, int t, int h,
                                         int splits, int tq, int heads) {
  return (((static_cast<long>(b) * splits + s) * tq + t) * heads + h);
}

template <int D, typename T, bool kWin>
constexpr size_t split_smem_bytes() {
  // the ring (later the warps' partials), then the window's queries
  constexpr size_t ring = kStages * 2 * kTileKeys * D * sizeof(T);
  constexpr size_t fold = sizeof(float) * kWarps * kTqMax * (D + 2);
  return (ring > fold ? ring : fold) +
         sizeof(float) * (kWin ? kTqMax : 1) * D;
}

// kWin: a window of Tq <= 8 query rows (else Tq == 1).  The single-token
// instances are held to 4 blocks an SM (the 3-stage ring's shared memory
// allows 4 at D=128, float32); a window's instances may take up to 255
// registers (the compiler's default choice spilled them).
template <int D, typename T, bool kWin>
__global__ void __launch_bounds__(kThreads, kWin ? 1 : 4)
    paged_split_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int tq, int heads,
                       int bs, int nb, int splits, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim");
  constexpr int kTq = kWin ? kTqMax : 1;
  constexpr int kE = 16 / sizeof(T);          // elements of a 16-byte chunk
  constexpr int kRowChunks = D / kE;          // chunks of a key row
  constexpr int kLaneChunks = (kRowChunks + 7) / 8;  // a lane's of a row
  constexpr int kCpl = D >= 32 ? D / 32 : 1;  // output columns a lane owns
  constexpr int kRowBytes = D * sizeof(T);
  constexpr int kCopies = 2 * kTileKeys * kRowChunks;  // chunks of a tile
  constexpr size_t kRing = kStages * 2 * kTileKeys * kRowBytes;
  constexpr size_t kFold = sizeof(float) * kWarps * kTqMax * (D + 2);
  extern __shared__ float4 smem_f4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_f4);
  float* q_s = reinterpret_cast<float*>(ring + (kRing > kFold ? kRing : kFold));

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 8, j = lane % 8;
  const long total = static_cast<long>(gridDim.x) * splits * tq * heads;
  float* m_out = part_ml;
  float* l_out = part_ml + total;
  const int length = lengths[b];
  // a length past the table's NB*BS slots walks the table and no further
  // (the plain version's bound too): never a read past row b
  const int kv_end = min(length, nb * bs);
  const int start = s * kSplitKeys;
  if (start >= kv_end) {  // the split holds none of the row's keys
    if (tid < tq) {
      m_out[part_row(b, s, tid, h, splits, tq, heads)] = kNegInf;
      l_out[part_row(b, s, tid, h, splits, tq, heads)] = 0.f;
    }
    return;
  }
  const int n_tiles = min(kSplitKeys / kTileKeys,
                          (kv_end - start + kTileKeys - 1) / kTileKeys);
  const long row = static_cast<long>(heads) * D;  // one token's H*D values
  const uint32_t ring_a =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto copy_tile = [&](int i, int st) {
    const int k0 = start + i * kTileKeys;
#pragma unroll
    for (int it = 0; it < (kCopies + kThreads - 1) / kThreads; ++it) {
      const int c = tid + it * kThreads;
      if (kCopies % kThreads != 0 && c >= kCopies) break;
      const int which = c / (kTileKeys * kRowChunks);  // 0: K, 1: V
      const int r = (c / kRowChunks) % kTileKeys, x = c % kRowChunks;
      const int pos = k0 + r;
      const bool in = pos < kv_end;
      const T* from = which ? v_pool : k_pool;
      if (in)
        from += (static_cast<long>(__ldg(tables + static_cast<long>(b) * nb +
                                         pos / bs)) *
                     bs +
                 pos % bs) *
                    row +
                h * D + x * kE;
      const uint32_t dst =
          ring_a + ((st * 2 + which) * kTileKeys + r) * kRowBytes + x * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst),
                   "l"(from), "r"(in ? 16 : 0)
                   : "memory");
    }
  };
  copy_tile(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (n_tiles > 1) copy_tile(1, 1);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // the window's queries: in shared memory for a window, in registers (the
  // lane's chunks of the one query row) otherwise
  float qr[kWin ? 1 : kLaneChunks * kE];
  const float* qb = q + static_cast<long>(b) * tq * row + h * D;
  if constexpr (kWin) {
    for (int i = tid; i < tq * D; i += kThreads)
      q_s[i] = qb[static_cast<long>(i / D) * row + i % D];
  } else {
#pragma unroll
    for (int i = 0; i < kLaneChunks; ++i)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int d = (j + 8 * i) * kE + e;
        qr[i * kE + e] = d < D ? qb[d] : 0.f;
      }
  }

  float m[kTq], l[kTq], acc[kTq][kCpl];
#pragma unroll
  for (int t = 0; t < kTq; ++t) {
    m[t] = kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int c = 0; c < kCpl; ++c) acc[t][c] = 0.f;
  }
  const int kk = 4 * warp + grp;  // the key of the tile this group takes
  const bool owns = lane * kCpl < D;  // the lane owns output columns

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // tile i (and the window's queries) is in shared memory, and every
    // warp is done with tile i - 1, whose stage tile i + 2 takes
    __syncthreads();
    if (i + 2 < n_tiles) copy_tile(i + 2, (i + 2) % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const T* k_s =
        reinterpret_cast<const T*>(ring + (st * 2) * kTileKeys * kRowBytes);
    const T* v_s = reinterpret_cast<const T*>(ring + (st * 2 + 1) *
                                                         kTileKeys * kRowBytes);
    float dot[kTq];
#pragma unroll
    for (int t = 0; t < kTq; ++t) dot[t] = 0.f;
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) {
      const int x = j + 8 * c;
      if (kRowChunks % 8 != 0 && x >= kRowChunks) break;
      float kv[kE];
      load_n<T, kE>(k_s + kk * D + x * kE, kv);
#pragma unroll
      for (int t = 0; t < kTq; ++t)
        if (!kWin || t < tq)
#pragma unroll
          for (int e = 0; e < kE; ++e)
            dot[t] = fmaf(kWin ? q_s[t * D + x * kE + e] : qr[c * kE + e],
                          kv[e], dot[t]);
    }
    const int pos = start + i * kTileKeys + kk;
    float p[kTq], alpha[kTq];
#pragma unroll
    for (int t = 0; t < kTq; ++t) {
      dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], 1);
      dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], 2);
      dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], 4);
      const bool ok = pos < kv_end && pos < length - (tq - 1) + t;
      const float sc = ok ? dot[t] * scale : kNegInf;
      float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[t], mx);
      alpha[t] = exp2f((m[t] - m_new) * kLog2e);
      p[t] = ok ? exp2f((sc - m_new) * kLog2e) : 0.f;
      float sum = p[t] + __shfl_xor_sync(0xffffffffu, p[t], 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      l[t] = l[t] * alpha[t] + sum;
      m[t] = m_new;
    }
#pragma unroll
    for (int t = 0; t < kTq; ++t)
#pragma unroll
      for (int c = 0; c < kCpl; ++c) acc[t][c] *= alpha[t];
#pragma unroll
    for (int g = 0; g < 4; ++g) {  // the warp's 4 keys
      float vv[kCpl];
      if (owns) load_n<T, kCpl>(v_s + (4 * warp + g) * D + lane * kCpl, vv);
#pragma unroll
      for (int t = 0; t < kTq; ++t) {
        const float pg = __shfl_sync(0xffffffffu, p[t], 8 * g);
        if (owns)
#pragma unroll
          for (int c = 0; c < kCpl; ++c) acc[t][c] = fmaf(pg, vv[c], acc[t][c]);
      }
    }
  }

  // fold the 4 warps' states into the split's partial
  __syncthreads();  // every warp is done with the ring
  float* m_w = reinterpret_cast<float*>(ring);  // [kWarps][kTqMax]
  float* l_w = m_w + kWarps * kTqMax;           // [kWarps][kTqMax]
  float* a_w = l_w + kWarps * kTqMax;           // [kWarps][kTqMax][D]
#pragma unroll
  for (int t = 0; t < kTq; ++t) {
    if (kWin && t >= tq) continue;
    if (lane == 0) {
      m_w[warp * kTqMax + t] = m[t];
      l_w[warp * kTqMax + t] = l[t];
    }
    if (owns)
#pragma unroll
      for (int c = 0; c < kCpl; ++c)
        a_w[(warp * kTqMax + t) * D + lane * kCpl + c] = acc[t][c];
  }
  __syncthreads();
  for (int i = tid; i < tq * D; i += kThreads) {
    const int t = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * kTqMax + t]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = l_w[w * kTqMax + t];
      if (lw > 0.f) {  // a warp that saw no admitted key adds nothing
        const float f = exp2f((m_w[w * kTqMax + t] - mx) * kLog2e);
        sum += lw * f;
        a += a_w[(w * kTqMax + t) * D + d] * f;
      }
    }
    const long pr = part_row(b, s, t, h, splits, tq, heads);
    part_acc[pr * D + d] = a;
    if (d == 0) {
      m_out[pr] = mx;
      l_out[pr] = sum;
    }
  }
}

// Fold the S partials of row (b, h): out = sum acc_s e^(m_s - M) / L.
template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_merge_kernel(const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc,
                       float* __restrict__ out, int tq, int heads,
                       int splits) {
  const int b = blockIdx.x, h = blockIdx.y;
  const long total = static_cast<long>(gridDim.x) * splits * tq * heads;
  const float* m_in = part_ml;
  const float* l_in = part_ml + total;
  for (int i = threadIdx.x; i < tq * D; i += kThreads) {
    const int t = i / D, d = i % D;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) {
      const long pr = part_row(b, s, t, h, splits, tq, heads);
      if (l_in[pr] > 0.f) mx = fmaxf(mx, m_in[pr]);
    }
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long pr = part_row(b, s, t, h, splits, tq, heads);
      const float ls = l_in[pr];
      if (ls > 0.f) {  // empty splits wrote no acc
        const float f = exp2f((m_in[pr] - mx) * kLog2e);
        sum += ls * f;
        a += part_acc[pr * D + d] * f;
      }
    }
    out[((static_cast<long>(b) * tq + t) * heads + h) * D + d] =
        a / fmaxf(sum, 1e-30f);
  }
}

struct Args {
  const float* q;
  const void *k_pool, *v_pool;
  const int *tables, *lengths;
  float *out, *part_ml, *part_acc;
  int b, tq, heads, bs, nb, splits;
  float scale;
  cudaStream_t stream;
};

template <int D, typename T, bool kWin>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = split_smem_bytes<D, T, kWin>();
  auto kernel = paged_split_kernel<D, T, kWin>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.b, a.heads, a.splits), kThreads, smem, a.stream>>>(
      a.q, static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      a.tables, a.lengths, a.part_ml, a.part_acc, a.tq, a.heads, a.bs, a.nb,
      a.splits, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<D><<<dim3(a.b, a.heads), kThreads, 0, a.stream>>>(
      a.part_ml, a.part_acc, a.out, a.tq, a.heads, a.splits);
  return cudaGetLastError();
}

template <typename T, bool kWin>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<16, T, kWin>(a);
    case 32: return launch<32, T, kWin>(a);
    case 64: return launch<64, T, kWin>(a);
    case 128: return launch<128, T, kWin>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int d, const Args& a) {
  return a.tq > 1 ? dispatch_d<T, true>(d, a) : dispatch_d<T, false>(d, a);
}

}  // namespace

// q (b, tq, heads, d) float32; pools (N, bs, heads, d) float32 or
// (pool_bf16) bfloat16, 16-byte aligned; tables (b, nb) int32; lengths (b,)
// int32 >= tq; out (b, tq, heads, d) float32.  splits must be
// ceil(nb * bs / 64); part_ml (2, b, splits, tq, heads) and part_acc
// (b, splits, tq, heads, d) are float32 scratch for the splits' (m, l) and
// acc.  Issues the split and the merge launches on `stream`, and writes
// the route it took to *route (0: split-K over the keys, the only one).
extern "C" int tmx_paged_attention(const float* q, const void* k_pool,
                                   const void* v_pool, const int* tables,
                                   const int* lengths, float* out, int b,
                                   int tq, int heads, int d, int bs, int nb,
                                   float scale, int pool_bf16,
                                   float* part_ml, float* part_acc,
                                   int splits, void* stream, int* route) {
  if (tq < 1 || tq > kTqMax || b < 1 || bs < 1 || nb < 1 || heads < 1 ||
      heads > 65535 || splits > 65535 ||
      splits != (static_cast<long>(nb) * bs + kSplitKeys - 1) / kSplitKeys)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k_pool) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(v_pool) & 15) != 0)
    return cudaErrorInvalidValue;
  Args a{q,      k_pool, v_pool, tables, lengths, out,  part_ml,
         part_acc, b,    tq,     heads,  bs,      nb,   splits,
         scale,  static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      pool_bf16 ? dispatch<__nv_bfloat16>(d, a) : dispatch<float>(d, a);
  if (err == cudaSuccess) *route = 0;
  return err;
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
