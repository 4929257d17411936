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
// dq (flash_dn.cuh, design 2, the column-block design): grid (ceil(T/64),
// BH, D/64); 4 warps of 16 query rows; block z accumulates dQ's columns
// [64z, 64z + 64) and block z = 0 writes d_bias.  For each key tile of 64
// keys, S = Q K^T and dP = dO V^T are summed over D in 64-column chunks of
// Q, K, dO and V streamed through shared memory (four 64 x 64 tiles), dS
// is computed on the registers, then the block's 64 columns of the K tile
// are copied and dQ += dS K.  Every column block recomputes S and dP:
// 2*T*Tk*D*BH*(2*D/64 + 1) operations against 6 T*Tk*D*BH for one pass,
// 5.67x at D = 512; bf16 on mma.sync.m16n8k16.
//
// dk/dv (flash_dn.cuh, design 1, the split-D design): a cluster of blocks
// (split_d(d, 2, 2): D/256 blocks rounded up, at least 2 and at most 8,
// each of two warpgroups of up to 128 columns of dK and of dV; passes of
// clusters beyond D = 2048) owns 64 key rows; grid (cluster x passes x key
// tiles, BH).  For each query tile of 64 queries (from the diagonal when
// causal) each warpgroup sums its partial S^T = K Q^T and dP^T = V dO^T
// over its own 64-column blocks, streamed through its ring; exchange sums
// them across the cluster; every warpgroup computes P^T and dS^T on the
// whole tile (the query index is the column; lse and delta read from
// device memory) and dV += P^T dO, dK += dS^T Q on its own columns.
// What it does about the column blocks: each score product is done
// once a pair of tiles ((2 D/64 + 2) / 4 = 4.5x fewer operations at D =
// 512, 8.5x at 1024), each block reads only its slice of K, V, Q and dO;
// the ring keeps the next steps' copies in flight; bf16 runs SS wgmma for
// the score products and RS wgmma (P^T, dS^T from registers) for the
// output products.  8 T*Tk*D*BH operations (about half causal).
// float32 runs 3xTF32 mma.sync in both kernels (flash_dn.cuh).
// The C entry points send bfloat16 to the mma.sync dq kernel (route 3) and
// the wgmma dk/dv kernel (route 1), float32 to the 3xTF32 ones (route 2);
// nothing else falls back.
#include "flash_dn.cuh"

namespace hp = tmx_hopper;

namespace {

using namespace tmx_dn;

template <typename T>
constexpr size_t dq_smem_bytes() {
  return 4 * tile_bytes<T>();  // Q, dO, K, V chunks
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

// kResident (one pass): K and V resident, Q and dO staged once a query
// tile for both the score and the output products (7-33% less device
// time than the ring alone: flash_dn.cuh); else, with more than one pass
// of clusters, every operand streams through the ring.
template <typename T, typename BT, bool kResident>
__global__ void __launch_bounds__(kSplitThreads, 1)
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
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr uint32_t kTile = kTileBytes<T>;
  constexpr int kCap = kDkvCapBlocks<T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* base_g = smem_raw + (base - raw);

  const Split sp = split_d(d, kCap, kDkvMinBlocks);
  const int half = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the m16n8 fragment coordinates
  const int rank = static_cast<int>(cluster_ctarank());
  const int w = 2 * rank + half;
  const int x = blockIdx.x / sp.cluster, pass = x % sp.passes;
  const int k0 = (x / sp.passes) * kRows;
  int b0, nb, sb0, snb;  // this warpgroup's blocks of dK, dV; the scores
  slice_of(d, sp, pass, w, b0, nb);
  score_slice_of(d, sp, w, sb0, snb);
  const uint32_t region = dkv_region_bytes<T>(kResident, sp.wgs);
  const uint32_t mine = base + half * region;
  // [S^T partial][dP^T partial][owned P^T, dS^T groups], past the tiles
  const uint32_t part = dkv_tiles<T>(kResident) * kTile;
  const Exchange ex{base, region, part, sp.wgs, w, rank, tid, false, false, 0};

  const int bh = blockIdx.y;
  const long qoff = static_cast<long>(bh) * tq;
  const long koff = static_cast<long>(bh) * tk;
  const T* qb = q + qoff * d;
  const T* dob = dout + qoff * d;
  const T* kb = k + koff * d;
  const T* vb = v + koff * d;
  const int valid = valid_keys(kv_valid, bh, tk);
  const bool drop = seed != nullptr;
  // the two key rows of this thread's accumulator registers
  const int krow[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const long plane =
      kBias ? static_cast<long>(bh % bias.planes) * tq * static_cast<long>(tk)
            : 0;
  // a key tile wholly past kv_valid runs no query tile and writes zeros
  const int n_qt = k0 < valid ? (tq + kChunk - 1) / kChunk : 0;
  const int qt0 = causal ? k0 / kChunk : 0;
  auto tile = [&](uint32_t at) {  // a tile as float32 (generic)
    return reinterpret_cast<const float*>(base_g + (at - base));
  };
  auto score = [&](float (&acc)[32], uint32_t a, uint32_t b) {
    if constexpr (kF32)
      score_f32(acc, tile(a) + 16 * warp * kLd<float>, tile(b), g, t);
    else
      score_bf16(acc, a, b);
  };

  float dk_acc[kCap][32], dv_acc[kCap][32];
#pragma unroll
  for (int b = 0; b < kCap; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;
  float st[32], dpt[32];  // S^T (later P^T), dP^T (later dS^T)

  // The exchange of dk/dv: every warpgroup writes its partial S^T and
  // dP^T; the owner of group q (warpgroup q % n) sums both over the n
  // warpgroups in order, reading them from the cluster, turns the sums
  // into P^T = exp(S^T scale + bias - lse) (dropped: z/(1-r) p) and
  // dS^T = p (z/(1-r) dP^T - delta) scale, element by element, and keeps
  // them beside its partials; then every warpgroup reads every group from
  // its owner.  So the probabilities are computed once, not by every
  // warpgroup, and a warpgroup moves about four tiles' bytes however many
  // share the tile.  Two cluster barriers: a partial is rewritten only
  // after the next tile's products, once the owners have read it (the
  // second barrier); the owned groups only after the next tile's first
  // barrier, once every warpgroup has read them.
  auto exchange = [&](int q0) {
    const uint32_t dp_part = part + kPartBytes, res = part + 2 * kPartBytes;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      ex.store(part, c, st[4 * c], st[4 * c + 1], st[4 * c + 2],
               st[4 * c + 3]);
      ex.store(dp_part, c, dpt[4 * c], dpt[4 * c + 1], dpt[4 * c + 2],
               dpt[4 * c + 3]);
    }
    ex.sync();
    const uint32_t row_key =
        drop ? dropout_row_key(static_cast<uint32_t>(__ldg(seed)), bh) : 0u;
    for (int c = w, r = 0; c < kGroups; c += ex.n, ++r) {
      float sv[4] = {0.f, 0.f, 0.f, 0.f}, dv4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int u = 0; u < ex.n; ++u) {
        const float4 a = ex.load(u, part, c), b = ex.load(u, dp_part, c);
        sv[0] += a.x;
        sv[1] += a.y;
        sv[2] += a.z;
        sv[3] += a.w;
        dv4[0] += b.x;
        dv4[1] += b.y;
        dv4[2] += b.z;
        dv4[3] += b.w;
      }
      // register 4c + i: key row krow[i / 2], query q0 + 8c + 2t + i % 2
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qp = q0 + 8 * c + 2 * t + e;
        const bool q_in = qp < tq;
        const float lq = q_in ? __ldg(lse + qoff + qp) : 0.f;
        const float dlq = q_in ? __ldg(delta + qoff + qp) : 0.f;
        const uint32_t qkey = drop ? dropout_q_key(row_key, qp) : 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * h + e, kp = krow[h];
          const bool ok = q_in && kp < valid && (!causal || kp <= qp);
          float xs = sv[i] * scale;
          if constexpr (kBias)
            xs += ok ? bias_value<BT>(bias.ptr,
                                      plane + static_cast<long>(qp) * tk + kp)
                     : 0.f;
          const float p = ok ? expf(xs - lq) : 0.f;
          float pd = p, gd = dv4[i];
          if (drop) {
            const bool keep = dropout_keep(qkey, kp, threshold);
            pd = keep ? p * keep_scale : 0.f;
            gd = keep ? gd * keep_scale : 0.f;
          }
          sv[i] = pd;
          dv4[i] = p * (gd - dlq) * scale;
        }
      }
      ex.store(res, 2 * r, sv[0], sv[1], sv[2], sv[3]);
      ex.store(res, 2 * r + 1, dv4[0], dv4[1], dv4[2], dv4[3]);
    }
    ex.sync();
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      const int o = c % ex.n, r = c / ex.n;
      const float4 a = ex.load(o, res, 2 * r), b = ex.load(o, res, 2 * r + 1);
      st[4 * c] = a.x;
      st[4 * c + 1] = a.y;
      st[4 * c + 2] = a.z;
      st[4 * c + 3] = a.w;
      dpt[4 * c] = b.x;
      dpt[4 * c + 1] = b.y;
      dpt[4 * c + 2] = b.z;
      dpt[4 * c + 3] = b.w;
    }
  };
  // dK += dS^T Q (Q's tile at q_at), then dV += P^T dO (at d_at), on
  // block b of this warpgroup's columns; `between` runs between the two
  // (the resident path's next copy of Q)
  auto outputs = [&](int b, uint32_t q_at, uint32_t d_at, auto between) {
    if constexpr (kF32) {
      out_f32(dk_acc[b], dpt, tile(q_at), g, t);
      between();
      out_f32(dv_acc[b], st, tile(d_at), g, t);
    } else {
      uint32_t a[4][4];  // dS^T, then P^T, in bf16: the A operand
#pragma unroll
      for (int j = 0; j < 4; ++j) hp::to_a_frag(dpt, j, a[j]);
      out_bf16(dk_acc[b], a, q_at);
      between();
#pragma unroll
      for (int j = 0; j < 4; ++j) hp::to_a_frag(st, j, a[j]);
      out_bf16(dv_acc[b], a, d_at);
    }
  };

  if constexpr (kResident) {
    // [kCap] K, [kCap] V, [kCap] Q, [kCap] dO tiles.  A query tile's Q is
    // copied once its predecessor's dS^T Q products are done (it lands
    // during the P^T dO products), its dO once the P^T dO products are
    // (it lands during the S^T products): two cp.async groups a tile
    const uint32_t k_at = mine, v_at = mine + kCap * kTile;
    const uint32_t q_at = v_at + kCap * kTile, do_at = q_at + kCap * kTile;
    auto stage = [&](uint32_t dst, const T* src, int r0, int rows) {
      for (int b = 0; b < nb; ++b)
        copy_block<T>(dst + b * kTile, src, r0, rows, d, (b0 + b) * kChunk,
                      tid);
    };
    if (qt0 < n_qt) {
      stage(k_at, kb, k0, tk);
      stage(v_at, vb, k0, tk);
      stage(q_at, qb, qt0 * kChunk, tq);
    }
    hp::cp_async_commit();
    if (qt0 < n_qt) stage(do_at, dob, qt0 * kChunk, tq);
    hp::cp_async_commit();
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kChunk;
      const bool more = qt + 1 < n_qt;
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      landed<T>(1, half);  // K, V and this tile's Q
      for (int b = 0; b < nb; ++b)
        score(st, k_at + b * kTile, q_at + b * kTile);
      landed<T>(0, half);  // this tile's dO
      for (int b = 0; b < nb; ++b)
        score(dpt, v_at + b * kTile, do_at + b * kTile);
      exchange(q0);
#pragma unroll
      for (int b = 0; b < kCap; ++b)
        if (b < nb)
          outputs(b, q_at + b * kTile, do_at + b * kTile, [&] {
            if (b + 1 < nb) return;
            wg_sync(half);  // every dS^T Q product is done
            if (more) stage(q_at, qb, q0 + kChunk, tq);
            hp::cp_async_commit();
          });
      if (nb == 0) hp::cp_async_commit();
      wg_sync(half);  // every P^T dO product is done
      if (more) stage(do_at, dob, q0 + kChunk, tq);
      hp::cp_async_commit();
    }
  } else {
    // a query tile's stream: (K, Q) for each score block, (V, dO) for
    // each, then (Q, dO) for each output block
    const int tpt = 4 * snb + 2 * nb;
    const int total = max(n_qt - qt0, 0) * tpt;
    auto issue = [&](int i, uint32_t dst) {
      if (i >= total) return;
      const int q0 = (qt0 + i / tpt) * kChunk, s = i % tpt;
      const bool first = s % 2 == 0;
      if (s < 4 * snb) {
        const int c = (sb0 + (s % (2 * snb)) / 2) * kChunk;
        const bool ds = s >= 2 * snb;  // (V, dO) else (K, Q)
        if (first)
          copy_block<T>(dst, ds ? vb : kb, k0, tk, d, c, tid);
        else
          copy_block<T>(dst, ds ? dob : qb, q0, tq, d, c, tid);
      } else {
        const int c = (b0 + (s - 4 * snb) / 2) * kChunk;
        copy_block<T>(dst, first ? qb : dob, q0, tq, d, c, tid);
      }
    };
    Ring<T, decltype(issue)> ring{mine, half, 0, issue};
    ring.start();
    for (int qt = qt0; qt < n_qt; ++qt) {
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      for (int b = 0; b < snb; ++b) {
        const uint32_t a = ring.acquire();
        score(st, a, ring.acquire());
      }
      for (int b = 0; b < snb; ++b) {
        const uint32_t a = ring.acquire();
        score(dpt, a, ring.acquire());
      }
      exchange(qt * kChunk);
#pragma unroll
      for (int b = 0; b < kCap; ++b)
        if (b < nb) {
          const uint32_t q_at = ring.acquire();
          outputs(b, q_at, ring.acquire(), [] {});
        }
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory

  // key rows past kv_valid (or in a tile that ran no query tile) hold 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= tk) continue;
    T* krow_o = dk + (koff + krow[h]) * d;
    T* vrow_o = dv + (koff + krow[h]) * d;
#pragma unroll
    for (int b = 0; b < kCap; ++b) {
      if (b >= nb) break;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = (b0 + b) * kChunk + 8 * n + 2 * t;
        store2(krow_o + c, dk_acc[b][4 * n + 2 * h],
               dk_acc[b][4 * n + 2 * h + 1]);
        store2(vrow_o + c, dv_acc[b][4 * n + 2 * h],
               dv_acc[b][4 * n + 2 * h + 1]);
      }
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
    const Split sp = split_d(a.d, kDkvCapBlocks<T>, kDkvMinBlocks);
    const bool resident = sp.passes == 1;
    const size_t smem = split_smem_bytes(dkv_region_bytes<T>(resident, sp.wgs));
    auto kernel = resident ? flash_dkv_dn_kernel<T, BT, true>
                           : flash_dkv_dn_kernel<T, BT, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim =
        dim3(static_cast<unsigned>(split_grid_x(sp, a.tk)), a.bh, 1);
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
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.bias,
        a.kv_valid, a.seed, a.tq, a.tk, a.d, a.scale, a.causal, a.threshold,
        a.keep_scale);
    if (err != cudaSuccess) return err;
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

// dk/dv's split of head dim d for dtype (0 float32, 1 bfloat16).
Split dkv_split(int d, int dtype) {
  return split_d(d,
                 dtype == 0 ? kDkvCapBlocks<float>
                            : kDkvCapBlocks<__nv_bfloat16>,
                 kDkvMinBlocks);
}

template <int kKind>
int run(const Args& a, int dtype, const void* out0, const void* out1,
        int* route) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.bh > 65535 || a.d < kChunk ||
      a.d % kChunk != 0)
    return cudaErrorInvalidValue;
  if (kKind == 0 && a.d / kChunk > 65535) return cudaErrorInvalidValue;
  if (kKind == 1 && split_grid_x(dkv_split(a.d, dtype), a.tk) > 2147483647L)
    return cudaErrorInvalidValue;
  if (a.bias.ptr != nullptr &&
      (a.bias.planes < 1 || a.bh % a.bias.planes != 0 || a.bias.dtype < 0 ||
       a.bias.dtype > 2))
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.dout) || !aligned16(out0) || !aligned16(out1))
    return cudaErrorInvalidValue;
  *route = dtype == 0 ? 2 : kKind == 0 ? 3 : 1;
  return dtype == 0 ? dispatch<kKind, float>(a)
                    : dispatch<kKind, __nv_bfloat16>(a);
}

}  // namespace

// The C interface of flash_attention_bwd.cu, for any head dim d that is a
// positive multiple of 64.  dtype: 0 float32 (3xTF32 kernels, *route = 2),
// 1 bfloat16 (dq: the mma.sync kernel, *route = 3; dk/dv: the wgmma
// kernel, *route = 1).
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

// The split dk/dv launches with at head dim d for dtype (0 float32, 1
// bfloat16) and `rows` key rows (write_split in flash_dn.cuh); -1 when d
// is not a positive multiple of 64 or `n` ints cannot hold it.
extern "C" int tmx_flash_dkv_dn_split(int d, int dtype, int rows, int* out,
                                      int n) {
  if (d < kChunk || d % kChunk != 0 || rows < 1 || (dtype != 0 && dtype != 1))
    return -1;
  return write_split(d, dkv_split(d, dtype), rows, out, n);
}

extern "C" const char* tmx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
