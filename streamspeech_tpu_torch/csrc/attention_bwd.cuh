// The backward of softmax(q Kᵀ·scale + additive bias)·V with dropout, fp32, for
// Hopper (sm_90a): the body shared by masked_attention_bwd.cu (causal, key
// bias) and bias_attention_bwd.cu (arbitrary [B, TQ, TK] bias), which differ
// only in where the additive bias comes from. The tensor-core and copy
// helpers are tc_mma.cuh's.
//
// Replaces `_causal_bwd_kernel` and `_bias_bwd_kernel` of
// streamspeech_tpu/ops/pallas_attention.py. Each block recomputes
// p = exp(s * scale + bias - max) / sum from the forward's row statistics,
// regenerates the keep factors kf of dropout.cuh (drawn beside the
// exponentials, tc_mma.cuh keep_slab), and forms
//   s = q Kᵀ,  dp = (g Vᵀ) * kf,  ds = p * (dp - delta) * scale,
//   dq = ds K,  dK = dsᵀ q,  dV = (p * kf)ᵀ g.
// The TPU kernels carry dK and dV across query blocks along their ordered
// grid; Hopper blocks run in no order, so there are two forms, neither with
// atomics (one seed gives the same gradients bit for bit):
//   - two passes (B4; B6 above one key tile): delta = rowsum(g * out), a dQ
//     pass (a block per query tile, key tiles streamed, the last query tiles
//     of the causal triangle launched first) and a dK/dV pass (a block per
//     key tile, query tiles streamed from the diagonal down, the first key
//     tiles launched first). Both recompute s and dp: 14 products' worth of
//     work instead of 10, the price of keeping 8 bytes a row, not TQ*TK*4.
//   - fused (B6 while the keys fit one tile, the unit decoder's TK = 48): a
//     block per (group of query tiles, h, b) keeps K and V, forms delta =
//     rowsum(p * dp) itself, writes dq and partial dK/dV over its query
//     tiles; a second kernel adds the partials in group order. 10 products.
//
// What bounds it: at the train shapes B4 is bound by operations (33.6 GFLOP
// of products against 169 MB at [8,8,1280,64]) and B6 by bytes (2.4 GFLOP
// against 84 MB). The products run on the tensor cores as m16n8k8 TF32
// `mma.sync`, fp32-faithful by splitting each operand into hi = tf32(x)
// (`cvt.rna`) and lo = x - hi (read by the tensor core truncated to tf32) and
// summing lo·hi + hi·lo + hi·hi into fp32 accumulators (3xTF32: the bound is
// 3 flops / 495 TFLOP/s, 2.5x the CUDA cores' 67).
// `mma.sync` and not `wgmma`: TF32 `wgmma` reads its operands K-major only,
// and dq, dK and dV contract over the rows of K, q and g; `mma.sync`
// fragments are read from shared memory in either orientation. Tiles stream
// through a two-stage ring filled by 16-byte `cp.async`, so the next tile
// loads while this one's products run; rows are padded against bank
// conflicts. 8 warps; tiles of 64 rows up to D = 120 and 32 above. Head dims:
// every multiple of 8 from 8 to 256.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace attn_bwd {

using namespace tc;

constexpr int kThreads = 256;  // 16 x 16: ty owns BT/16 rows, tx BT/16 columns / D/16 channels
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e9f;

// delta[row] = sum_d g[row, d] * out[row, d]; one warp per row.
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const float* __restrict__ g, const float* __restrict__ out,
              float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += g[row * D + d] * out[row * D + d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) delta[row] = sum;
}

inline int launch_rowdot(const float* g, const float* out, float* delta, long long rows,
                         int D, cudaStream_t stream) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  rowdot_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(g, out, delta, rows, D);
  return (int)cudaGetLastError();
}

// Causal mask computed from the indices plus a key-validity bias [B, T]; the
// adds are in the forward's order.
struct CausalBias {
  static constexpr bool kCausal = true;
  const float* kvb;
  int T;
  __device__ __forceinline__ float add(float x, int b, int row, int col) const {
    x += kvb[(size_t)b * T + col];
    if (col > row) x += kNegInf;
    return x;
  }
};

// An arbitrary additive bias [B, TQ, TK] that carries the whole mask.
struct FullBias {
  static constexpr bool kCausal = false;
  const float* bias;
  int TQ, TK;
  __device__ __forceinline__ float add(float x, int b, int row, int col) const {
    return x + bias[((size_t)b * TQ + row) * TK + col];
  }
};

constexpr int kWarps = kThreads / 32;

// The tile layout of one head dim: BT-row tiles (queries and keys alike), rows
// padded by 4 floats: a [BT, D] tile's rows are LDD = D + 4 floats, a [BT, BT]
// score tile's LDS = BT + 4. Lanes (g, t) = (lane / 4, lane % 4) reading the
// fragment elements (r0 + g, c0 + t) then hit 32 banks; reading (r0 + t,
// c0 + g), the other orientation, two lanes share a bank. Padding keeps each
// fragment address a constant offset from a base; an XOR swizzle free of
// conflicts both ways costs index arithmetic on every read instead.
// In the score phase warp w owns rows 16*(w % WR) .. +16 of the [BT, BT] score
// tile and NT 8-column slabs from 8*NT*(w / WR); in the product phases it owns
// the same 16 rows of a [BT, D] output and the 8-column slabs w / WR + WC*j.
template <int D>
struct Tiles {
  static constexpr int LDD = D + 4;
  static constexpr int lds(int bt) { return bt + 4; }  // row stride of a score tile
  // K, V, two stages of q and g, the ds and p*kf tiles, two stages of 3 row
  // numbers (max, 1/sum, delta) and WC row partials of delta, in floats
  static constexpr size_t floats(int bt) {
    return (size_t)6 * bt * LDD + 2 * bt * lds(bt) + 6 * bt + (kWarps / (bt / 16)) * bt;
  }
  static constexpr int BT = floats(64) * 4 <= kMaxSmem ? 64 : 32;
  static constexpr int LDS = lds(BT);
  static constexpr size_t kSmem = floats(BT) * 4;
  // the dQ pass: q, g, two stages of K and V, the ds tile
  static constexpr size_t kDqSmem = ((size_t)6 * BT * LDD + BT * LDS) * 4;
  static constexpr int WR = BT / 16, WC = kWarps / WR, NT = BT / 8 / WC;
  static constexpr int NO = (D / 8 + WC - 1) / WC;
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  static_assert(kSmem <= kMaxSmem, "tiles do not fit shared memory");
};

// Rows [r0, r0 + BT) of a [n, D] matrix into a padded [BT][LDD] tile by
// 16-byte cp.async, zeros past row n.
template <int D>
__device__ __forceinline__ void async_tile(float* tile, const float* __restrict__ src, int r0,
                                           int n, int tid) {
  async_load<Tiles<D>::BT, D, Tiles<D>::LDD>(tile, src, r0, n, tid, kThreads);
}

// Rows [r0, r0 + BT) of the forward's statistics [n, 2] (and, given, delta
// [n]) into st[0, 2 BT) (and st[2 BT, 3 BT)), zeros past row n.
template <int BT>
__device__ __forceinline__ void async_rows(float* st, const float* __restrict__ stats,
                                           const float* __restrict__ delta, int r0, int n,
                                           int tid) {
  const int count = delta ? 3 * BT : 2 * BT;
  for (int i = tid; i < count; i += kThreads) {
    const bool is_stat = i < 2 * BT;
    const int r = is_stat ? i / 2 : i - 2 * BT;
    const bool in = r0 + r < n;
    const float* src = is_stat ? stats + (size_t)(r0 + r) * 2 + (i & 1) : delta + r0 + r;
    cp_async4(st + i, in ? src : stats, in);
  }
}

// s = q Kᵀ and dp = g Vᵀ of the warp's [16, 8 NT] part of a [BT, BT] score
// tile: q, g tiles of queries, K, V tiles of keys, contracted over D.
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* gs, const float* ks,
                                       const float* vs, int wr, int wc, int g, int q,
                                       float s[][4], float dp[][4]) {
  constexpr int LDD = Tiles<D>::LDD, NT = Tiles<D>::NT;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    uint32_t qh[4], ql[4], gh[4], gl[4];
    load_a<false>(qs, LDD, 16 * wr, k0, g, q, qh, ql);
    load_a<false>(gs, LDD, 16 * wr, k0, g, q, gh, gl);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int n0 = 8 * (wc * NT + n);
      uint32_t kh[2], kl[2], vh[2], vl[2];
      load_b<true>(ks, LDD, k0, n0, g, q, kh, kl);
      load_b<true>(vs, LDD, k0, n0, g, q, vh, vl);
      mma3(s[n], qh, ql, kh, kl);
      mma3(dp[n], gh, gl, vh, vl);
    }
  }
}

// In place: s <- p = exp(s * scale + bias - max) / sum (0 outside [TQ, TK]),
// dp <- dp * kf; with pks, also p * kf into that [BT][BT] tile. Rows q0 +
// 16 wr + g (+ 8), columns k0 + 8 (wc NT + n) + 2 q (+ 1). kf drawn from
// the lane's Philox row `dr` where `dropped`, else 1.
template <int D, class Bias>
__device__ __forceinline__ void probs(float s[][4], float dp[][4], float* pks, const Bias& bias,
                                      int b, int q0, int k0, int TQ, int TK, const float mx[2],
                                      const float il[2], float scale, bool dropped,
                                      const dropout::Row& dr, uint32_t thr, float inv_keep,
                                      int wr, int wc, int g, int q) {
  constexpr int LDS = Tiles<D>::LDS, NT = Tiles<D>::NT;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int slab = 8 * (wc * NT + n);
    const uint32_t kb = dropped ? keep_slab(dr, k0 + slab, q, thr) : 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = 16 * wr + g + (e >> 1) * 8, cl = slab + 2 * q + (e & 1);
      const int row = q0 + rl, col = k0 + cl;
      float p = 0.f;
      if (row < TQ && col < TK)
        p = expf(bias.add(s[n][e] * scale, b, row, col) - mx[e >> 1]) * il[e >> 1];
      s[n][e] = p;
      if (dropped) dp[n][e] = keep_apply(kb, e, dp[n][e], inv_keep);
      if (pks) pks[rl * LDS + cl] = dropped ? keep_apply(kb, e, p, inv_keep) : p;
    }
  }
}

// probs for the fused B6 pass: one copy for both rates; each slab's keep
// factors kf (1 at rate 0) drawn from a Philox row formed for that slab, so
// that no row state lives across the products and the slabs' draws are
// independent. tools/sweep_dropout.py read B6's dropout gap 0.006-0.008 ms
// this way, 0.011-0.014 with `probs` in a copy for dropout (the row formed
// once a tile), 0.011-0.012 with one row a tile in this form.
template <int D, class Bias>
__device__ __forceinline__ void probs_fused(float s[][4], float dp[][4], float* pks,
                                            const Bias& bias, int b, int h, int q0, int k0,
                                            int TQ, int TK, const float mx[2],
                                            const float il[2], float scale, bool drop,
                                            unsigned long long sd, uint32_t thr,
                                            float inv_keep, int wr, int wc, int g, int q) {
  constexpr int LDS = Tiles<D>::LDS, NT = Tiles<D>::NT;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int slab = 8 * (wc * NT + n);
    float kf[4] = {1.f, 1.f, 1.f, 1.f};
    if (drop) {
      const uint32_t kb =
          keep_slab(keep_lane(sd, b, h, q0 + 16 * wr + g, q), k0 + slab, q, thr);
#pragma unroll
      for (int e = 0; e < 4; ++e) kf[e] = (kb >> e) & 1u ? inv_keep : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = 16 * wr + g + (e >> 1) * 8, cl = slab + 2 * q + (e & 1);
      const int row = q0 + rl, col = k0 + cl;
      float p = 0.f;
      if (row < TQ && col < TK)
        p = expf(bias.add(s[n][e] * scale, b, row, col) - mx[e >> 1]) * il[e >> 1];
      s[n][e] = p;
      dp[n][e] *= kf[e];
      pks[rl * LDS + cl] = p * kf[e];
    }
  }
}

// One score tile (rows q0.., keys k0..) from the products to p and dp * kf:
// kDraw, the copy for dropout (`dr` the lane's Philox row), or `serial_drop`
// where the head dim has none.
template <int D, bool kDraw, class Bias>
__device__ __forceinline__ void score_tile(const float* qs, const float* gs, const float* ks,
                                           const float* vs, float s[][4], float dp[][4],
                                           float* pks, const Bias& bias, int b, int h, int q0,
                                           int k0, int TQ, int TK, const float mx[2],
                                           const float il[2], float scale, bool serial_drop,
                                           unsigned long long sd, uint32_t thr,
                                           const dropout::Row& dr, float inv_keep, int wr,
                                           int wc, int g, int q) {
  scores<D>(qs, gs, ks, vs, wr, wc, g, q, s, dp);
  const dropout::Row r =
      kDraw || !serial_drop ? dr : keep_lane(sd, b, h, q0 + 16 * wr + g, q);
  probs<D>(s, dp, pks, bias, b, q0, k0, TQ, TK, mx, il, scale, kDraw || serial_drop, r, thr,
           inv_keep, wr, wc, g, q);
}

// ds = p * (dp * kf - delta) * scale into the [BT][BT] tile dss.
template <int D>
__device__ __forceinline__ void grads(const float s[][4], const float dp[][4], float* dss,
                                      const float dl[2], float scale, int wr, int wc, int g,
                                      int q) {
  constexpr int LDS = Tiles<D>::LDS, NT = Tiles<D>::NT;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = 16 * wr + g + (e >> 1) * 8, cl = 8 * (wc * NT + n) + 2 * q + (e & 1);
      dss[rl * LDS + cl] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;
    }
}

// The dQ pass: one block per (query tile, h, b), the last query tiles (the
// longest walks of the causal triangle) launched first; K and V tiles stream
// through a two-stage cp.async ring while the previous tile's products run.
template <int D, class Bias>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ g,
          const float* __restrict__ stats, const float* __restrict__ delta, Bias bias,
          const long long* __restrict__ seed, float rate, uint32_t thr,
          float* __restrict__ dq, int B, int H, int TQ, int TK, float scale) {
  using T = Tiles<D>;
  constexpr int BT = T::BT, TILE = BT * T::LDD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + TILE;
  float* kvs = gs + TILE;         // [2 stages][K, V]
  float* dss = kvs + 4 * TILE;    // [BT][LDS]

  const int nq = (TQ + BT - 1) / BT;
  const int bh = blockIdx.x % (B * H), qt = nq - 1 - (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, w = tid / 32, lg = (tid % 32) / 4, lq = tid % 4;
  const int wr = w % T::WR, wc = w / T::WR;
  const size_t base_q = (size_t)bh * TQ, base_k = (size_t)bh * TK;
  const float* kh = k + base_k * D;
  const float* vh = v + base_k * D;
  const int q0 = qt * BT;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  const bool serial_drop = D > kDropoutCopyMaxD && drop;  // no copy for dropout
  // the lane's Philox row: the block's rows are fixed along its key tiles
  const dropout::Row dr = keep_lane(sd, b, h, q0 + 16 * wr + lg, lq);

  async_tile<D>(qs, q + base_q * D, q0, TQ, tid);
  async_tile<D>(gs, g + base_q * D, q0, TQ, tid);
  async_tile<D>(kvs, kh, 0, TK, tid);
  async_tile<D>(kvs + TILE, vh, 0, TK, tid);
  cp_commit();

  float mx[2], il[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * wr + lg + 8 * i;
    const bool in = row < TQ;
    mx[i] = in ? stats[(base_q + row) * 2] : 0.f;
    il[i] = in ? stats[(base_q + row) * 2 + 1] : 0.f;
    dl[i] = in ? delta[base_q + row] : 0.f;
  }
  float acc[T::NO][4], s[T::NT][4], dp[T::NT][4];
  zero<T::NO>(acc);

  // causal: key tiles above the diagonal weigh 0, as in the forward
  const int kend = Bias::kCausal ? min(q0 + BT, TK) : TK;
  for (int k0 = 0, it = 0; k0 < kend; k0 += BT, ++it) {
    const float* ks = kvs + (it & 1) * 2 * TILE;
    const float* vs = ks + TILE;
    if (k0 + BT < kend) {
      float* next = kvs + ((it + 1) & 1) * 2 * TILE;
      async_tile<D>(next, kh, k0 + BT, TK, tid);
      async_tile<D>(next + TILE, vh, k0 + BT, TK, tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    with_draws<D>(drop, [&](auto draw) {
      score_tile<D, decltype(draw)::value>(qs, gs, ks, vs, s, dp, nullptr, bias, b, h, q0, k0,
                                           TQ, TK, mx, il, scale, serial_drop, sd, thr, dr,
                                           inv_keep, wr, wc, lg, lq);
    });
    grads<D>(s, dp, dss, dl, scale, wr, wc, lg, lq);
    __syncthreads();
    product<BT, T::NO, T::WC, D / 8, false>(acc, dss, T::LDS, 16 * wr, ks, T::LDD, wc, lg, lq);
    __syncthreads();
  }
  store_frags<D, T::NO, T::WC>(dq + base_q * D, acc, q0 + 16 * wr, TQ, wc, lg, lq);
}

// The dK/dV side: one block per key tile and (h, b), K and V resident, query
// tiles (q, g, their row statistics and delta) through a two-stage cp.async
// ring. Two forms:
//  - kFused = false, the dK/dV pass: the first key tiles (the longest walks of
//    the causal triangle) launched first, query tiles from the diagonal down,
//    delta from the delta pass, dK and dV written to dk, dv.
//  - kFused = true (B6 while TK <= BT, one key tile): block (group gr, h, b)
//    takes query tiles gr, gr + G, ...; it forms delta = rowsum(p * dp * kf)
//    itself (all keys are in its tile), writes the whole dq of its rows, and
//    its partial dK, dV to part[0|1][gr] ([2][G][B][H][TK][D]), which
//    reduce_kernel adds in the order gr = 0..G-1.
template <int D, class Bias, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ g,
           const float* __restrict__ stats, const float* __restrict__ delta, Bias bias,
           const long long* __restrict__ seed, float rate, uint32_t thr,
           float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int B,
           int H, int TQ, int TK, int G, float scale) {
  using T = Tiles<D>;
  constexpr int BT = T::BT, TILE = BT * T::LDD;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + TILE;
  float* qgs = vs + TILE;           // [2 stages][q, g]
  float* dss = qgs + 4 * TILE;      // [BT][LDS]
  float* pks = dss + BT * T::LDS;   // [BT][LDS]
  float* sts = pks + BT * T::LDS;   // [2 stages][3 BT]: max, 1/sum by row pairs, delta
  float* red = sts + 6 * BT;        // [WC][BT] row partials of delta (kFused)

  const int nq = (TQ + BT - 1) / BT;
  const int bh = blockIdx.x % (B * H), tile = (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, w = tid / 32, lg = (tid % 32) / 4, lq = tid % 4;
  const int wr = w % T::WR, wc = w / T::WR;
  const size_t base_q = (size_t)bh * TQ, base_k = (size_t)bh * TK;
  const float* qh = q + base_q * D;
  const float* gh = g + base_q * D;
  const float* sth = stats + base_q * 2;
  const float* dlh = kFused ? nullptr : delta + base_q;
  const int k0 = kFused ? 0 : tile * BT;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  const bool serial_drop = D > kDropoutCopyMaxD && drop;  // no copy for dropout
  // causal: query tiles above the key tile see none of its keys
  const int first = kFused ? tile : (Bias::kCausal ? k0 / BT : 0);
  const int stride = kFused ? G : 1;

  async_tile<D>(ks, k + base_k * D, k0, TK, tid);
  async_tile<D>(vs, v + base_k * D, k0, TK, tid);
  async_tile<D>(qgs, qh, first * BT, TQ, tid);
  async_tile<D>(qgs + TILE, gh, first * BT, TQ, tid);
  async_rows<BT>(sts, sth, dlh, first * BT, TQ, tid);
  cp_commit();

  float dka[T::NO][4], dva[T::NO][4], s[T::NT][4], dp[T::NT][4];
  zero<T::NO>(dka);
  zero<T::NO>(dva);
  for (int qt = first, it = 0; qt < nq; qt += stride, ++it) {
    const int q0 = qt * BT, stage = it & 1;
    const float* qs = qgs + stage * 2 * TILE;
    const float* gs = qs + TILE;
    const float* st = sts + stage * 3 * BT;
    if (qt + stride < nq) {
      const int next = (qt + stride) * BT, ns = stage ^ 1;
      async_tile<D>(qgs + ns * 2 * TILE, qh, next, TQ, tid);
      async_tile<D>(qgs + ns * 2 * TILE + TILE, gh, next, TQ, tid);
      async_rows<BT>(sts + ns * 3 * BT, sth, dlh, next, TQ, tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    float mx[2], il[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 16 * wr + lg + 8 * i;
      mx[i] = st[2 * rl];
      il[i] = st[2 * rl + 1];
      dl[i] = kFused ? 0.f : st[2 * BT + rl];
    }
    if constexpr (kFused) {
      scores<D>(qs, gs, ks, vs, wr, wc, lg, lq, s, dp);
      probs_fused<D>(s, dp, pks, bias, b, h, q0, k0, TQ, TK, mx, il, scale, drop, sd, thr,
                     inv_keep, wr, wc, lg, lq);
    } else {
      with_draws<D>(drop, [&](auto draw) {
        constexpr bool kDraw = decltype(draw)::value;
        // the lane's Philox row, recomputed for each query tile
        const dropout::Row dr =
            kDraw ? keep_lane(sd, b, h, q0 + 16 * wr + lg, lq) : dropout::Row{};
        score_tile<D, kDraw>(qs, gs, ks, vs, s, dp, pks, bias, b, h, q0, k0, TQ, TK, mx, il,
                             scale, serial_drop, sd, thr, dr, inv_keep, wr, wc, lg, lq);
      });
    }
    if (kFused) {
      // delta = sum_j p * dp * kf: the four lanes of a row, then the WC warps
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < T::NT; ++n)
          part += s[n][2 * i] * dp[n][2 * i] + s[n][2 * i + 1] * dp[n][2 * i + 1];
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (lq == 0) red[wc * BT + 16 * wr + lg + 8 * i] = part;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < T::WC; ++c) dl[i] += red[c * BT + 16 * wr + lg + 8 * i];
    }
    grads<D>(s, dp, dss, dl, scale, wr, wc, lg, lq);
    __syncthreads();
    if (kFused) {
      float acc[T::NO][4];
      zero<T::NO>(acc);
      product<BT, T::NO, T::WC, D / 8, false>(acc, dss, T::LDS, 16 * wr, ks, T::LDD, wc, lg,
                                              lq);
      store_frags<D, T::NO, T::WC>(dq + base_q * D, acc, q0 + 16 * wr, TQ, wc, lg, lq);
    }
    product<BT, T::NO, T::WC, D / 8, true>(dka, dss, T::LDS, 16 * wr, qs, T::LDD, wc, lg, lq);
    product<BT, T::NO, T::WC, D / 8, true>(dva, pks, T::LDS, 16 * wr, gs, T::LDD, wc, lg, lq);
    __syncthreads();
  }
  // kFused: dk, dv are part[0], part[1]; this block's rows are group `tile`'s
  const size_t out = kFused ? ((size_t)tile * B * H + bh) * TK : base_k;
  store_frags<D, T::NO, T::WC>(dk + out * D, dka, k0 + 16 * wr, TK, wc, lg, lq);
  store_frags<D, T::NO, T::WC>(dv + out * D, dva, k0 + 16 * wr, TK, wc, lg, lq);
}

// dk = sum_gr part[0][gr], dv = sum_gr part[1][gr], gr = 0..G-1 in order.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dk,
              float4* __restrict__ dv, long long n4, int G) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * kThreads) {
    const bool is_v = i >= n4;
    const long long j = is_v ? i - n4 : i;
    const float4* src = part + (is_v ? (long long)G * n4 : 0) + j;
    float4 sum = src[0];
    for (int gr = 1; gr < G; ++gr) {
      const float4 x = src[(long long)gr * n4];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    (is_v ? dv : dk)[j] = sum;
  }
}

constexpr int kSMs = 132;  // an H100 SXM's SMs
// the fused B6 grid aims at this many blocks an SM (tools/sweep_attention_bwd.py
// builds the source with other values)
#ifndef ATTN_BWD_BLOCKS_PER_SM
#define ATTN_BWD_BLOCKS_PER_SM 2
#endif
constexpr int kBlocksPerSM = ATTN_BWD_BLOCKS_PER_SM;

// Query-tile groups of the fused B6 backward: 0 (two passes) when the keys do
// not fit one resident tile, else enough groups for kBlocksPerSM * kSMs
// blocks, at most one per query tile. A function of the shape alone, so one
// seed gives the same gradients bit for bit.
template <int D>
inline int fused_groups(int B, int H, int TQ, int TK) {
  constexpr int BT = Tiles<D>::BT;
  if (TK > BT) return 0;
  const long long heads = (long long)B * H;
  const int nq = (TQ + BT - 1) / BT;
  const long long want = (kBlocksPerSM * kSMs + heads - 1) / heads;
  return (int)(want < nq ? (want < 1 ? 1 : want) : nq);
}

// The backward on `stream`; returns the cudaError_t code. groups = 0: the
// delta pass, the dQ pass and the dK/dV pass (delta a [B, H, TQ] scratch);
// groups = fused_groups(...) > 0: the fused pass and the reduction (part a
// [2, groups, B, H, TK, D] scratch).
template <int D, class Bias>
int launch_bwd(const float* q, const float* k, const float* v, const float* g,
               const float* out, const float* stats, const long long* seed, float* delta,
               float* part, int groups, float* dq, float* dk, float* dv, Bias bias, int B,
               int H, int TQ, int TK, float scale, float rate, cudaStream_t stream) {
  using T = Tiles<D>;
  constexpr int BT = T::BT;
  constexpr size_t dq_smem = T::kDqSmem;
  const long long heads = (long long)B * H;
  const long long nq = (TQ + BT - 1) / BT, nk = (TK + BT - 1) / BT;
  if (groups != (Bias::kCausal ? 0 : fused_groups<D>(B, H, TQ, TK)) ||
      (groups > 0 && part == nullptr) || nq * heads > 2147483647LL ||
      nk * heads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // 16-byte cp.async: rows are D floats, D a multiple of 8, so the bases decide
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  static bool raised_dq[kMaxDevices] = {}, raised_dkv[kMaxDevices] = {},
              raised_fused[kMaxDevices] = {};
  const uint32_t thr = dropout::threshold(rate);
  int err;
  if (groups > 0) {
    err = raise_smem(dkv_kernel<D, Bias, true>, T::kSmem, raised_fused);
    if (err != 0) return err;
    const size_t half = (size_t)groups * B * H * TK * D;
    dkv_kernel<D, Bias, true><<<(unsigned)(groups * heads), kThreads, T::kSmem, stream>>>(
        q, k, v, g, stats, nullptr, bias, seed, rate, thr, dq, part, part + half, B, H, TQ,
        TK, groups, scale);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const long long n4 = heads * TK * D / 4;
    const long long blocks = (2 * n4 + kThreads - 1) / kThreads;
    reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(dk),
        reinterpret_cast<float4*>(dv), n4, groups);
    return (int)cudaGetLastError();
  }
  err = raise_smem(dq_kernel<D, Bias>, dq_smem, raised_dq);
  if (err != 0) return err;
  err = raise_smem(dkv_kernel<D, Bias, false>, T::kSmem, raised_dkv);
  if (err != 0) return err;
  err = launch_rowdot(g, out, delta, heads * TQ, D, stream);
  if (err != 0) return err;
  dq_kernel<D, Bias><<<(unsigned)(nq * heads), kThreads, dq_smem, stream>>>(
      q, k, v, g, stats, delta, bias, seed, rate, thr, dq, B, H, TQ, TK, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<D, Bias, false><<<(unsigned)(nk * heads), kThreads, T::kSmem, stream>>>(
      q, k, v, g, stats, delta, bias, seed, rate, thr, nullptr, dk, dv, B, H, TQ, TK, 0,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd
