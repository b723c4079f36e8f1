// The backward of softmax(q Kᵀ·scale + additive bias)·V with dropout for bf16
// q, K and V, for Hopper (sm_90a): the bf16 forms of B4 and B6, the body shared
// by masked_attention_bwd_bf16.cu (causal, key bias) and
// bias_attention_bwd_bf16.cu (an arbitrary [B, TQ, TK] bias).
//
// Replaces `_causal_bwd_kernel` / `_masked_bwd` and `_bias_bwd_kernel` /
// `_bias_bwd_rule` of streamspeech_tpu/ops/pallas_attention.py as a bf16 train
// step meets them (`measure_train_step(bf16=True)`): bf16 q, K and V, an fp32 g
// (`:515`, `:720`), every product in fp32 on the widened operands (`jnp.dot`
// of fp32 and bf16 promotes to fp32), the probabilities recomputed in fp32 and
// not rounded, dq, dK and dV cast to bf16 at the end (`:538`, `:745`):
//   s = q Kᵀ,  p = 2^((s scale + bias) log2(e) - max) / sum   (the forward's
//   statistics, attention_bf16.cuh's training form),
//   dp = (g Vᵀ) kf,  delta = Σ_j p dp,  ds = p (dp - delta) scale,
//   dq = ds K,  dK = dsᵀ q,  dV = (p kf)ᵀ g.
//
// Products: `mma.sync.m16n8k16` with bf16 operands and fp32 accumulators
// (attention_bf16.cuh's helpers). q, K and V are exact in bf16; an fp32
// operand x (g, ds, p kf) is split into hi = bf16(x) and lo = bf16(x - hi),
// 2^-16 of x apart from x, and enters as two products (three for dV, both of
// whose operands are fp32: hi hi + hi lo + lo hi): s 1, dp 2, dq 2, dK 2,
// dV 3 products, 10 against the fp32 form's 15 TF32 ones. A split product's
// k-step goes into a zeroed accumulator, small terms first, and is added to
// the running fp32 sum (add4). The outputs round
// to bf16 (2^-8), so the kernel sits within about one bf16 ulp of its plain
// version; rounding g, p or ds to bf16 whole would err by ~2^-9 before that.
//
// delta: the fp32 kernels take delta = rowsum(g out). Here out came from
// probabilities rounded to bf16, which would put delta off Σ p dp by up to
// 2^-8 Σ p |g v| and that error into every element of ds. So the dQ pass
// forms delta from the fp32 p and dp: where the keys span more than one tile
// it sweeps them twice (delta first, then ds and dq: three products more a
// key tile), where they fit one tile (B6's 48 keys) once. It writes delta to
// a [B, H, TQ] scratch for the dK/dV pass.
//
// Layout: 4 warps, each on 16 rows of a 64-row block. The dQ pass: a block per
// (query tile, b h, 64-channel chunk of dq), key tiles of 64 (32 above D16 =
// 128) through a two-stage cp.async ring, rows as attention_bf16.cuh's forward:
// s, dp and ds stay in registers and ds's accumulator is, split, the A operand
// of ds K. The dK/dV pass works on the transpose: a block per (key tile of 64,
// b h, query-tile group, chunk), each warp on 16 keys; sᵀ = K qᵀ and dpᵀ =
// V gᵀ, so that dsᵀ and (p kf)ᵀ are in registers as the A operands of dK =
// dsᵀ q and dV = (p kf)ᵀ g. Its keep bits: a warp's 16 keys by an 8-query slab
// are 32 Philox draws of 4 keys, one a lane, and each lane takes its four
// bits by four shuffles. Query tiles of 64 (32 above D16 = 128) stream through
// the ring with their statistics and delta. The causal form launches the
// longest walks first and skips tiles above the diagonal.
// Query-tile groups (G): where the key tiles give fewer than 2 blocks an SM
// (B6: one key tile), block (key tile, group) takes query tiles group, group
// + G, ... and writes fp32 partials [2, G, B, H, TK, D], which a third kernel
// adds in group order and rounds. No atomics: one seed gives the same
// gradients bit for bit. Wide head dims recompute s and dp for each 64-channel
// chunk of the outputs (registers).
//
// Shapes: D every multiple of 8 from 8 to 256 (D % 16 == 8: the k-steps over D
// zero-pad to D16 as the forward does); causal T a multiple of 64, TQ = TK;
// bias any TQ, TK. `wgmma` and fewer products are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"

namespace attn_bwd_bf16 {

using bf16attn::kLog2e;
using bf16attn::kNegInf;
using bf16attn::kThreads;
using bf16attn::ldsm_x2_trans;
using bf16attn::ldsm_x4;
using bf16attn::ldsm_x4_trans;
using bf16attn::load_rows;
using bf16attn::mma_bf16;
using bf16attn::pack_bf16;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_commit;
using tc::cp_wait;
using tc::kMaxDevices;
using tc::kMaxSmem;

constexpr int kRows = 64;     // a block's own rows: queries (dQ), keys (dK/dV)
constexpr int kChunk = 64;    // channels of dq, dK, dV a block writes
constexpr int kSMs = 132;     // an H100 SXM's SMs
constexpr int kBlocksPerSM = 2;

template <int D>
struct Tiles {
  static constexpr int D16 = bf16attn::Tiles<D>::D16;
  static constexpr int LD = bf16attn::Tiles<D>::LD;  // bf16 a shared row
  static constexpr int LDG = D16 + 8;                 // fp32 a shared row of g
  static constexpr int KS = D16 / 16;                 // k-steps over D
  static constexpr int BS = D16 <= 128 ? 64 : 32;     // rows of a streamed tile
  static constexpr int NS = BS / 8;                   // its 8-row slabs
  static constexpr int CHUNKS = (D + kChunk - 1) / kChunk;
  static constexpr size_t kQBytes = (size_t)kRows * LD * 2;    // a bf16 [64][LD] tile
  static constexpr size_t kGBytes = (size_t)kRows * LDG * 4;   // an fp32 [64][LDG] tile
  // dQ: q, g, two stages of K and V
  static constexpr size_t kDqSmem = kQBytes + kGBytes + (size_t)2 * 2 * BS * LD * 2;
  // dK/dV: K, V, two stages of (q, g, 2 statistics and delta a row)
  static constexpr size_t kStage = (size_t)BS * LD * 2 + (size_t)BS * LDG * 4 + BS * 3 * 4;
  static constexpr size_t kDkvSmem = 2 * kQBytes + 2 * kStage;
  static_assert(kDqSmem <= kMaxSmem && kDkvSmem <= kMaxSmem, "tiles do not fit");
};

// Rows [r0, r0 + rows) of a [n, D] fp32 matrix into a [rows][LDG] tile, 4
// floats a copy; rows outside [0, n) and columns D..D16 zero-filled.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* tile, const float* src, int r0, int rows,
                                              int n, int tid) {
  constexpr int CH = Tiles<D>::D16 / 4, LDG = Tiles<D>::LDG;
  for (int i = tid; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < n && c < D / 4;
    cp_async16(tile + r * LDG + 4 * c, in ? src + (size_t)(r0 + r) * D + 4 * c : src, in);
  }
}

// acc += c by fp32 adds. A split product's two or three `mma.sync` go into a
// zeroed accumulator, the small terms first, and the running sum takes them
// here: carrying the running sum through the tensor core's own accumulation,
// which does not round as an fp32 add does, lost the lo products' bits (delta
// 3.4e-4 off Σ p |dp| on the card, where 2^-18 of the terms was the split's
// own error), as tc_mma.cuh's mma3 found for 3xTF32.
__device__ __forceinline__ void add4(float acc[4], const float c[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// x = hi + lo in bf16 pairs (lo in the low half, as pack_bf16)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The A fragment of a 16-key (16-query) k-step from two 8-column accumulator
// tiles c0, c1 of the same 16 rows, split.
__device__ __forceinline__ void split_a(const float c0[4], const float c1[4], uint32_t hi[4],
                                        uint32_t lo[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// The causal mask from the indices plus the key bias kvb [B, T]; the
// forward's expression (attention_bf16.cuh), so the recomputed logit is its.
struct CausalBias {
  static constexpr bool kCausal = true;
  const float* kvb;
  int T;
  __device__ __forceinline__ float logit(float s, float scale, int b, int row, int col) const {
    float x = s * scale + kvb[(size_t)b * T + col];
    if (col > row) x += kNegInf;
    return x;
  }
};

// An arbitrary additive bias [B, TQ, TK] that carries the whole mask.
struct FullBias {
  static constexpr bool kCausal = false;
  const float* bias;
  int TQ, TK;
  __device__ __forceinline__ float logit(float s, float scale, int b, int row, int col) const {
    return s * scale + bias[((size_t)b * TQ + row) * TK + col];
  }
};

// p = 2^(x log2(e) - max) / sum from the forward's statistics. The product
// x log2(e) is rounded first, as the forward rounds it before taking the max
// (`__fmul_rn` is never contracted into an FMA): a wholly masked row's logits
// sit near -1e9, where an unrounded product would put p off by 2^(±64).
__device__ __forceinline__ float prob(float x, float mx, float il) {
  return exp2f(__fmul_rn(x, kLog2e) - mx) * il;
}

// s = q Kᵀ (1 product) and dp = g Vᵀ (2: g split) over the warp's 16 rows
// (A: q at qs, g at gs, rows rw..) and the tile's 8-row slabs of K, V (B, by
// rows at ks, vs), nt of them (even). Also the dK/dV pass's sᵀ = K qᵀ and
// dpᵀ = V gᵀ, with A = K, V and B = q, g: kGB says g is the B side.
template <int D, int NT, bool kGB>
__device__ __forceinline__ void score_products(const __nv_bfloat16* as, const __nv_bfloat16* bs,
                                               const __nv_bfloat16* vs, const float* gs,
                                               int rw, int nt, int lane, float s[][4],
                                               float dp[][4]) {
  using T = Tiles<D>;
  constexpr int LD = T::LD, LDG = T::LDG;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, lq = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < T::KS; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, as + (rw + a_row) * LD + 16 * kk + a_col);
    uint32_t ah[4], al[4];   // dQ: g's rows split; dK/dV: V's rows
    if constexpr (kGB) {
      ldsm_x4(ah, vs + (rw + a_row) * LD + 16 * kk + a_col);
    } else {
      const float* gr = gs + (rw + g) * LDG + 16 * kk + 2 * lq;
      const float2 x0 = *reinterpret_cast<const float2*>(gr);
      const float2 x1 = *reinterpret_cast<const float2*>(gr + 8 * LDG);
      const float2 x2 = *reinterpret_cast<const float2*>(gr + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(gr + 8 * LDG + 8);
      split2(x0.x, x0.y, ah[0], al[0]);
      split2(x1.x, x1.y, ah[1], al[1]);
      split2(x2.x, x2.y, ah[2], al[2]);
      split2(x3.x, x3.y, ah[3], al[3]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np >= nt) break;
      uint32_t kb[4];
      ldsm_x4(kb, bs + (16 * np + k_row) * LD + 16 * kk + k_col);
      mma_bf16(s[2 * np], a, kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], a, kb[2], kb[3]);
      if constexpr (kGB) {
        // B = gᵀ: column (query) 16 np + 8 t + g, rows (channels) 16 kk + 2 lq ..
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float* gr = gs + (16 * np + 8 * t + g) * LDG + 16 * kk + 2 * lq;
          const float2 x0 = *reinterpret_cast<const float2*>(gr);
          const float2 x1 = *reinterpret_cast<const float2*>(gr + 8);
          uint32_t bh0, bl0, bh1, bl1;
          split2(x0.x, x0.y, bh0, bl0);
          split2(x1.x, x1.y, bh1, bl1);
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c, ah, bl0, bl1);
          mma_bf16(c, ah, bh0, bh1);
          add4(dp[2 * np + t], c);
        }
      } else {
        uint32_t vb[4];
        ldsm_x4(vb, vs + (16 * np + k_row) * LD + 16 * kk + k_col);
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(c0, al, vb[0], vb[1]);
        mma_bf16(c0, ah, vb[0], vb[1]);
        mma_bf16(c1, al, vb[2], vb[3]);
        mma_bf16(c1, ah, vb[2], vb[3]);
        add4(dp[2 * np], c0);
        add4(dp[2 * np + 1], c1);
      }
    }
  }
}

// acc[j] += A B for the warp's 16 rows over a 16-deep k-step: A split (hi, lo),
// B a bf16 tile stored by its k rows ([k][n] at bt, row stride LD), the
// chunk's 8-channel slabs c0 + 8 j, nj of them: 2 products a slab.
template <int D>
__device__ __forceinline__ void product_bf16_b(float acc[][4], const uint32_t ah[4],
                                               const uint32_t al[4], const __nv_bfloat16* bt,
                                               int c0, int nj, int lane) {
  constexpr int LD = Tiles<D>::LD;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const __nv_bfloat16* br = bt + a_row * LD + c0;
#pragma unroll
  for (int jp = 0; jp < kChunk / 16; ++jp) {
    if (2 * jp + 1 < nj) {
      uint32_t b[4];
      ldsm_x4_trans(b, br + 16 * jp + a_col);
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c0, al, b[0], b[1]);
      mma_bf16(c0, ah, b[0], b[1]);
      mma_bf16(c1, al, b[2], b[3]);
      mma_bf16(c1, ah, b[2], b[3]);
      add4(acc[2 * jp], c0);
      add4(acc[2 * jp + 1], c1);
    } else if (2 * jp < nj) {  // an odd last slab
      uint32_t b[2];
      ldsm_x2_trans(b, br + 16 * jp);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c, al, b[0], b[1]);
      mma_bf16(c, ah, b[0], b[1]);
      add4(acc[2 * jp], c);
    }
  }
}

// The same with B an fp32 tile (g, [k][n] at gt, row stride LDG), split: 3
// products a slab (hi hi, hi lo, lo hi).
template <int D>
__device__ __forceinline__ void product_f32_b(float acc[][4], const uint32_t ah[4],
                                              const uint32_t al[4], const float* gt, int c0,
                                              int nj, int lane) {
  constexpr int LDG = Tiles<D>::LDG;
  const int g = lane >> 2, lq = lane & 3;
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
    if (j >= nj) break;
    const float* col = gt + c0 + 8 * j + g;
    uint32_t bh0, bl0, bh1, bl1;
    split2(col[(2 * lq) * LDG], col[(2 * lq + 1) * LDG], bh0, bl0);
    split2(col[(2 * lq + 8) * LDG], col[(2 * lq + 9) * LDG], bh1, bl1);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(c, al, bh0, bh1);
    mma_bf16(c, ah, bl0, bl1);
    mma_bf16(c, ah, bh0, bh1);
    add4(acc[j], c);
  }
}

template <int N>
__device__ __forceinline__ void zero(float acc[][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The dQ pass. Block (query tile, b h) of grid.x, the last query tiles first
// (the longest walks of the causal triangle), dq chunk grid.y. Writes dq
// (bf16) and, from chunk 0, delta.
template <int D, class Bias>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const float* __restrict__ g,
          const float* __restrict__ stats, Bias bias, const long long* __restrict__ seed,
          float rate, uint32_t thr, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
          int B, int H, int TQ, int TK, float scale) {
  using T = Tiles<D>;
  constexpr int LD = T::LD, BK = T::BS, NT = T::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* gs = reinterpret_cast<float*>(smem + T::kQBytes);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + T::kQBytes + T::kGBytes);
  constexpr int STAGE = 2 * BK * LD;  // K, V of one stage, in bf16

  const int nq = (TQ + kRows - 1) / kRows;
  const int bh = blockIdx.x % (B * H);
  const int qt = Bias::kCausal ? nq - 1 - (int)(blockIdx.x / (B * H)) : (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H, chunk = blockIdx.y;
  const int c0 = chunk * kChunk, nj = min(kChunk, D - c0) / 8;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, lg = lane / 4, lq = lane % 4;
  const __nv_bfloat16* kh = k + (size_t)bh * TK * D;
  const __nv_bfloat16* vh = v + (size_t)bh * TK * D;
  const int q0 = qt * kRows, rw = 16 * w, row0 = q0 + rw + lg;
  const int kend = Bias::kCausal ? min(q0 + kRows, TK) : TK;
  const int nk = (kend + BK - 1) / BK;
  const bool drop = rate > 0.f;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  const dropout::Row dr =
      drop ? tc::keep_lane((unsigned long long)*seed, b, h, row0, lq) : dropout::Row{};

  load_rows<D>(qs, q + (size_t)bh * TQ * D, q0, kRows, TQ, tid);
  load_rows_f32<D>(gs, g + (size_t)bh * TQ * D, q0, kRows, TQ, tid);
  float mx[2], il[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool in = row < TQ;
    mx[i] = in ? stats[((size_t)bh * TQ + row) * 2] : 0.f;
    il[i] = in ? stats[((size_t)bh * TQ + row) * 2 + 1] : 0.f;
  }

  // One sweep where the keys fit a tile (delta from the same tile), else two:
  // delta, then ds and dq.
  float dl[2] = {0.f, 0.f}, acc[kChunk / 8][4], s[NT][4], dp[NT][4];
  zero<kChunk / 8>(acc);
  const int sweeps = nk > 1 ? 2 : 1;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    const bool last = sweep == sweeps - 1;
    load_rows<D>(ring, kh, 0, BK, TK, tid);
    load_rows<D>(ring + BK * LD, vh, 0, BK, TK, tid);
    cp_commit();
    float part[2] = {0.f, 0.f};
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * BK;
      const __nv_bfloat16* ks = ring + (kt & 1) * STAGE;
      const __nv_bfloat16* vs = ks + BK * LD;
      if (kt + 1 < nk) {
        load_rows<D>(ring + ((kt + 1) & 1) * STAGE, kh, k0 + BK, BK, TK, tid);
        load_rows<D>(ring + ((kt + 1) & 1) * STAGE + BK * LD, vh, k0 + BK, BK, TK, tid);
      }
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const int nt = min(BK, (kend - k0 + 15) / 16 * 16) / 8;  // even
      score_products<D, NT, false>(qs, ks, vs, gs, rw, nt, lane, s, dp);
      // p from the forward's statistics, dp times the keep factors
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt) break;
        const uint32_t kb = drop ? tc::keep_slab(dr, k0 + 8 * n, lq, thr) : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 8 * (e >> 1), c = k0 + 8 * n + 2 * lq + (e & 1);
          float p = 0.f;
          if (r < TQ && c < TK) p = prob(bias.logit(s[n][e], scale, b, r, c), mx[e >> 1], il[e >> 1]);
          s[n][e] = p;
          if (drop) dp[n][e] = tc::keep_apply(kb, e, dp[n][e], inv_keep);
          part[e >> 1] += p * dp[n][e];
        }
      }
      if (last) {
        if (sweeps == 1) {  // all keys in this tile: delta now
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
            part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
            dl[i] = part[i];
          }
        }
        // ds = p (dp kf - delta) scale, then dq += ds K (ds split: A)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;
#pragma unroll
        for (int kp = 0; kp < NT / 2; ++kp) {
          if (2 * kp >= nt) break;
          uint32_t ah[4], al[4];
          split_a(s[2 * kp], s[2 * kp + 1], ah, al);
          product_bf16_b<D>(acc, ah, al, ks + 16 * kp * LD, c0, nj, lane);
        }
      }
      __syncthreads();  // this stage is refilled two tiles on
    }
    if (!last) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
        dl[i] = part[i];
      }
    }
  }
  __nv_bfloat16* dqh = dq + (size_t)bh * TQ * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= TQ) continue;
    if (chunk == 0 && lq == 0) delta[(size_t)bh * TQ + row] = dl[i];
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j)
      if (j < nj)
        *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)row * D + c0 + 8 * j + 2 * lq) =
            __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// Query rows [r0, r0 + BS) of the statistics [n, 2] and delta [n] into st
// [BS][2] and st + 2 BS [BS]; zeros past row n.
template <int BS>
__device__ __forceinline__ void load_row_numbers(float* st, const float* stats,
                                                 const float* delta, int r0, int n, int tid) {
  for (int i = tid; i < 3 * BS; i += kThreads) {
    const bool is_stat = i < 2 * BS;
    const int r = is_stat ? i / 2 : i - 2 * BS;
    const bool in = r0 + r < n;
    const float* src = is_stat ? stats + (size_t)(r0 + r) * 2 + (i & 1) : delta + r0 + r;
    cp_async4(st + i, in ? src : stats, in);
  }
}

// The dK/dV pass. Block (key tile, b h) of grid.x (the first key tiles, the
// longest causal walks, first), query-tile group grid.y of G, chunk grid.z.
// G == 1: dK, dV in bf16; else fp32 partials to part[0|1][group].
template <int D, class Bias>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const float* __restrict__ g,
           const float* __restrict__ stats, const float* __restrict__ delta, Bias bias,
           const long long* __restrict__ seed, float rate, uint32_t thr,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           float* __restrict__ part, int B, int H, int TQ, int TK, int G, float scale) {
  using T = Tiles<D>;
  constexpr int LD = T::LD, LDG = T::LDG, BQ = T::BS, NT = T::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kRows * LD;
  unsigned char* ring = smem + 2 * T::kQBytes;  // [2][q bf16, g fp32, row numbers]

  const int bh = blockIdx.x % (B * H), kt = (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H, group = blockIdx.y, chunk = blockIdx.z;
  const int c0 = chunk * kChunk, nj = min(kChunk, D - c0) / 8;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, lg = lane / 4, lq = lane % 4;
  const int k0 = kt * kRows, kr0 = k0 + 16 * w;  // this warp's keys kr0 .. + 16
  const int nq = (TQ + BQ - 1) / BQ;
  const int first = (Bias::kCausal ? k0 / BQ : 0) + group;  // causal: from the diagonal
  const __nv_bfloat16* qh = q + (size_t)bh * TQ * D;
  const float* gh = g + (size_t)bh * TQ * D;
  const float* sth = stats + (size_t)bh * TQ * 2;
  const float* dlh = delta + (size_t)bh * TQ;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  auto stage = [&](int st, int qt) {
    unsigned char* base = ring + st * T::kStage;
    __nv_bfloat16* qd = reinterpret_cast<__nv_bfloat16*>(base);
    float* gd = reinterpret_cast<float*>(base + (size_t)BQ * LD * 2);
    load_rows<D>(qd, qh, qt * BQ, BQ, TQ, tid);
    load_rows_f32<D>(gd, gh, qt * BQ, BQ, TQ, tid);
    load_row_numbers<BQ>(gd + BQ * LDG, sth, dlh, qt * BQ, TQ, tid);
  };

  load_rows<D>(ks, k + (size_t)bh * TK * D, k0, kRows, TK, tid);
  load_rows<D>(vs, v + (size_t)bh * TK * D, k0, kRows, TK, tid);
  if (first < nq) stage(0, first);
  cp_commit();

  float dka[kChunk / 8][4], dva[kChunk / 8][4], s[NT][4], dp[NT][4];
  zero<kChunk / 8>(dka);
  zero<kChunk / 8>(dva);
  for (int qt = first, it = 0; qt < nq; qt += G, ++it) {
    const int q0 = qt * BQ;
    const unsigned char* base = ring + (it & 1) * T::kStage;
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(base);
    const float* gs = reinterpret_cast<const float*>(base + (size_t)BQ * LD * 2);
    const float* st = gs + BQ * LDG;  // [BQ][2] statistics, then [BQ] delta
    if (qt + G < nq) stage((it + 1) & 1, qt + G);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int nt = min(BQ, (TQ - q0 + 15) / 16 * 16) / 8;  // even
    score_products<D, NT, true>(ks, qs, vs, gs, 16 * w, nt, lane, s, dp);
    // pᵀ, dpᵀ kf, dsᵀ and (p kf)ᵀ: rows keys kr0 + lg (+ 8), columns queries
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) break;
      uint32_t kbits = 0u;
      if (drop) {
        // lane L draws query q0 + 8 n + L / 4, keys kr0 + 4 (L % 4) .. + 3;
        // element (key lg + 8 i, query 2 lq + j) is lane (2 lq + j) 4 + (lg + 8 i) / 4's
        const dropout::Row r = dropout::row_state(sd, b, h, q0 + 8 * n + lane / 4);
        const uint32_t own = dropout::keep4(r, (uint32_t)(kr0 / 4 + lane % 4), thr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = lg + 8 * (e >> 1), qry = 2 * lq + (e & 1);
          const uint32_t got = __shfl_sync(0xffffffffu, own, qry * 4 + key / 4);
          kbits |= ((got >> (key % 4)) & 1u) << e;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kr0 + lg + 8 * (e >> 1), ql = 8 * n + 2 * lq + (e & 1);
        const int qry = q0 + ql;
        float p = 0.f;
        if (qry < TQ && key < TK)
          p = prob(bias.logit(s[n][e], scale, b, qry, key), st[2 * ql], st[2 * ql + 1]);
        const float kf = drop ? ((kbits >> e) & 1u ? inv_keep : 0.f) : 1.f;
        const float dpk = dp[n][e] * kf;
        s[n][e] = p * (dpk - st[2 * BQ + ql]) * scale;  // dsᵀ
        dp[n][e] = p * kf;                              // (p kf)ᵀ
      }
    }
    // dK += dsᵀ q, dV += (p kf)ᵀ g, 16 queries a k-step
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {
      if (2 * kp >= nt) break;
      uint32_t ah[4], al[4];
      split_a(s[2 * kp], s[2 * kp + 1], ah, al);
      product_bf16_b<D>(dka, ah, al, qs + 16 * kp * LD, c0, nj, lane);
      split_a(dp[2 * kp], dp[2 * kp + 1], ah, al);
      product_f32_b<D>(dva, ah, al, gs + 16 * kp * LDG, c0, nj, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  const size_t rows = (size_t)B * H * TK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + lg + 8 * i;
    if (key >= TK) continue;
    const size_t at = ((size_t)bh * TK + key) * D + c0 + 2 * lq;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      if (j >= nj) break;
      if (G == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
            __floats2bfloat162_rn(dka[j][2 * i], dka[j][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(dva[j][2 * i], dva[j][2 * i + 1]);
      } else {
        float* pk = part + (size_t)group * rows * D;
        float* pv = part + ((size_t)G + group) * rows * D;
        *reinterpret_cast<float2*>(pk + at + 8 * j) = make_float2(dka[j][2 * i], dka[j][2 * i + 1]);
        *reinterpret_cast<float2*>(pv + at + 8 * j) = make_float2(dva[j][2 * i], dva[j][2 * i + 1]);
      }
    }
  }
}

// dk = Σ_gr part[0][gr], dv = Σ_gr part[1][gr], gr = 0..G-1 in order, rounded
// to bf16; two elements a thread a step.
__global__ void __launch_bounds__(256)
reduce_kernel(const float2* __restrict__ part, __nv_bfloat162* __restrict__ dk,
              __nv_bfloat162* __restrict__ dv, long long n2, int G) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < 2 * n2;
       i += (long long)gridDim.x * 256) {
    const bool is_v = i >= n2;
    const long long j = is_v ? i - n2 : i;
    const float2* src = part + (is_v ? (long long)G * n2 : 0) + j;
    float2 sum = src[0];
    for (int gr = 1; gr < G; ++gr) {
      const float2 x = src[(long long)gr * n2];
      sum.x += x.x;
      sum.y += x.y;
    }
    (is_v ? dv : dk)[j] = __floats2bfloat162_rn(sum.x, sum.y);
  }
}

// Query-tile groups of the dK/dV pass: 1 where the key tiles give at least
// kBlocksPerSM blocks an SM, else enough for that many, at most one a query
// tile. A function of the shape alone.
template <int D>
inline int groups(int B, int H, int TQ, int TK) {
  const long long blocks = (long long)((TK + kRows - 1) / kRows) * B * H;
  const long long want = kBlocksPerSM * kSMs;
  if (blocks >= want) return 1;
  const long long nq = (TQ + Tiles<D>::BS - 1) / Tiles<D>::BS;
  const long long g = (want + blocks - 1) / blocks;
  return (int)(g < nq ? g : nq);
}

// The backward on `stream`: the dQ pass (writes delta), the dK/dV pass and,
// for G > 1, the reduction. Returns the cudaError_t code.
template <int D, class Bias>
int launch_bwd(const void* q, const void* k, const void* v, const float* g,
               const float* stats, const long long* seed, float* delta, float* part, int G,
               void* dq, void* dk, void* dv, Bias bias, int B, int H, int TQ, int TK,
               float scale, float rate, cudaStream_t stream) {
  using T = Tiles<D>;
  const long long heads = (long long)B * H;
  const long long nq = (TQ + kRows - 1) / kRows, nk = (TK + kRows - 1) / kRows;
  if (G != groups<D>(B, H, TQ, TK) || (G > 1 && part == nullptr) ||
      nq * heads > 2147483647LL || nk * heads > 2147483647LL || rate < 0.f || rate >= 1.f ||
      (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  // 16-byte cp.async and 4-byte bf16 pair stores: rows are D elements, D a
  // multiple of 8, so the bases decide
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g | (uintptr_t)dq |
       (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)part) % 16 != 0 ||
      ((uintptr_t)stats | (uintptr_t)delta) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  static bool raised_dq[kMaxDevices] = {}, raised_dkv[kMaxDevices] = {};
  int err = tc::raise_smem(dq_kernel<D, Bias>, T::kDqSmem, raised_dq);
  if (err != 0) return err;
  err = tc::raise_smem(dkv_kernel<D, Bias>, T::kDkvSmem, raised_dkv);
  if (err != 0) return err;
  const uint32_t thr = dropout::threshold(rate);
  using bf = __nv_bfloat16;
  dq_kernel<D, Bias><<<dim3((unsigned)(nq * heads), T::CHUNKS), kThreads, T::kDqSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), g,
      stats, bias, seed, rate, thr, delta, static_cast<bf*>(dq), B, H, TQ, TK, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<D, Bias>
      <<<dim3((unsigned)(nk * heads), G, T::CHUNKS), kThreads, T::kDkvSmem, stream>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), g,
          stats, delta, bias, seed, rate, thr, static_cast<bf*>(dk), static_cast<bf*>(dv),
          part, B, H, TQ, TK, G, scale);
  err = (int)cudaGetLastError();
  if (err != 0 || G == 1) return err;
  const long long n2 = heads * TK * D / 2;
  const long long blocks = (2 * n2 + 255) / 256;
  reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      reinterpret_cast<const float2*>(part), static_cast<__nv_bfloat162*>(dk),
      static_cast<__nv_bfloat162*>(dv), n2, G);
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd_bf16
