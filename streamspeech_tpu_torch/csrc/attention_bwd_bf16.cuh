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
// What bounds it: operations (B4-bf16 at [8,8,1280,64]: its five products at
// 989 TFLOP/s, 0.034 ms) and, for B6 at the unit decoder's 128 keys, bytes
// (0.015 ms). The split products make 16 bf16 product units a (query tile,
// key tile) pair in B4, 10 in B6; they run at ~35-40 % of the bf16 peak, and
// the softmax's elementwise work and the dropout draws beside them take the
// rest (PERF.md §6: 0.41 and 0.091 ms at rate 0.1 on an H100 80GB HBM3).
// Products: `wgmma.mma_async` m64nNk16 in bf16 with fp32 accumulators, a
// warpgroup (4 warps) on 64 rows. q, K, V (and g's bf16 parts in the dK/dV
// pass) come into shared memory by TMA (`cp.async.bulk.tensor`, 3-D tensor
// maps [B H, T, D] made on the host, 64-column boxes with the 128-byte
// swizzle, zero-filled past D and T; wgmma.cuh, shared with the forwards)
// onto an mbarrier ring of two stages. The
// same swizzled tile is the K-major operand of one product and the MN-major
// operand of another (bf16 wgmma reads B, and A from shared memory, either
// way): q is A of s and B of dK, K is B of s and of dq, g's parts are A of dp
// and B of dV. Operands formed in the kernel (ds, p kf, split) are A from
// registers: an accumulator of 64 rows is, packed, the A fragment of the next
// product over its columns.
//
// Precision. q, K and V are exact in bf16; an fp32 operand x (g, ds, p kf)
// is split into hi = bf16(x) and lo = bf16(x - hi), 2^-16 of x apart from x,
// and enters as two products (three for dV, both of whose operands are fp32:
// lo hi + hi lo + hi hi). A split product's chain of wgmma goes into a zeroed
// accumulator, the small terms first, over the whole contraction of one tile
// (D for s and dp; the tile's 64 keys for dq, its 64 queries for dK and dV),
// and the running fp32 sum over tiles takes it on the CUDA cores: the tensor
// core's own accumulation of a large running sum lost the lo terms' bits
// (an mma.sync form that did so put delta 34x over its bound on the card).
// The outputs round to bf16 (2^-8), so the kernel sits within about one bf16
// ulp of its plain version; rounding g, p or ds to bf16 whole would err by
// ~2^-9 before that.
//
// g is split once a call: the dQ pass, which first loads g, writes hi and lo
// to its shared tiles and to a [2, B, H, TQ, D] bf16 scratch that the dK/dV
// pass loads by TMA like q; B6's one kernel splits each query tile's g once.
//
// delta: out came from probabilities rounded to bf16, so rowsum(g out) would
// put delta off Σ p dp by up to 2^-8 Σ p |g v| and that error into every
// element of ds. delta is formed from the fp32 p and dp instead.
//
// Dropout: the keep bits of a tile (dropout.cuh, `dropout_keep_reference` bit
// for bit) are drawn into shared memory as 32-key words, a word a thread (8
// draws of 4 keys), while the tensor cores run the tile's score products; each
// thread reads its elements' bits from there. A row's Philox state is formed
// once a block (dQ pass: the block's own rows) or once a query tile (B6's one
// kernel). Each element is drawn once a call (up to kWordCache key tiles): the
// dQ pass keeps a key tile's words in shared memory for its second sweep and
// writes them to a [B, H, TQ, TK / 32] scratch (1 bit an element, 1/32 of the
// fp32 probabilities), which the dK/dV pass loads a tile ahead instead of
// drawing again.
//
// Forms:
//  - two passes (B4; B6 where TK > 128 or D > 64). dQ pass: a block per
//    (query tile, b h, 64-channel chunk of dq), key tiles of 64 through the
//    ring; s = q Kᵀ and dp = g Vᵀ in registers; where the keys span more than
//    one tile it sweeps them twice (delta first, forming s and dp only; then
//    ds and dq += ds K), else once; it writes delta ([B, H, TQ]) for the
//    dK/dV pass. dK/dV pass: a block per (key tile of 64, b h, chunk) walking
//    the query tiles: sᵀ = K qᵀ and dpᵀ = V gᵀ, so that dsᵀ and (p kf)ᵀ are in
//    registers as the A operands of dK += dsᵀ q and dV += (p kf)ᵀ g. The causal
//    form launches the longest walks first and skips tiles above the diagonal.
//    No atomics: one seed gives the same gradients bit for bit. Wide head
//    dims recompute s and dp for each 64-channel chunk of the outputs.
//  - one kernel (B6 where TK <= 128 and D <= 64: every path's shape, the keys
//    padded to the 128 tile). A thread-block cluster of C blocks (C <= 4, as
//    many as keep one block an SM) per (b, h); block `rank` walks the query
//    tiles rank, rank + C, .. with all keys in one shared tile, two
//    warpgroups on 64 keys each: sᵀ, dpᵀ and p once a query tile; delta is
//    local to the tile (a column sum over the 8 warps, in warp order); dsᵀ
//    goes to shared memory, split, as the MN-major A of dq = ds K (m64n32, a
//    warpgroup's half of the channels), written directly; dK and dV add up
//    over the block's tiles in registers and over the cluster's blocks in
//    rank order through distributed shared memory. One launch a call.
//
// Shapes: D every multiple of 8 from 8 to 256 (the k-steps over D run to D
// rounded up to 16 on zero-filled columns); causal T a multiple of 64, TQ =
// TK; bias any TQ, TK.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "wgmma.cuh"

namespace attn_bwd_bf16 {

using bf16attn::keep_word;
using bf16attn::kLog2e;
using bf16attn::kNegInf;
using bf16attn::pack_bf16;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_commit;
using tc::cp_wait;
using tc::kMaxDevices;
using tc::kMaxSmem;
using namespace wg;  // TMA, mbarriers, wgmma, clusters, tensor maps

constexpr int kRows = 64;        // a tile's rows: a warpgroup's M
constexpr int kThreads = 128;    // a warpgroup
constexpr int kSMs = 132;        // an H100 SXM's SMs
constexpr int kMaxCluster = 4;   // B6's one kernel: blocks a (b, h)
constexpr int kFusedKeys = 128;  // B6's one kernel: every key in one tile
constexpr int kFusedMaxD = 64;
// the dQ pass's second sweep reuses the keep words of this many key tiles
// (T <= 1536), drawing again past them; with the rest of its shared memory
// three blocks fit an SM at D = 64
constexpr int kWordCache = 24;

// ---- tiles and products ----------------------------------------------------

// x = hi + lo in bf16 pairs (x0 in the low half, as pack_bf16)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The A fragments, split, of a product over the 64 columns of an m64n64
// accumulator x (element (row, col) of slab n = col / 8 at x[4 n + ..]).
__device__ __forceinline__ void split_frags(const float* x, uint32_t hi[4][4], uint32_t lo[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) split2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

// g's rows q0 .. q0 + 63 of one (b, h) ([T, D] fp32 at src, rows past T and
// columns past D zero) split into the swizzled bf16 tiles hi, lo of 64 DP
// columns; with `out`, also to the scratch rows (hi at out, lo at out + half).
template <int D, int NT>
__device__ __forceinline__ void split_g(unsigned char* hi, unsigned char* lo, const float* src,
                                        int q0, int T, int tid, __nv_bfloat16* out, size_t half) {
  constexpr int C4 = 16 * panels(D);  // 4-column groups of a row
  for (int i = tid; i < kRows * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool in = q0 + r < T && c < D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) x = *reinterpret_cast<const float4*>(src + (size_t)(q0 + r) * D + c);
    uint2 h, l;
    split2(x.x, x.y, h.x, l.x);
    split2(x.z, x.w, h.y, l.y);
    const uint32_t off = swz(r, c, kRows);
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(lo + off) = l;
    if (out != nullptr && in) {
      *reinterpret_cast<uint2*>(out + (size_t)(q0 + r) * D + c) = h;
      *reinterpret_cast<uint2*>(out + half + (size_t)(q0 + r) * D + c) = l;
    }
  }
}

// Keep words a query row of the two-pass form's scratch [B, H, TQ, ..]: two
// (64 keys) a key tile.
__host__ __device__ constexpr int keep_words(int TK) { return 2 * ((TK + 63) / 64); }

// p = 2^(x log2(e) - max) / sum from the forward's statistics. The product
// x log2(e) is rounded first, as the forward rounds it before taking the max
// (`__fmul_rn` is never contracted into an FMA): a wholly masked row's logits
// sit near -1e9, where an unrounded product would put p off by 2^(±64).
__device__ __forceinline__ float prob(float x, float mx, float il) {
  return ex2(__fmul_rn(x, kLog2e) - mx) * il;
}

// ---- the bias, loaded with its tile -----------------------------------------

// The causal mask from the indices plus the key bias kvb [B, T]; the
// forward's expression (attention_bf16.cuh), so the recomputed logit is its.
// Its tile: the kk keys' bias.
struct CausalBias {
  static constexpr bool kCausal = true;
  const float* kvb;
  int T;
  static constexpr int floats(int, int kk) { return kk; }
  template <int KQ, int KK, int NT>
  __device__ __forceinline__ void load(float* dst, int b, int, int k0, int tid) const {
    for (int i = tid; i < KK / 4; i += NT) {  // T % 64 == 0: whole 16-byte groups
      const bool in = k0 + 4 * i < T;
      cp_async16(dst + 4 * i, in ? kvb + (size_t)b * T + k0 + 4 * i : kvb, in);
    }
  }
  // diag: a tile that holds keys above the diagonal
  template <int KK>
  __device__ __forceinline__ float logit(float s, float scale, const float* tile, int, int kl,
                                         int qry, int key, bool diag) const {
    float x = s * scale + tile[kl];
    if (diag && key > qry) x += kNegInf;
    return x;
  }
};

// An arbitrary additive bias [B, TQ, TK] that carries the whole mask. Its
// tile: [KQ queries][KK keys + 4] (zeros outside [TQ, TK]; 16-byte copies when
// TK % 4 == 0, else 4-byte).
struct FullBias {
  static constexpr bool kCausal = false;
  const float* bias;
  int TQ, TK;
  static constexpr int floats(int kq, int kk) { return kq * (kk + 4); }
  template <int KQ, int KK, int NT>
  __device__ __forceinline__ void load(float* dst, int b, int q0, int k0, int tid) const {
    constexpr int LD = KK + 4;
    const float* src = bias + (size_t)b * TQ * TK;
    if (TK % 4 == 0) {
      for (int i = tid; i < KQ * KK / 4; i += NT) {
        const int r = i / (KK / 4), c = (i % (KK / 4)) * 4;
        const bool in = q0 + r < TQ && k0 + c < TK;
        cp_async16(dst + r * LD + c, in ? src + (size_t)(q0 + r) * TK + k0 + c : bias, in);
      }
    } else {
      for (int i = tid; i < KQ * KK; i += NT) {
        const int r = i / KK, c = i % KK;
        const bool in = q0 + r < TQ && k0 + c < TK;
        cp_async4(dst + r * LD + c, in ? src + (size_t)(q0 + r) * TK + k0 + c : bias, in);
      }
    }
  }
  template <int KK>
  __device__ __forceinline__ float logit(float s, float scale, const float* tile, int ql, int kl,
                                         int, int, bool) const {
    return s * scale + tile[ql * (KK + 4) + kl];
  }
};

// ---- two passes: the dQ pass ------------------------------------------------

// Shared memory of the dQ pass: q, g hi, g lo [64][D] bf16, then a ring of
// stages (K, V [64][D] bf16, the bias tile), the keep words of up to
// kWordCache + 1 key tiles [64][2] and the barriers (q, a stage each). Two
// stages where they fit.
template <int D, class Bias>
struct DqLayout {
  static constexpr uint32_t kTile = tile_bytes(kRows, D);
  static constexpr uint32_t kStage = 2 * kTile + round1k(Bias::floats(kRows, kRows) * 4);
  static constexpr size_t bytes(int stages) {
    return 1024 + 3 * (size_t)kTile + stages * (size_t)kStage +
           (kWordCache + 1) * kRows * 2 * 4 + 3 * 8;
  }
  static constexpr int kStages = bytes(2) <= kMaxSmem ? 2 : 1;
  static constexpr size_t kSmem = bytes(kStages);
  static_assert(kSmem <= kMaxSmem, "dQ tiles do not fit");
};

// Block (query tile, b h) of grid.x, the last query tiles first (the longest
// walks of the causal triangle), dq chunk grid.y. Writes dq (bf16), from chunk
// 0 delta, g's split parts and (rate > 0) the keep words it draws.
template <int D, class Bias>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const float* __restrict__ g,
          const float* __restrict__ stats, Bias bias, const long long* __restrict__ seed,
          float rate, uint32_t thr, float* __restrict__ delta,
          __nv_bfloat16* __restrict__ gsplit, uint32_t* __restrict__ keep,
          __nv_bfloat16* __restrict__ dq, int B, int H, int TQ, int TK, float scale) {
  using L = DqLayout<D, Bias>;
  constexpr uint32_t kTile = L::kTile, kPanel = kRows * 128;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  const uint32_t base = smem_u32(smem), qs = base, ghi = base + kTile, glo = base + 2 * kTile;
  unsigned char* ring = smem + 3 * kTile;
  // keep words [kWordCache + 1][64 rows][2]: a key tile's, kept for the second
  // sweep (the last slot for tiles past the cache)
  uint32_t* words = reinterpret_cast<uint32_t*>(ring + S * L::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(words + (kWordCache + 1) * 2 * kRows);

  const int BH = B * H, nq = (TQ + kRows - 1) / kRows;
  const int bh = blockIdx.x % BH;
  const int qt = Bias::kCausal ? nq - 1 - (int)(blockIdx.x / BH) : (int)(blockIdx.x / BH);
  const int b = bh / H, h = bh % H, chunk = blockIdx.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, lg = lane >> 2, lq = lane & 3;
  const int q0 = qt * kRows, rl0 = 16 * w + lg;  // this lane's rows q0 + rl0, + 8
  const int kend = Bias::kCausal ? min(q0 + kRows, TK) : TK;
  const int nk = (kend + kRows - 1) / kRows;
  const int total = (nk > 1 ? 2 : 1) * nk;  // tile visits: two sweeps where the keys span tiles
  const bool drop = rate > 0.f;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) bar_init(bars + i);
    bar_init_fence();
  }
  __syncthreads();
  auto load = [&](int it) {  // key tile it % nk into stage it % S
    unsigned char* dst = ring + (it % S) * L::kStage;
    const int k0 = (it % nk) * kRows;
    uint64_t* bar = bars + 1 + it % S;
    if (tid == 0) {
      bar_expect(bar, 2 * kTile);
      for (int p = 0; p < panels(D); ++p) {
        tma_load(dst + p * kPanel, &kmap, 64 * p, k0, bh, bar);
        tma_load(dst + kTile + p * kPanel, &vmap, 64 * p, k0, bh, bar);
      }
    }
    bias.template load<kRows, kRows, kThreads>(reinterpret_cast<float*>(dst + 2 * kTile), b, q0,
                                               k0, tid);
  };
  if (tid == 0) {
    bar_expect(bars, kTile);
    for (int p = 0; p < panels(D); ++p) tma_load(smem + p * kPanel, &qmap, 64 * p, q0, bh, bars);
  }
  load(0);
  cp_commit();

  // g split once: the shared tiles, and (chunk 0) the scratch for the dK/dV pass
  split_g<D, kThreads>(smem + kTile, smem + 2 * kTile, g + (size_t)bh * TQ * D, q0, TQ, tid,
                       chunk == 0 ? gsplit + (size_t)bh * TQ * D : nullptr,
                       (size_t)BH * TQ * D);
  fence_async_smem();
  float mx[2], il[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl0 + 8 * i;
    const bool in = row < TQ;
    mx[i] = in ? stats[((size_t)bh * TQ + row) * 2] : 0.f;
    il[i] = in ? stats[((size_t)bh * TQ + row) * 2 + 1] : 0.f;
  }
  // this thread draws row tid / 2's keys 32 (tid % 2) .. of each tile: its
  // Philox row once a block
  const dropout::Row dr =
      drop ? dropout::row_state((unsigned long long)*seed, b, h, q0 + (tid >> 1)) : dropout::Row{};
  bar_wait(bars, 0);
  __syncthreads();

  float acc[32], dl[2] = {0.f, 0.f}, part[2] = {0.f, 0.f};
  zero(acc);
  for (int it = 0; it < total; ++it) {
    const int kt = it % nk, k0 = kt * kRows, st = it % S;
    if (S == 2) {
      if (it + 1 < total) load(it + 1);
    } else if (it > 0) {
      load(it);
    }
    cp_commit();
    bar_wait(bars + 1 + st, (uint32_t)(it / S) & 1u);
    cp_wait<S - 1>();
    __syncthreads();
    unsigned char* stage = ring + st * L::kStage;
    const uint32_t ks = smem_u32(stage), vs = ks + kTile;
    const float* bt = reinterpret_cast<const float*>(stage + 2 * kTile);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
    rows_product<D>(s, qs, kPanel, ks, kPanel, 0);
    rows_product<D>(dp, glo, kPanel, vs, kPanel, 0);  // the small terms first
    rows_product<D>(dp, ghi, kPanel, vs, kPanel, 1);
    wg_commit();
    // the first sweep draws the tile's keep words, the second reuses them
    // where the tile is cached
    uint32_t* wt = words + min(kt, kWordCache) * 2 * kRows;
    const bool draw = drop && (it < nk || kt >= kWordCache);
    if (draw) {
      const uint32_t word = keep_word(dr, k0 + 32 * (tid & 1), thr);
      wt[tid] = word;
      const int row = q0 + (tid >> 1);
      if (it < nk && chunk == 0 && row < TQ)  // for the dK/dV pass
        keep[((size_t)bh * TQ + row) * keep_words(TK) + 2 * kt + (tid & 1)] = word;
    }
    wg_wait();
    hold(s);
    hold(dp);
    if (draw) __syncthreads();
    if (kt == 0) part[0] = part[1] = 0.f;
    const bool diag = Bias::kCausal && k0 == q0;
    // p from the forward's statistics, dp times the keep factors
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = rl0 + 8 * (e >> 1), r = q0 + rl, kl = 8 * n + 2 * lq + (e & 1), c = k0 + kl;
        float p = 0.f;
        if (Bias::kCausal || (r < TQ && c < TK))  // causal: T % 64 == 0
          p = prob(bias.template logit<kRows>(s[4 * n + e], scale, bt, rl, kl, r, c, diag),
                   mx[e >> 1], il[e >> 1]);
        float d = dp[4 * n + e];
        if (drop) d = (wt[2 * rl + (kl >> 5)] >> (kl & 31)) & 1u ? d * inv_keep : 0.f;
        s[4 * n + e] = p;
        dp[4 * n + e] = d;
        part[e >> 1] += p * d;
      }
    if (it == nk - 1) {  // the first sweep's last tile: delta is complete
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
        dl[i] = part[i];
      }
    }
    if (it >= total - nk) {  // the last sweep: ds, then dq += ds K
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - dl[e >> 1]) * scale;
      uint32_t ah[4][4], al[4][4];
      split_frags(s, ah, al);
      float c[32];
      zero(c);
      const uint32_t kb = ks + chunk * kPanel;  // K's panel of this chunk's channels
      wg_fence();
      cols_product(c, al, kb, 0);
      cols_product(c, ah, kb, 1);
      wg_commit();
      wg_wait();
      hold(c);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += c[i];
    }
    __syncthreads();  // this stage and the keep words are refilled
  }
  __nv_bfloat16* dqh = dq + (size_t)bh * TQ * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl0 + 8 * i;
    if (row >= TQ) continue;
    if (chunk == 0 && lq == 0) delta[(size_t)bh * TQ + row] = dl[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = chunk * 64 + 8 * j + 2 * lq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)row * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ---- two passes: the dK/dV pass ---------------------------------------------

// Shared memory of the dK/dV pass: K, V [64][D] bf16, then a ring of stages
// (q, g hi, g lo [64][D] bf16, the bias tile, and the rows' max, 1 / sum and
// delta [64][3]), the keep words of two query tiles [2][64][2] and the
// barriers (K and V, a stage each). Two stages where they fit.
template <int D, class Bias>
struct DkvLayout {
  static constexpr uint32_t kTile = tile_bytes(kRows, D);
  static constexpr uint32_t kBias = Bias::floats(kRows, kRows) * 4;
  static constexpr uint32_t kStage = 3 * kTile + round1k(kBias + kRows * 3 * 4);
  static constexpr size_t bytes(int stages) {
    return 1024 + 2 * (size_t)kTile + stages * (size_t)kStage + 2 * kRows * 2 * 4 + 3 * 8;
  }
  static constexpr int kStages = bytes(2) <= kMaxSmem ? 2 : 1;
  static constexpr size_t kSmem = bytes(kStages);
  static_assert(kSmem <= kMaxSmem, "dK/dV tiles do not fit");
};

// Blocks of the dK/dV pass an SM that its registers are held to (168 a
// thread for 3, the chosen cut, with 68-304 bytes of spill: the pass took
// 0.139 against 0.154 ms at one, B4-bf16 at [8,8,1280,64] rate 0 on an H100,
// tools/sweep_bf16.py --bwd --variant).
#ifndef ATTN_BWD_BF16_DKV_BLOCKS
#define ATTN_BWD_BF16_DKV_BLOCKS 3
#endif

// Block (key tile, b h) of grid.x (the first key tiles, the longest causal
// walks, first), chunk grid.y. gmap: g's split parts [2 B H, TQ, D] (hi at
// b h, lo at B H + b h).
template <int D, class Bias>
__global__ void __launch_bounds__(kThreads, ATTN_BWD_BF16_DKV_BLOCKS)
dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
           const float* __restrict__ stats, const float* __restrict__ delta, Bias bias,
           const uint32_t* __restrict__ keep, float rate, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int B, int H, int TQ, int TK, float scale) {
  using L = DkvLayout<D, Bias>;
  constexpr uint32_t kTile = L::kTile, kPanel = kRows * 128;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  const uint32_t ks = smem_u32(smem), vs = ks + kTile;
  unsigned char* ring = smem + 2 * kTile;
  // keep words [2][64 queries][2]: this query tile's, and the next one's,
  // loaded under this tile's dV and dK products
  uint32_t* words = reinterpret_cast<uint32_t*>(ring + S * L::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(words + 2 * 2 * kRows);  // K V, stage 0, stage 1

  const int BH = B * H, nq = (TQ + kRows - 1) / kRows;
  const int bh = blockIdx.x % BH, kt = (int)(blockIdx.x / BH);
  const int b = bh / H, h = bh % H, chunk = blockIdx.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, lg = lane >> 2, lq = lane & 3;
  const int k0 = kt * kRows, kl0 = 16 * w + lg;  // this lane's keys k0 + kl0, + 8
  const int first = Bias::kCausal ? kt : 0;     // causal: from the diagonal
  const int count = nq - first;
  const bool drop = rate > 0.f;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  const float* sth = stats + (size_t)bh * TQ * 2;
  const float* dlh = delta + (size_t)bh * TQ;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) bar_init(bars + i);
    bar_init_fence();
  }
  __syncthreads();
  auto load = [&](int it) {  // query tile first + it into stage it % S
    unsigned char* dst = ring + (it % S) * L::kStage;
    const int q0 = (first + it) * kRows;
    uint64_t* bar = bars + 1 + it % S;
    if (tid == 0) {
      bar_expect(bar, 3 * kTile);
      for (int p = 0; p < panels(D); ++p) {
        tma_load(dst + p * kPanel, &qmap, 64 * p, q0, bh, bar);
        tma_load(dst + kTile + p * kPanel, &gmap, 64 * p, q0, bh, bar);
        tma_load(dst + 2 * kTile + p * kPanel, &gmap, 64 * p, q0, BH + bh, bar);
      }
    }
    float* bt = reinterpret_cast<float*>(dst + 3 * kTile);
    bias.template load<kRows, kRows, kThreads>(bt, b, q0, k0, tid);
    float* nums = bt + L::kBias / 4;  // [64][2] statistics, then [64] delta
    for (int i = tid; i < 3 * kRows; i += kThreads) {
      const bool is_stat = i < 2 * kRows;
      const int r = is_stat ? i / 2 : i - 2 * kRows;
      const bool in = q0 + r < TQ;
      const float* src = is_stat ? sth + (size_t)(q0 + r) * 2 + (i & 1) : dlh + q0 + r;
      cp_async4(nums + i, in ? src : stats, in);
    }
  };
  if (tid == 0) {
    bar_expect(bars, 2 * kTile);
    for (int p = 0; p < panels(D); ++p) {
      tma_load(smem + p * kPanel, &kmap, 64 * p, k0, bh, bars);
      tma_load(smem + kTile + p * kPanel, &vmap, 64 * p, k0, bh, bars);
    }
  }
  if (count > 0) load(0);
  cp_commit();
  // this thread loads query tid / 2's keep word of keys k0 + 32 (tid % 2) ..
  // of each query tile (the dQ pass drew it); the first tile's now
  const int W = keep_words(TK);
  const uint32_t* kw = drop ? keep + (size_t)bh * TQ * W + 2 * kt + (tid & 1) : nullptr;
  auto keep_at = [&](int q0) {
    const int row = q0 + (tid >> 1);
    return row < TQ ? kw[(size_t)row * W] : 0u;
  };
  if (drop && count > 0) words[tid] = keep_at(first * kRows);

  float dka[32], dva[32];
  zero(dka);
  zero(dva);
  for (int it = 0; it < count; ++it) {
    const int q0 = (first + it) * kRows, st = it % S;
    const uint32_t* wt = words + (it & 1) * 2 * kRows;
    if (S == 2) {
      if (it + 1 < count) load(it + 1);
    } else if (it > 0) {
      load(it);
    }
    cp_commit();
    if (it == 0) bar_wait(bars, 0);
    bar_wait(bars + 1 + st, (uint32_t)(it / S) & 1u);
    cp_wait<S - 1>();
    __syncthreads();
    unsigned char* stage = ring + st * L::kStage;
    const uint32_t qs = smem_u32(stage), ghs = qs + kTile, gls = qs + 2 * kTile;
    const float* bt = reinterpret_cast<const float*>(stage + 3 * kTile);
    const float* nums = bt + L::kBias / 4;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
    rows_product<D>(s, ks, kPanel, qs, kPanel, 0);   // sᵀ = K qᵀ
    rows_product<D>(dp, vs, kPanel, gls, kPanel, 0);  // dpᵀ = V gᵀ, the small terms first
    rows_product<D>(dp, vs, kPanel, ghs, kPanel, 1);
    wg_commit();
    wg_wait();
    hold(s);
    hold(dp);
    const bool diag = Bias::kCausal && q0 == k0;
    // dsᵀ and (p kf)ᵀ: rows keys k0 + kl0 (+ 8), columns queries
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kl0 + 8 * (e >> 1), key = k0 + kl;
        const int ql = 8 * n + 2 * lq + (e & 1), qry = q0 + ql;
        float p = 0.f;
        if (Bias::kCausal || (qry < TQ && key < TK))  // causal: T % 64 == 0
          p = prob(bias.template logit<kRows>(s[4 * n + e], scale, bt, ql, kl, qry, key, diag),
                   nums[2 * ql], nums[2 * ql + 1]);
        const float kf =
            drop ? ((wt[2 * ql + (kl >> 5)] >> (kl & 31)) & 1u ? inv_keep : 0.f) : 1.f;
        s[4 * n + e] = p * (dp[4 * n + e] * kf - nums[2 * kRows + ql]) * scale;  // dsᵀ
        dp[4 * n + e] = p * kf;                                                 // (p kf)ᵀ
      }
    const uint32_t cb = chunk * kPanel;  // this chunk's panel of q and g
    // the next query tile's keep word, loaded under this tile's products
    const bool next = drop && it + 1 < count;
    const uint32_t nw = next ? keep_at(q0 + kRows) : 0u;
    uint32_t ah[4][4], al[4][4];
    float c[32];
    // dV += (p kf)ᵀ g: lo hi, hi lo, hi hi into a zeroed sum
    split_frags(dp, ah, al);
    zero(c);
    wg_fence();
    cols_product(c, al, ghs + cb, 0);
    cols_product(c, ah, gls + cb, 1);
    cols_product(c, ah, ghs + cb, 1);
    wg_commit();
    wg_wait();
    hold(c);
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[i] += c[i];
    // dK += dsᵀ q
    split_frags(s, ah, al);
    zero(c);
    wg_fence();
    cols_product(c, al, qs + cb, 0);
    cols_product(c, ah, qs + cb, 1);
    wg_commit();
    if (next) words[((it + 1) & 1) * 2 * kRows + tid] = nw;
    wg_wait();
    hold(c);
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] += c[i];
    __syncthreads();  // this stage is refilled; the next tile's keep words are in
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kl0 + 8 * i;
    if (key >= TK) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = chunk * 64 + 8 * j + 2 * lq;
      if (col >= D) continue;
      const size_t at = ((size_t)bh * TK + key) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

// ---- one kernel: B6 with every key in one tile ------------------------------

// Shared memory of the one-kernel form (D <= 64: one panel): K, V [128][64]
// bf16; two stages of (q [64][64] bf16, g [64][68] fp32, the bias [64][132]
// fp32, the statistics [64][2]); g hi, g lo [64][64] bf16; dsᵀ hi, lo [128][64]
// bf16; the keep words [64][4]; the warps' column sums [8][64] and delta [64];
// the barriers (K V, a stage each). After the walk the stages hold the block's
// dK and dV partials [2][128][64] fp32 for the cluster's sum.
struct FusedLayout {
  static constexpr uint32_t kKV = tile_bytes(kFusedKeys, 64);  // 16 KB
  static constexpr uint32_t kQ = tile_bytes(kRows, 64);        // 8 KB
  static constexpr int kLdg = 68, kLdb = kFusedKeys + 4;
  static constexpr uint32_t kG32 = kQ, kBias = kG32 + kRows * kLdg * 4;
  static constexpr uint32_t kStats = kBias + kRows * kLdb * 4;
  static constexpr uint32_t kStage = round1k(kStats + kRows * 2 * 4);
  static constexpr uint32_t kRing = 2 * kKV;
  static constexpr uint32_t kGhi = kRing + 2 * kStage, kGlo = kGhi + kQ;
  static constexpr uint32_t kDsHi = kGlo + kQ, kDsLo = kDsHi + kKV;
  static constexpr uint32_t kBits = kDsLo + kKV;
  static constexpr uint32_t kParts = kBits + kRows * 4 * 4;
  static constexpr uint32_t kDelta = kParts + 8 * kRows * 4;
  static constexpr uint32_t kBars = kDelta + kRows * 4;
  static constexpr size_t kSmem = 1024 + (size_t)kBars + 3 * 8;
  static_assert(kSmem <= kMaxSmem, "the one-kernel form does not fit");
  static_assert(2 * kStage >= 2 * kFusedKeys * 64 * 4, "no room for the cluster's partials");
};

// Grid: C blocks a (b, h) in clusters of C (block rank = cluster rank), 256
// threads: warpgroup wg on keys 64 wg ... delta and dq (bf16) written; dK, dV
// the sum over the cluster's blocks in rank order, each block rounding and
// writing keys [rank 128 / C, (rank + 1) 128 / C).
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
fused_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const float* __restrict__ g,
             const float* __restrict__ stats, FullBias bias, const long long* __restrict__ seed,
             float rate, uint32_t thr, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int H, int TQ,
             int TK, float scale) {
  using L = FusedLayout;
  constexpr int NT = 2 * kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  const uint32_t ks = smem_u32(smem), vs = ks + L::kKV;
  const uint32_t ghi = ks + L::kGhi, glo = ks + L::kGlo, dshi = ks + L::kDsHi, dslo = ks + L::kDsLo;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::kBits);  // [64 queries][4 words]
  float* colsum = reinterpret_cast<float*>(smem + L::kParts);      // [8 warps][64 queries]
  float* dls = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);   // K V, stage 0, stage 1

  const int C = (int)cluster_size(), rank = (int)cluster_rank();
  const int bh = blockIdx.x / C, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wg = tid >> 7, w8 = tid >> 5, wl = w8 & 3, lane = tid & 31;
  const int lg = lane >> 2, lq = lane & 3;
  const int kl0 = 64 * wg + 16 * wl + lg;  // this lane's keys kl0, kl0 + 8
  const int nq = (TQ + kRows - 1) / kRows;
  const int count = rank < nq ? (nq - rank + C - 1) / C : 0;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) bar_init(bars + i);
    bar_init_fence();
  }
  __syncthreads();
  auto load = [&](int it) {  // query tile rank + C it into stage it % 2
    unsigned char* dst = smem + L::kRing + (it & 1) * L::kStage;
    const int q0 = (rank + C * it) * kRows;
    if (tid == 0) {
      bar_expect(bars + 1 + (it & 1), L::kQ);
      tma_load(dst, &qmap, 0, q0, bh, bars + 1 + (it & 1));
    }
    float* g32 = reinterpret_cast<float*>(dst + L::kG32);
    const float* gh = g + (size_t)bh * TQ * D;
    for (int i = tid; i < kRows * (D / 4); i += NT) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool in = q0 + r < TQ;
      cp_async16(g32 + r * L::kLdg + c, in ? gh + (size_t)(q0 + r) * D + c : g, in);
    }
    bias.template load<kRows, kFusedKeys, NT>(reinterpret_cast<float*>(dst + L::kBias), b, q0, 0,
                                              tid);
    float* st = reinterpret_cast<float*>(dst + L::kStats);
    for (int i = tid; i < 2 * kRows; i += NT) {
      const bool in = q0 + i / 2 < TQ;
      cp_async4(st + i, in ? stats + ((size_t)bh * TQ + q0) * 2 + i : stats, in);
    }
  };
  if (tid == 0) {
    bar_expect(bars, 2 * L::kKV);
    tma_load(smem, &kmap, 0, 0, bh, bars);
    tma_load(smem + L::kKV, &vmap, 0, 0, bh, bars);
  }
  if (count > 0) load(0);
  cp_commit();

  float dka[32], dva[32];
  zero(dka);
  zero(dva);
  for (int it = 0; it < count; ++it) {
    const int q0 = (rank + C * it) * kRows;
    if (it + 1 < count) load(it + 1);
    cp_commit();
    if (it == 0) bar_wait(bars, 0);
    bar_wait(bars + 1 + (it & 1), (uint32_t)(it >> 1) & 1u);
    cp_wait<1>();
    __syncthreads();
    unsigned char* stage = smem + L::kRing + (it & 1) * L::kStage;
    const uint32_t qs = smem_u32(stage);
    const float* bt = reinterpret_cast<const float*>(stage + L::kBias);
    const float* st = reinterpret_cast<const float*>(stage + L::kStats);
    // g split once a query tile (columns past D zero)
    {
      const float* g32 = reinterpret_cast<const float*>(stage + L::kG32);
      for (int i = tid; i < kRows * 16; i += NT) {
        const int r = i >> 4, c = (i & 15) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < D) x = *reinterpret_cast<const float4*>(g32 + r * L::kLdg + c);
        uint2 hh, ll;
        split2(x.x, x.y, hh.x, ll.x);
        split2(x.z, x.w, hh.y, ll.y);
        *reinterpret_cast<uint2*>(smem + L::kGhi + swz(r, c, kRows)) = hh;
        *reinterpret_cast<uint2*>(smem + L::kGlo + swz(r, c, kRows)) = ll;
      }
      fence_async_smem();
    }
    __syncthreads();
    const uint32_t kw = ks + wg * kRows * 128, vw = vs + wg * kRows * 128;  // own 64 keys
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
    rows_product<D>(s, kw, L::kKV, qs, L::kQ, 0);     // sᵀ = K qᵀ
    rows_product<D>(dp, vw, L::kKV, glo, L::kQ, 0);   // dpᵀ = V gᵀ, the small terms first
    rows_product<D>(dp, vw, L::kKV, ghi, L::kQ, 1);
    wg_commit();
    if (drop) {  // query tid / 4's keys 32 (tid % 4) ..: its row once a tile
      const dropout::Row r = dropout::row_state(sd, b, h, q0 + (tid >> 2));
      bits[tid] = keep_word(r, 32 * (tid & 3), thr);
    }
    wg_wait();
    hold(s);
    hold(dp);
    if (drop) __syncthreads();
    // pᵀ and dpᵀ kf; each lane's 16 query columns summed over its two keys
    float col[16];
    zero(col);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kl0 + 8 * (e >> 1), ql = 8 * n + 2 * lq + (e & 1), qry = q0 + ql;
        float p = 0.f;
        if (qry < TQ && kl < TK)
          p = prob(bias.template logit<kFusedKeys>(s[4 * n + e], scale, bt, ql, kl, qry, kl, false),
                   st[2 * ql], st[2 * ql + 1]);
        float d = dp[4 * n + e];
        if (drop) d = (bits[4 * ql + (kl >> 5)] >> (kl & 31)) & 1u ? d * inv_keep : 0.f;
        s[4 * n + e] = p;
        dp[4 * n + e] = d;
        col[2 * n + (e & 1)] += p * d;
      }
    // delta = Σ_keys p dp kf: over the 8 lanes of a column, then the 8 warps in order
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      col[i] += __shfl_xor_sync(0xffffffffu, col[i], 4);
      col[i] += __shfl_xor_sync(0xffffffffu, col[i], 8);
      col[i] += __shfl_xor_sync(0xffffffffu, col[i], 16);
    }
    if (lg == 0)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        colsum[w8 * kRows + 8 * n + 2 * lq] = col[2 * n];
        colsum[w8 * kRows + 8 * n + 2 * lq + 1] = col[2 * n + 1];
      }
    __syncthreads();
    if (tid < kRows) {
      float d = colsum[tid];
#pragma unroll
      for (int i = 1; i < 8; ++i) d += colsum[i * kRows + tid];
      dls[tid] = d;
      if (q0 + tid < TQ) delta[(size_t)bh * TQ + q0 + tid] = d;
    }
    __syncthreads();
    // dsᵀ (to shared memory, split, for dq) and (p kf)ᵀ
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kl0 + 8 * (e >> 1), ql = 8 * n + 2 * lq + (e & 1);
        const float p = s[4 * n + e];
        const float kf =
            drop ? ((bits[4 * ql + (kl >> 5)] >> (kl & 31)) & 1u ? inv_keep : 0.f) : 1.f;
        s[4 * n + e] = p * (dp[4 * n + e] - dls[ql]) * scale;
        dp[4 * n + e] = p * kf;
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t hh, ll;
        split2(s[4 * n + 2 * i], s[4 * n + 2 * i + 1], hh, ll);
        const uint32_t off = swz(kl0 + 8 * i, 8 * n + 2 * lq, kFusedKeys);
        *reinterpret_cast<uint32_t*>(smem + L::kDsHi + off) = hh;
        *reinterpret_cast<uint32_t*>(smem + L::kDsLo + off) = ll;
      }
    fence_async_smem();
    uint32_t ah[4][4], al[4][4];
    float c[32];
    // dV += (p kf)ᵀ g: lo hi, hi lo, hi hi into a zeroed sum
    split_frags(dp, ah, al);
    zero(c);
    wg_fence();
    cols_product(c, al, ghi, 0);
    cols_product(c, ah, glo, 1);
    cols_product(c, ah, ghi, 1);
    wg_commit();
    wg_wait();
    hold(c);
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[i] += c[i];
    // dK += dsᵀ q
    split_frags(s, ah, al);
    zero(c);
    wg_fence();
    cols_product(c, al, qs, 0);
    cols_product(c, ah, qs, 1);
    wg_commit();
    wg_wait();
    hold(c);
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] += c[i];
    __syncthreads();  // both warpgroups' dsᵀ
    // dq = ds K over the 128 keys: this warpgroup's 32 channels 32 wg ..
    float cq[16];
    zero(cq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kFusedKeys / 16; ++kk)
      wgmma_ss32<1, 1>(cq, desc(dslo + kk * 2048, 8192), desc(ks + kk * 2048 + 64 * wg, 8192),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < kFusedKeys / 16; ++kk)
      wgmma_ss32<1, 1>(cq, desc(dshi + kk * 2048, 8192), desc(ks + kk * 2048 + 64 * wg, 8192), 1);
    wg_commit();
    wg_wait();
    hold(cq);
    __nv_bfloat16* dqh = dq + (size_t)bh * TQ * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 16 * wl + lg + 8 * i;
      if (row >= TQ) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = 32 * wg + 8 * j + 2 * lq;
        if (cl < D)
          *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)row * D + cl) =
              __floats2bfloat162_rn(cq[4 * j + 2 * i], cq[4 * j + 2 * i + 1]);
      }
    }
    __syncthreads();  // the stage, g's parts, dsᵀ and the keep words are refilled
  }

  // dK, dV: this block's partial, added over the cluster in rank order
  auto out = [&](int which, int key, int cl, float x, float y) {
    if (key < TK && cl < D)
      *reinterpret_cast<__nv_bfloat162*>((which ? dv : dk) + ((size_t)bh * TK + key) * D + cl) =
          __floats2bfloat162_rn(x, y);
  };
  if (C == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out(0, kl0 + 8 * i, 8 * j + 2 * lq, dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
        out(1, kl0 + 8 * i, 8 * j + 2 * lq, dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    return;
  }
  float* red = reinterpret_cast<float*>(smem + L::kRing);  // [2][128 keys][64]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int at = (kl0 + 8 * i) * 64 + 8 * j + 2 * lq;
      *reinterpret_cast<float2*>(red + at) = make_float2(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
      *reinterpret_cast<float2*>(red + kFusedKeys * 64 + at) =
          make_float2(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  cluster_sync();
  const int rows = kFusedKeys / C, r0 = rank * rows;
  for (int i = tid; i < 2 * rows * 32; i += NT) {
    const int which = i / (rows * 32), key = r0 + (i % (rows * 32)) / 32, cl = (i % 32) * 2;
    const uint32_t addr = smem_u32(red + (which * kFusedKeys + key) * 64 + cl);
    float2 sum = ld_cluster2(addr, 0);
    for (int rr = 1; rr < C; ++rr) {
      const float2 x = ld_cluster2(addr, (uint32_t)rr);
      sum.x += x.x;
      sum.y += x.y;
    }
    out(which, key, cl, sum.x, sum.y);
  }
  cluster_sync();  // no block leaves while another may read its partials
}

// ---- host: launches ---------------------------------------------------------

// Whether B6 takes the one-kernel form at this shape.
inline bool fused(int TK, int D) { return TK <= kFusedKeys && D <= kFusedMaxD; }

// The one-kernel form's blocks a (b, h): the most, up to kMaxCluster and one
// a query tile, that keep all blocks on the card at once (one an SM).
inline int cluster_blocks(int B, int H, int TQ) {
  const long long heads = (long long)B * H, nq = (TQ + kRows - 1) / kRows;
  int c = kMaxCluster;
  while (c > 1 && (heads * c > kSMs || c > nq)) c /= 2;
  return c;
}

// The two-pass backward on `stream`: the dQ pass (writes delta, g's split
// parts to gsplit [2, B, H, TQ, D] bf16 and, at rate > 0, the keep words it
// draws to keep [B, H, TQ, keep_words(TK)]), then the dK/dV pass, which reads
// both. Returns the cudaError_t code.
template <int D, class Bias>
int launch_two_pass(const void* q, const void* k, const void* v, const float* g,
                    const float* stats, const long long* seed, float* delta, void* gsplit,
                    uint32_t* keep, void* dq, void* dk, void* dv, Bias bias, int B, int H,
                    int TQ, int TK, float scale, float rate, cudaStream_t stream) {
  using Dq = DqLayout<D, Bias>;
  using Dkv = DkvLayout<D, Bias>;
  const long long heads = (long long)B * H;
  const long long nq = (TQ + kRows - 1) / kRows, nk = (TK + kRows - 1) / kRows;
  if (gsplit == nullptr || (rate > 0.f && keep == nullptr) || nq * heads > 2147483647LL ||
      nk * heads > 2147483647LL || 2 * heads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (misaligned({q, k, v, g, gsplit, dq, dk, dv}, {stats, delta}))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap qm, km, vm, gm;
  int err = bf16_map(&qm, q, D, TQ, (int)heads, kRows);
  if (err == 0) err = bf16_map(&km, k, D, TK, (int)heads, kRows);
  if (err == 0) err = bf16_map(&vm, v, D, TK, (int)heads, kRows);
  if (err == 0) err = bf16_map(&gm, gsplit, D, TQ, (int)(2 * heads), kRows);
  if (err != 0) return err;
  static bool raised_dq[kMaxDevices] = {}, raised_dkv[kMaxDevices] = {};
  err = tc::raise_smem(dq_kernel<D, Bias>, Dq::kSmem, raised_dq);
  if (err == 0) err = tc::raise_smem(dkv_kernel<D, Bias>, Dkv::kSmem, raised_dkv);
  if (err != 0) return err;
  const uint32_t thr = dropout::threshold(rate);
  using bf = __nv_bfloat16;
  dq_kernel<D, Bias><<<dim3((unsigned)(nq * heads), panels(D)), kThreads, Dq::kSmem, stream>>>(
      qm, km, vm, g, stats, bias, seed, rate, thr, delta, static_cast<bf*>(gsplit), keep,
      static_cast<bf*>(dq), B, H, TQ, TK, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<D, Bias><<<dim3((unsigned)(nk * heads), panels(D)), kThreads, Dkv::kSmem, stream>>>(
      qm, km, vm, gm, stats, delta, bias, keep, rate, static_cast<bf*>(dk),
      static_cast<bf*>(dv), B, H, TQ, TK, scale);
  return (int)cudaGetLastError();
}

// B6's one-kernel form on `stream` (TK <= 128, D <= 64). Returns the
// cudaError_t code.
template <int D>
int launch_fused(const void* q, const void* k, const void* v, const float* g, const float* stats,
                 const long long* seed, float* delta, void* dq, void* dk, void* dv, FullBias bias,
                 int B, int H, int TQ, int TK, float scale, float rate, cudaStream_t stream) {
  static_assert(D <= kFusedMaxD, "one panel of head dims");
  const long long heads = (long long)B * H;
  const int C = cluster_blocks(B, H, TQ);
  if (TK > kFusedKeys || heads * C > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (misaligned({q, k, v, g, dq, dk, dv}, {stats, delta})) return (int)cudaErrorMisalignedAddress;
  CUtensorMap qm, km, vm;
  int err = bf16_map(&qm, q, D, TQ, (int)heads, kRows);
  if (err == 0) err = bf16_map(&km, k, D, TK, (int)heads, kFusedKeys);
  if (err == 0) err = bf16_map(&vm, v, D, TK, (int)heads, kFusedKeys);
  if (err != 0) return err;
  static bool raised[kMaxDevices] = {};
  err = tc::raise_smem(fused_kernel<D>, FusedLayout::kSmem, raised);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(heads * C));
  cfg.blockDim = dim3(2 * kThreads);
  cfg.dynamicSmemBytes = FusedLayout::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using bf = __nv_bfloat16;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fused_kernel<D>, qm, km, vm, g, stats, bias, seed, rate, dropout::threshold(rate),
      delta, static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv), B, H, TQ, TK,
      scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd_bf16
