// The bf16 forms of the causal (B3) and bias (B5) attention forwards, for
// Hopper (sm_90a): one set of kernel templates, instantiated by
// masked_attention_bf16.cu (kCausal) and bias_attention_bf16.cu.
//
// Replaces the TPU kernels `masked_attention` / `_causal_kernel` and
// `bias_attention` / `_bias_kernel` of streamspeech_tpu/ops/pallas_attention.py
// as a bf16 model runs them (`StreamSpeechModel(cfg, dtype=jnp.bfloat16)`: the
// unit decoder hands them bf16 q, k and v, `models/layers.py:289-362`). Their
// body is the fp32 one with bf16 operands:
//
//   s = q Kᵀ (bf16 products, fp32 sums) * scale + bias;  p = softmax(s) in fp32
//   out = p.astype(bf16) V (fp32 sums), written as fp32
//
// bias: causal, the key bias kvb [B, T] plus -1e9 above the diagonal (T a
// multiple of 64); otherwise a [B, TQ, TK] bias that carries the whole mask,
// any TQ and TK (rows past TQ are not written, keys past TK weigh 0).
//
// What bounds it: operations for the causal form (1.05e10 flops against 16 MB
// at [1,8,3200,64]: 0.0106 ms at 989 TFLOP/s), bytes for the bias form at the
// unit decoder's shapes (0.0109 ms at [8,8,1200x128,64], most of it the fp32
// output). On an H100 the wgmma form below reaches 19 % of the first (0.057
// ms) and 48 % of the second (0.0225 ms): a block's tile loop takes ~1700
// cycles a 64-key tile where its products and its exponentials need ~256
// each at their peaks, and no cut that shortened a pipe's share moved it
// (PERF.md §6). Each block runs
// an online softmax over its 64 query rows (a running max, sum and [64, D]
// accumulator in registers) and writes no [T, T] tensor.
// The softmax runs in log2 units: each logit times log2(e), p = 2^(x - max).
//
// Two forms, by shape (`wgmma_form`):
//  - wgmma (D <= 64, every path's shape; the bias form where TK <= 128, every
//    path's TK: the keys padded to the 128 tile). A block is one warpgroup on
//    64 query rows of one (b, h), heads innermost. q, K and V come into
//    shared memory by TMA as 128-byte-swizzled tiles (tensor maps of
//    wgmma.cuh, zero past D and T) onto mbarriers; s = q Kᵀ is
//    `wgmma.mma_async` m64n64k16 with both operands K-major from shared
//    memory; P·V takes A from registers (the accumulator of s, times the keep
//    factor, packed to bf16: an m64n64 accumulator is the A fragment of the
//    product over its columns) and V as the MN-major B operand of the same
//    kind of tile: no transposing load. Causal: key tiles of 64 through a
//    ring of two stages (K, V and the key bias, whose 256 bytes come by
//    `cp.async.bulk` onto the same barrier), the longest walks of the
//    triangle launched first, the mask applied on the diagonal tile only.
//    Bias: every key in one tile of 128 (64 where TK <= 64), so the softmax
//    takes one pass with no rescale; the [64, 128] fp32 bias tile comes by
//    `cp.async` (any TK), its 16-byte chunks swizzled by row so that a warp's
//    reads of its accumulator's columns meet no bank conflict; the H blocks of
//    a (b, query tile) run side by side and read its bias tile from device
//    memory once and from L2 after. Four blocks (causal, 90 registers) or
//    three (bias, 76 KB of shared memory) share an SM, so one block's softmax
//    runs under another's products. Other cuts, each timed against this one
//    in one call (PERF.md §6), read no faster: two warpgroups on 128 rows
//    sharing each K and V tile, three or four stages, q's fragments held in
//    registers, a tile's softmax under the last tile's P·V, and a query
//    tile's keys split over a cluster of 2-4 blocks merged in rank order (2
//    at T_pad 1664 read 18 % faster, 4 and the main path's unsplit calls
//    slower).
//  - mma.sync (D > 64; the bias form at TK > 128): `mma.sync.m16n8k16` with
//    bf16 operands, one warp on 16 rows of a 64-row block; q, K and V by
//    16-byte `cp.async` through a two-stage ring into rows padded to D16 + 8
//    bf16 (D16: D rounded up to 16; columns D..D16 zero-filled, so D % 16 == 8
//    contracts over a zero-padded 16th block), fragments by `ldmatrix.x4` (V's
//    `.trans`); key tiles of 64 keys up to D16 = 128, 32 above (registers: the
//    [16, D] accumulator is D / 2 a lane); q's fragments in registers up to D
//    = 64. Trial builds of 128 rows (8 warps) and of two 16-row tiles a warp
//    read slower at every shape (tools/sweep_bf16.py --lib).
//
// Rounding order: JAX normalises, then rounds (bf16(e / Σe)); these kernels
// round each un-normalised exp(s - running max) (times its keep factor) and
// multiply the fp32 sums by the fp32 1 / Σe at the end. Both are one bf16
// rounding of each probability p_j (at most 2^-8 p_j: 8 significant bits,
// round to nearest), so each output element of the two differs by at most
// 2^-7 Σ p_j |v_j| plus the fp32 summation order; chip_smoke.py holds the
// kernels to the plain version, which follows JAX's order, at that bound,
// element by element. The wgmma form takes 2^x by `ex2.approx.ftz` (one
// MUFU.EX2, as the backward's `prob`), the mma.sync form by exp2f.
//
// Head dims: every multiple of 8 from 8 to 256, as the fp32 kernels.
//
// Two forms of each, by the template flag kTrain:
//  - inference (kTrain = false): no dropout, no row statistics; the serving
//    and forward paths launch it.
//  - training (kTrain = true), what a bf16 train step's kernel route launches
//    (`_causal_pallas` / `_bias_pallas` with dropout, `models/layers.py:
//    289-362`): each probability times its keep factor kf (dropout.cuh, the
//    fp32 kernels' Philox counters, so one seed gives the same mask bit for
//    bit) before the bf16 rounding, as JAX applies the factor before
//    `probs.astype(v.dtype)`; the sum that normalises is the undropped one.
//    The wgmma form draws a tile's keep bits into shared memory as 32-key
//    words (keep_word, a row's Philox state formed once a block) while the
//    score product runs; the mma.sync form a slab's bits beside its
//    exponentials (tc_mma.cuh keep_slab).
//    It writes each row's statistics [B, H, TQ, 2] for attention_bwd_bf16.cuh:
//    the max in log2 units (the units the kernel computes in, x log2(e)
//    rounded by `__fmul_rn` as the backward rounds it) and 1 / sum, so that
//    the backward recomputes p = 2^(x log2(e) - max) / sum with the forward's
//    own expression. The inference form's code is unchanged by the flag
//    (`if constexpr`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"
#include "wgmma.cuh"

namespace bf16attn {

using tc::cp_async16;
using tc::cp_commit;
using tc::cp_wait;
using tc::kMaxDevices;
using tc::kMaxSmem;

constexpr int kBQ = 64;  // query rows a block, 16 a warp
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// The bias tile's fp32 row stride for bk keys: >= bk, 8 mod 16 (bias_attention.cu).
__host__ __device__ constexpr int bias_ld(int bk) { return (bk + 7) / 16 * 16 + 8; }

template <int D>
struct Tiles {
  static constexpr int D16 = (D + 15) / 16 * 16;  // the contraction of q Kᵀ, zero-padded
  static constexpr int LD = D16 + 8;              // bf16 a shared row
  static constexpr int BK = D16 <= 128 ? 64 : 32;  // most keys a tile
  static constexpr int NT = BK / 8;               // 8-key tiles of S
  static constexpr int NO = D / 8;                // 8-channel tiles of the output
  static constexpr int KS = D16 / 16;             // k-steps of q Kᵀ
  static constexpr bool kQInRegisters = KS <= 4;  // up to D = 64: 4 KS registers
  static_assert(D % 8 == 0 && D >= 8 && D <= 256, "head dim: a multiple of 8 in [8, 256]");
  // bytes of the q tile and of one ring stage of bk keys (K, V and the bias)
  static constexpr size_t kQBytes = (size_t)kBQ * LD * 2;
  __host__ __device__ static constexpr size_t stage_bytes(int bk, bool causal) {
    return (size_t)2 * bk * LD * 2 + (causal ? (size_t)bk : (size_t)kBQ * bias_ld(bk)) * 4;
  }
  static constexpr size_t smem(int bk, int stages, bool causal) {
    return kQBytes + stages * stage_bytes(bk, causal);
  }
  static_assert(kQBytes + 2 * ((size_t)2 * BK * LD * 2 + (size_t)kBQ * bias_ld(BK) * 4) <=
                    kMaxSmem,
                "tiles do not fit shared memory");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: m16n8k16, bf16 inputs, fp32 accumulators.
// Fragments, lane = 4 g + q: A a0 (g, 2q..2q+1) a1 (g+8, 2q..) a2 (g, 2q+8..)
// a3 (g+8, 2q+8..); B b0 (k 2q..2q+1, n g) b1 (k 2q+8.., n g); C as TF32's.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half: the column
// order of an A fragment's register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The keep bits of keys k0 .. k0 + 31 (k0 % 4 == 0) of one Philox row: bit j
// for key k0 + j.
__device__ __forceinline__ uint32_t keep_word(const dropout::Row& r, int k0, uint32_t thr) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) w |= dropout::keep4(r, (uint32_t)(k0 / 4 + j), thr) << (4 * j);
  return w;
}

// Rows [r0, r0 + rows) of a [n, D] bf16 matrix into a [rows][LD] tile, 8 bf16
// a copy; rows outside [0, n) and columns D..D16 zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          int r0, int rows, int n, int tid) {
  using F = Tiles<D>;
  constexpr int CH = F::D16 / 8;
  for (int i = tid; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < n && c < D / 8;
    cp_async16(reinterpret_cast<float*>(tile + r * F::LD + 8 * c),
               reinterpret_cast<const float*>(in ? src + (size_t)(r0 + r) * D + 8 * c : src),
               in);
  }
}

// Keys [k0, k0 + bk) of K and V, and their bias: the key bias [bk] (causal),
// or the bias tile of the block's rows q0.. ([kBQ][bias_ld(bk)], zeros
// outside [TQ, TK]; 16-byte copies when TK % 4 == 0, else 4-byte).
template <int D, bool kCausal>
__device__ __forceinline__ void stage_keys(unsigned char* dst, const __nv_bfloat16* kh,
                                           const __nv_bfloat16* vh, const float* bb, int k0,
                                           int bk, int q0, int TQ, int TK, int tid) {
  using F = Tiles<D>;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(dst);
  load_rows<D>(ks, kh, k0, bk, TK, tid);
  load_rows<D>(ks + bk * F::LD, vh, k0, bk, TK, tid);
  float* bs = reinterpret_cast<float*>(ks + 2 * bk * F::LD);
  if constexpr (kCausal) {  // T % 4 == 0: whole 16-byte groups, zeros past T
    for (int i = tid; i < bk / 4; i += kThreads) {
      const bool in = k0 + 4 * i < TK;
      cp_async16(bs + 4 * i, in ? bb + k0 + 4 * i : bb, in);
    }
  } else if (TK % 4 == 0) {
    const int ldb = bias_ld(bk), cg = bk / 4;
    for (int i = tid; i < kBQ * cg; i += kThreads) {
      const int r = i / cg, c = (i % cg) * 4;
      const bool in = q0 + r < TQ && k0 + c < TK;
      cp_async16(bs + r * ldb + c, in ? bb + (size_t)(q0 + r) * TK + k0 + c : bb, in);
    }
  } else {
    const int ldb = bias_ld(bk);
    for (int i = tid; i < kBQ * bk; i += kThreads) {
      const int r = i / bk, c = i % bk;
      const bool in = q0 + r < TQ && k0 + c < TK;
      tc::cp_async4(bs + r * ldb + c, in ? bb + (size_t)(q0 + r) * TK + k0 + c : bb, in);
    }
  }
}

// bk: keys a tile (causal: BK; bias: TK rounded up to 16, at most BK).
// bias: kvb [B, TQ] (causal, TQ == TK) or [B, TQ, TK].
// kTrain: seed (when rate > 0) and stats (when not null) as above; thr the
// integer keep threshold of rate (dropout::threshold).
template <int D, bool kCausal, bool kTrain>
__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, const long long* __restrict__ seed,
                      float* __restrict__ stats, float rate, uint32_t thr, int B, int H,
                      int TQ, int TK, int bk, float scale) {
  using F = Tiles<D>;
  constexpr int LD = F::LD, NT = F::NT, NO = F::NO, KS = F::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBQ][LD]
  unsigned char* ring = smem + F::kQBytes;                     // [1 or 2][K, V, bias]
  const size_t stage = F::stage_bytes(bk, kCausal);
  const int ldb = bias_ld(bk);

  const int nq = (TQ + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  // causal: the longest walks of the triangle first
  const int qt = kCausal ? nq - 1 - (int)(blockIdx.x / (B * H)) : (int)(blockIdx.x / (B * H));
  const int b = bh / H;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, lq = lane % 4;
  const __nv_bfloat16* qh = q + (size_t)bh * TQ * D;
  const __nv_bfloat16* kh = k + (size_t)bh * TK * D;
  const __nv_bfloat16* vh = v + (size_t)bh * TK * D;
  const float* bb = kCausal ? bias + (size_t)b * TK : bias + (size_t)b * TQ * TK;
  const int q0 = qt * kBQ, rw = 16 * w;  // this warp's rows: q0 + rw .. + 16
  const int row0 = q0 + rw + g;          // this lane's rows: row0, row0 + 8
  // causal: key tiles past the diagonal weigh 0
  const int kend = kCausal ? min(q0 + kBQ, TK) : TK;

  load_rows<D>(qs, qh, q0, kBQ, TQ, tid);
  stage_keys<D, kCausal>(ring, kh, vh, bb, 0, bk, q0, TQ, TK, tid);
  cp_commit();

  // this lane's ldmatrix rows: q (A) and V (B, transposed) by lane % 16 and a
  // column half by lane / 16; K (B) by key lane % 8 of the tile pair lane / 16
  // and a column half by (lane / 8) % 2
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;

  // the running max is kept in log2 units: p = 2^(x log2(e) - m)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // training: the lane's Philox row (its rows are fixed along the key tiles)
  const bool drop = kTrain && rate > 0.f;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  dropout::Row dr{};
  if constexpr (kTrain) {
    if (drop) dr = tc::keep_lane((unsigned long long)*seed, b, bh % H, row0, lq);
  }
  uint32_t qf[F::kQInRegisters ? KS : 1][4];  // q's A fragments, up to D = 64
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0, it = 0; k0 < kend; k0 += bk, ++it) {
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(ring + (it & 1) * stage);
    const __nv_bfloat16* vs = ks + bk * LD;
    const float* bs = reinterpret_cast<const float*>(vs + bk * LD);
    if (k0 + bk < kend)
      stage_keys<D, kCausal>(ring + ((it + 1) & 1) * stage, kh, vh, bb, k0 + bk, bk, q0, TQ,
                             TK, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int nt = bk / 8;  // 8-key tiles of this tile (even: bk % 16 == 0)
    if constexpr (F::kQInRegisters) {
      if (it == 0)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], qs + (rw + a_row) * LD + 16 * kk + a_col);
    }

    // s = q Kᵀ over the warp's [16, bk] part of the tile
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (F::kQInRegisters) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, qs + (rw + a_row) * LD + 16 * kk + a_col);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np >= nt) break;
        uint32_t kb[4];
        ldsm_x4(kb, ks + (16 * np + k_row) * LD + 16 * kk + k_col);
        mma_bf16(s[2 * np], a, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], a, kb[2], kb[3]);
      }
    }

    // scale, bias and mask in the fp32 forward's order, then to log2 units;
    // the tile's row max over the 4 lanes of a row. Causal: only a tile that
    // reaches past the warp's first row holds keys above the diagonal
    const bool diagonal = kCausal && k0 + bk - 1 > q0 + rw;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 8 * (e >> 1), c = 8 * n + 2 * lq + (e & 1);
        float x;
        if constexpr (kCausal) {
          x = s[n][e] * scale + bs[c];
          if (diagonal && k0 + c > r) x += kNegInf;
        } else {
          x = r < TQ && k0 + c < TK ? s[n][e] * scale + bs[(r - q0) * ldb + c] : -INFINITY;
        }
        // training: rounded as the backward rounds it (attention_bwd_bf16.cuh prob)
        s[n][e] = kTrain ? __fmul_rn(x, kLog2e) : x * kLog2e;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
      }
    }
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // a row past TQ stays finite
      alpha[i] = exp2f(m[i] - m_use[i]);           // 0 on the first tile
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) break;
      // training: the slab's keep bits (all 32 lanes draw: nt is the warp's)
      uint32_t kb = 0u;
      if constexpr (kTrain) {
        if (drop) kb = tc::keep_slab(dr, k0 + 8 * n, lq, thr);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_use[e >> 1]);
        sum[e >> 1] += p;
        if constexpr (kTrain) {
          s[n][e] = drop ? tc::keep_apply(kb, e, p, inv_keep) : p;
        } else {
          s[n][e] = p;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += bf16(p) V, 16 keys a k-step: S tiles 2 kp and 2 kp + 1 are the A
    // fragment; V's rows past TK are zeros
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {
      if (2 * kp >= nt) break;
      const uint32_t pa[4] = {pack_bf16(s[2 * kp][0], s[2 * kp][1]),
                              pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                              pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
      const __nv_bfloat16* vr = vs + (16 * kp + a_row) * LD;
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vr + 16 * dp + a_col);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
      if constexpr (NO % 2 == 1) {
        uint32_t vb[2];
        ldsm_x2_trans(vb, vr + 8 * (NO - 1));
        mma_bf16(acc[NO - 1], pa, vb[0], vb[1]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / l[i];
  if constexpr (kTrain) {
    if (stats != nullptr && lq == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < TQ)
          *reinterpret_cast<float2*>(stats + ((size_t)bh * TQ + row0 + 8 * i) * 2) =
              make_float2(m[i], inv[i]);
  }
  float* oh = out + (size_t)bh * TQ * D;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < TQ)
        *reinterpret_cast<float2*>(oh + (size_t)(row0 + 8 * i) * D + 8 * j + 2 * lq) =
            make_float2(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
}

// ---- the wgmma form ----------------------------------------------------------

constexpr int kWgMaxD = 64;        // one 64-column panel of head dims
constexpr int kWgBiasKeys = 128;   // the bias form's one key tile

// Whether a call takes the wgmma form (else the mma.sync form above).
__host__ __device__ constexpr bool wgmma_form(bool causal, int TK, int D) {
  return D <= kWgMaxD && (causal || TK <= kWgBiasKeys);
}

// Shared memory of the wgmma form: q [64][64] bf16; the ring's stages (K and
// V [BK][64] bf16; causal: two stages, tile j in stage j % 2; bias: one); the
// bias (causal: each stage's [BK] key bias; bias form: a [64][128] fp32 tile,
// 16-byte chunks swizzled by row, bias_at); the training form's keep words of
// a tile [64][BK / 32]; the barriers (q, a stage each).
template <bool kCausal, bool kTrain>
struct WgLayout {
  static constexpr int BK = kCausal ? 64 : kWgBiasKeys;  // keys a tile
  static constexpr int kStages = kCausal ? 2 : 1;
  static constexpr int NW = BK / 32;  // keep words a row of a tile
  static constexpr uint32_t kQ = wg::tile_bytes(kBQ, kWgMaxD);
  static constexpr uint32_t kKV = wg::tile_bytes(BK, kWgMaxD);
  static constexpr uint32_t kRing = kQ;  // stage st: K at kRing + 2 st kKV, V after it
  static constexpr uint32_t kBias = kRing + kStages * 2 * kKV;
  static constexpr uint32_t kWords = kBias + (kCausal ? kStages * BK : kBQ * BK) * 4;
  static constexpr uint32_t kBars = kWords + (kTrain ? kBQ * NW * 4 : 0);
  static constexpr size_t kSmem = 1024 + kBars + (1 + kStages) * 8;
  static_assert(kSmem <= kMaxSmem, "the wgmma form's tiles do not fit");
};

// The bias form's tile: element (r, c) of [64][128] fp32, its 16-byte chunk
// c / 4 at chunk (c / 4) ^ 2 (r % 4). A half-warp's 8-byte reads of its
// accumulator's columns (rows g, columns 2 q .. of a chunk pair) then fall on
// 16 distinct bank pairs: no conflict.
__device__ __forceinline__ int bias_at(int r, int c) {
  return r * kWgBiasKeys + (((c >> 2) ^ ((r & 3) << 1)) << 2) + (c & 3);
}

// Rows q0 .. q0 + 63, keys 0 .. keys - 1 of one b's bias [TQ, TK] (src) into
// the swizzled tile by `cp.async`, 16 bytes a copy when TK % 4 == 0, else 4;
// zeros outside [TQ, TK]. Committed by the caller.
__device__ __forceinline__ void load_bias_tile(float* dst, const float* src, int q0, int TQ,
                                               int TK, int keys, int tid) {
  if (TK % 4 == 0) {
    const int cg = keys / 4;
    for (int i = tid; i < kBQ * cg; i += kThreads) {
      const int r = i / cg, c = (i % cg) * 4;
      const bool in = q0 + r < TQ && c < TK;
      cp_async16(dst + bias_at(r, c), in ? src + (size_t)(q0 + r) * TK + c : src, in);
    }
  } else {
    for (int i = tid; i < kBQ * keys; i += kThreads) {
      const int r = i / keys, c = i % keys;
      const bool in = q0 + r < TQ && c < TK;
      tc::cp_async4(dst + bias_at(r, c), in ? src + (size_t)(q0 + r) * TK + c : src, in);
    }
  }
}

// Block (query tile, b h) of grid.x, heads innermost; causal: the last query
// tiles (the longest walks) first. One warpgroup; a key tile's s = q Kᵀ, its
// softmax, then its P·V; causal: tile j + 2 is loaded into the stage tile j
// freed. bias: kvb [B, TQ] (causal, TQ == TK) or [B, TQ, TK]. kTrain: seed
// (rate > 0), stats (not null) and thr as attention_bf16_kernel.
template <int D, bool kCausal, bool kTrain>
__global__ void __launch_bounds__(kThreads, kCausal ? 4 : 3)
fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
           float* __restrict__ out, const long long* __restrict__ seed,
           float* __restrict__ stats, float rate, uint32_t thr, int B, int H, int TQ, int TK,
           float scale) {
  using L = WgLayout<kCausal, kTrain>;
  constexpr int BK = L::BK, S = L::kStages, NW = L::NW;
  static_assert(D % 8 == 0 && D >= 8 && D <= kWgMaxD, "head dim: a multiple of 8 in [8, 64]");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::align_1k(smem_raw);
  const uint32_t qs = wg::smem_u32(smem);
  float* bsm = reinterpret_cast<float*>(smem + L::kBias);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + L::kWords);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // q, then a stage each

  const int BH = B * H, nq = (TQ + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = kCausal ? nq - 1 - (int)(blockIdx.x / BH) : (int)(blockIdx.x / BH);
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, lq = lane & 3;
  const int q0 = qt * kBQ, rl0 = 16 * w + g;  // this lane's rows q0 + rl0, + 8
  const int nk = kCausal ? qt + 1 : 1;         // key tiles: causal, up to the diagonal
  // the bias form's 64-key halves: one where TK <= 64 (the K and V boxes the
  // host made are that tall)
  const int halves = kCausal ? 1 : (TK > 64 ? 2 : 1);

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) wg::bar_init(bars + i);
    wg::bar_init_fence();
  }
  __syncthreads();
  auto load = [&](int it) {  // key tile it (K, V; causal: the key bias) into stage it % S
    const int st = it % S;
    uint64_t* bar = bars + 1 + st;
    unsigned char* kv = smem + L::kRing + st * 2 * L::kKV;
    wg::bar_expect(bar, 2 * halves * wg::tile_bytes(64, kWgMaxD) + (kCausal ? BK * 4 : 0));
    wg::tma_load(kv, &kmap, 0, it * BK, bh, bar);
    wg::tma_load(kv + L::kKV, &vmap, 0, it * BK, bh, bar);
    if constexpr (kCausal)
      wg::bulk_load(bsm + st * BK, bias + (size_t)b * TK + it * BK, BK * 4, bar);
  };
  if (tid == 0) {
    wg::bar_expect(bars, L::kQ);
    wg::tma_load(smem, &qmap, 0, q0, bh, bars);
    for (int it = 0; it < S && it < nk; ++it) load(it);
  }
  if constexpr (!kCausal) {
    load_bias_tile(bsm, bias + (size_t)b * TQ * TK, q0, TQ, TK, 64 * halves, tid);
    cp_commit();
  }

  // training: this thread draws row tid / 2's keep words (tid % 2) NW / 2 ..
  // of each tile, its Philox row formed once
  const bool drop = kTrain && rate > 0.f;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  dropout::Row dr{};
  if constexpr (kTrain) {
    if (drop) dr = dropout::row_state((unsigned long long)*seed, b, h, q0 + (tid >> 1));
  }
  // the running max is kept in log2 units: p = 2^(x log2(e) - m)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[32];  // [64 rows][64 channels] fp32, m64n64's layout
  wg::zero(acc);
  wg::bar_wait(bars, 0);

  for (int it = 0; it < nk; ++it) {
    const int st = it % S, k0 = it * BK;
    wg::bar_wait(bars + 1 + st, (uint32_t)(it / S) & 1u);
    const uint32_t ks = qs + L::kRing + st * 2 * L::kKV, vs = ks + L::kKV;
    // s = q Kᵀ over the tile's keys, 64 a product
    float s[BK / 2];
    wg::zero(s);
    wg::wg_fence();
    wg::rows_product<D>(s, qs, 0, ks, 0, 0);
    if (!kCausal && halves == 2) wg::rows_product<D>(s + 32, qs, 0, ks + 64 * 128, 0, 0);
    wg::wg_commit();
    if constexpr (kTrain) {  // the tile's keep words, under the product
      if (drop)
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) {
          const int j = (tid & 1) * (NW / 2) + i;
          if (32 * j < 64 * halves) words[(tid >> 1) * NW + j] = keep_word(dr, k0 + 32 * j, thr);
        }
    }
    if constexpr (!kCausal) cp_wait<0>();  // this thread's bias copies
    if (!kCausal || drop) __syncthreads();  // every thread's bias copies and keep words
    wg::wg_wait();
    wg::hold(s);

    // scale, bias and mask in the fp32 forward's order, then to log2 units;
    // the tile's row max over the 4 lanes of a row. Causal: only the diagonal
    // tile holds keys above the diagonal
    const bool diagonal = kCausal && it == nk - 1;
    const float* bt = bsm + (kCausal ? st * BK : 0);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      if (!kCausal && n >= 8 * halves) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = rl0 + 8 * i, c0 = 8 * n + 2 * lq;
        const float2 bv =
            *reinterpret_cast<const float2*>(bt + (kCausal ? c0 : bias_at(rl, c0)));
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * i + e1, c = c0 + e1;
          float x = s[4 * n + e] * scale + (e1 ? bv.y : bv.x);
          if constexpr (kCausal) {
            if (diagonal && c > rl) x += kNegInf;
          } else {
            if (c >= TK) x = -INFINITY;
          }
          // training: rounded as the backward rounds it (attention_bwd_bf16.cuh prob)
          s[4 * n + e] = kTrain ? __fmul_rn(x, kLog2e) : x * kLog2e;
          tmax[i] = fmaxf(tmax[i], s[4 * n + e]);
        }
      }
    }
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key stays finite
      alpha[i] = wg::ex2(m[i] - m_use[i]);          // 0 on the first tile
      m[i] = m_new;
    }
    // this lane's keep words: its two rows' words of the tile
    uint32_t kw[2][NW] = {};
    if constexpr (kTrain) {
      if (drop)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j) kw[i][j] = words[(rl0 + 8 * i) * NW + j];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      if (!kCausal && n >= 8 * halves) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = wg::ex2(s[4 * n + e] - m_use[e >> 1]);
        sum[e >> 1] += p;
        if constexpr (kTrain) {
          const int c = 8 * n + 2 * lq + (e & 1);
          s[4 * n + e] = drop ? ((kw[e >> 1][c >> 5] >> (c & 31)) & 1u ? p * inv_keep : 0.f) : p;
        } else {
          s[4 * n + e] = p;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // o += bf16(p kf) V, 16 keys a k-step: the tile's p kf, rounded to bf16
    // once and packed two to a register, is the A fragment (slabs 2 kk and
    // 2 kk + 1 are k-step kk's); V's rows past TK are zeros
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (!kCausal && kk >= 4 * halves) break;
      wg::wgmma_rs64(acc, pa[kk], wg::desc(vs + kk * 2048, 8192), 1);
    }
    wg::wg_commit();
    wg::wg_wait();
    wg::hold(acc);
    if (it + 1 < nk) {
      __syncthreads();  // this stage and the keep words are refilled
      if (tid == 0 && it + S < nk) load(it + S);
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / l[i];
  const int row0 = q0 + rl0;
  if constexpr (kTrain) {
    if (stats != nullptr && lq == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < TQ)
          *reinterpret_cast<float2*>(stats + ((size_t)bh * TQ + row0 + 8 * i) * 2) =
              make_float2(m[i], inv[i]);
  }
  float* oh = out + (size_t)bh * TQ * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < TQ)
        *reinterpret_cast<float2*>(oh + (size_t)(row0 + 8 * i) * D + 8 * j + 2 * lq) =
            make_float2(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
}

// The wgmma form on `stream`: a block per (query tile, b h). Returns the
// cudaError_t code.
template <int D, bool kCausal, bool kTrain>
int launch_wgmma(const void* q, const void* k, const void* v, const float* bias, float* out,
                 int B, int H, int TQ, int TK, float scale, cudaStream_t stream,
                 const long long* seed, float* stats, float rate) {
  using L = WgLayout<kCausal, kTrain>;
  const long long heads = (long long)B * H;
  const long long blocks = (long long)((TQ + kBQ - 1) / kBQ) * heads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases (rows are D bf16, D a multiple of 8); the bias
  // by 16 bytes (causal's bulk copy; the bias form when TK % 4 == 0) or 4
  if (wg::misaligned({q, k, v, out}, {stats}) ||
      (uintptr_t)bias % (kCausal || TK % 4 == 0 ? 16 : 4) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int kv_rows = kCausal ? L::BK : (TK > 64 ? 128 : 64);
  CUtensorMap qm, km, vm;
  int err = wg::bf16_map(&qm, q, D, TQ, (int)heads, kBQ);
  if (err == 0) err = wg::bf16_map(&km, k, D, TK, (int)heads, kv_rows);
  if (err == 0) err = wg::bf16_map(&vm, v, D, TK, (int)heads, kv_rows);
  if (err != 0) return err;
  static bool raised[kMaxDevices] = {};
  err = tc::raise_smem(fwd_kernel<D, kCausal, kTrain>, L::kSmem, raised);
  if (err != 0) return err;
  fwd_kernel<D, kCausal, kTrain><<<(unsigned)blocks, kThreads, L::kSmem, stream>>>(
      qm, km, vm, bias, out, seed, stats, rate, kTrain ? dropout::threshold(rate) : 0u, B, H,
      TQ, TK, scale);
  return (int)cudaGetLastError();
}

// The mma.sync form on `stream`. Returns the cudaError_t code.
template <int D, bool kCausal, bool kTrain>
int launch_mma(const void* q, const void* k, const void* v, const float* bias, float* out, int B,
               int H, int TQ, int TK, float scale, cudaStream_t stream, const long long* seed,
               float* stats, float rate) {
  using F = Tiles<D>;
  // 16-byte cp.async: rows are D bf16, D a multiple of 8, so the bases decide
  // (the bias's when it goes by 16 bytes)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0 ||
      ((kCausal || TK % 4 == 0) && (uintptr_t)bias % 16 != 0) || (uintptr_t)bias % 4 != 0 ||
      (uintptr_t)stats % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (long long)((TQ + kBQ - 1) / kBQ) * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int bk16 = (TK + 15) / 16 * 16;
  const int bk = kCausal || bk16 > F::BK ? F::BK : bk16;
  const int kend = kCausal ? TQ : TK;
  const size_t smem = F::smem(bk, kend > bk ? 2 : 1, kCausal);
  static bool raised[kMaxDevices] = {};
  const int err = tc::raise_smem(attention_bf16_kernel<D, kCausal, kTrain>,
                                 F::smem(F::BK, 2, kCausal), raised);
  if (err != 0) return err;
  attention_bf16_kernel<D, kCausal, kTrain><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, out, seed, stats, rate,
      kTrain ? dropout::threshold(rate) : 0u, B, H, TQ, TK, bk, scale);
  return (int)cudaGetLastError();
}

// Launch on `stream`: blocks of kBQ query rows for every (b, h), in the form
// `wgmma_form` picks. kTrain: seed (read when rate > 0), stats (written when
// not null), rate. Returns the cudaError_t code.
template <int D, bool kCausal, bool kTrain = false>
int launch(const void* q, const void* k, const void* v, const float* bias, float* out, int B,
           int H, int TQ, int TK, float scale, cudaStream_t stream,
           const long long* seed = nullptr, float* stats = nullptr, float rate = 0.f) {
  if (kTrain && (rate < 0.f || rate >= 1.f || (rate > 0.f && seed == nullptr)))
    return (int)cudaErrorInvalidValue;
  if constexpr (D > kWgMaxD) {
    return launch_mma<D, kCausal, kTrain>(q, k, v, bias, out, B, H, TQ, TK, scale, stream, seed,
                                          stats, rate);
  } else if constexpr (kCausal) {
    return launch_wgmma<D, true, kTrain>(q, k, v, bias, out, B, H, TQ, TK, scale, stream, seed,
                                         stats, rate);
  } else {
    if (wgmma_form(false, TK, D))
      return launch_wgmma<D, false, kTrain>(q, k, v, bias, out, B, H, TQ, TK, scale, stream,
                                            seed, stats, rate);
    return launch_mma<D, false, kTrain>(q, k, v, bias, out, B, H, TQ, TK, scale, stream, seed,
                                        stats, rate);
  }
}

}  // namespace bf16attn
