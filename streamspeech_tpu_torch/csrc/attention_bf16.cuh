// The bf16 forms of the causal (B3) and bias (B5) attention forwards, for
// Hopper (sm_90a): one kernel template, instantiated by
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
// unit decoder's shapes. Both products run as `mma.sync.m16n8k16` with bf16
// operands and fp32 accumulators, one product a k-step (the fp32 kernels run
// three TF32 products for each). Each warp owns 16 query rows of a 64-row
// block, a running max, sum and [16, D] accumulator in registers (the online
// softmax of masked_attention.cu), and no [T, T] tensor is written.
//  - q, K and V come into shared memory by 16-byte `cp.async` (8 bf16), K and
//    V through a two-stage ring, the next tile's loads under this tile's
//    products; rows are padded to D16 + 8 bf16 (D16: D rounded up to 16),
//    which puts the 8 rows of an `ldmatrix` phase on 8 distinct 16-byte bank
//    groups. Columns D..D16 are zero-filled by the same copies (src-size 0),
//    so D % 16 == 8 contracts over a zero-padded 16th block.
//  - q and K fragments by `ldmatrix.x4`; V's by `ldmatrix.x4.trans` (the P·V
//    product wants V's columns along the key axis, V is stored by keys).
//  - q's fragments stay in registers up to D = 64 (4 KS registers), read
//    from shared memory by each k-step above.
//  - The softmax runs in log2 units: each logit times log2(e), p = 2^(x -
//    max) by ex2 (exp2f), one instruction where expf is several; a causal
//    tile tests the diagonal only where it reaches past the warp's first row.
//  - p stays in registers: the accumulator of two 8-key tiles of S is, packed
//    two to a register in bf16, the A fragment of the 16-key k-step of P·V.
//    That packing (round to nearest even) is JAX's `probs.astype(v.dtype)`.
// Rounding order: JAX normalises, then rounds (bf16(e / Σe)); this kernel
// rounds each un-normalised exp(s - running max) and divides the fp32 sums by
// the fp32 Σe at the end. Both are one bf16 rounding of each probability p_j
// (at most 2^-8 p_j: 8 significant bits, round to nearest), so each output
// element of the two differs by at most 2^-7 Σ p_j |v_j| plus the fp32
// summation order; chip_smoke.py holds the kernel to the plain version, which
// follows JAX's order, at that bound, element by element.
// `mma.sync` and not `wgmma`: right first; bf16 `wgmma` (which may read an
// MN-major B, unlike TF32) is later work.
//
// Query tiles of kBQ = 64 rows, 4 warps: trial builds of 128 rows (8 warps)
// and of two 16-row tiles a warp read slower at every shape
// (tools/sweep_bf16.py --lib).
//
// Head dims: every multiple of 8 from 8 to 256, as the fp32 kernels; key tiles
// of 64 keys up to D16 = 128, 32 above (registers: the [16, D] accumulator is
// D / 2 a lane).
//
// Two forms of each, by the template flag kTrain:
//  - inference (kTrain = false): no dropout, no row statistics; the serving
//    and forward paths launch it.
//  - training (kTrain = true), what a bf16 train step's kernel route launches
//    (`_causal_pallas` / `_bias_pallas` with dropout, `models/layers.py:
//    289-362`): each probability times its keep factor kf (dropout.cuh, the
//    fp32 kernels' Philox counters, so one seed gives the same mask bit for
//    bit; a slab's bits drawn beside its exponentials, tc_mma.cuh keep_slab)
//    before the bf16 rounding, as JAX applies the factor before
//    `probs.astype(v.dtype)`; the sum that normalises is the undropped one.
//    It writes each row's statistics [B, H, TQ, 2] for attention_bwd_bf16.cuh:
//    the max in log2 units (the units the kernel computes in) and 1 / sum, so
//    that the backward recomputes p = 2^(x log2(e) - max) / sum with the
//    forward's own expression. The inference form's code is unchanged by the
//    flag (`if constexpr`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"

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

// Launch on `stream`: blocks of kBQ query rows for every (b, h). kTrain: seed
// (read when rate > 0), stats (written when not null), rate. Returns the
// cudaError_t code.
template <int D, bool kCausal, bool kTrain = false>
int launch(const void* q, const void* k, const void* v, const float* bias, float* out, int B,
           int H, int TQ, int TK, float scale, cudaStream_t stream,
           const long long* seed = nullptr, float* stats = nullptr, float rate = 0.f) {
  using F = Tiles<D>;
  // 16-byte cp.async: rows are D bf16, D a multiple of 8, so the bases decide
  // (the bias's when it goes by 16 bytes)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0 ||
      ((kCausal || TK % 4 == 0) && (uintptr_t)bias % 16 != 0) || (uintptr_t)bias % 4 != 0 ||
      (uintptr_t)stats % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (kTrain && (rate < 0.f || rate >= 1.f || (rate > 0.f && seed == nullptr)))
    return (int)cudaErrorInvalidValue;
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

}  // namespace bf16attn
