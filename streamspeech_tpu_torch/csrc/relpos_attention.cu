// Relative-position (Transformer-XL / espnet) self-attention, fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `relpos_attention` / `_kernel` in
// streamspeech_tpu/ops/pallas_attention.py (the conformer encoder's offline
// self-attention, every layer, at T >= 256). For q_u, q_v, k, v [B, H, T, D],
// the per-head projected table p [H, R >= 2T-1, D] (row u <-> relative
// position T-1-u) and an additive bias [B, 1 or H, T, T]:
//
//   s[i,j]   = (q_u[i] . k[j] + q_v[i] . p[T-1-i+j]) * scale + bias[i,j]
//   out[i]   = sum_j softmax_j(s[i,j]) * v[j]
//
// The TPU kernel multiplies q_v by a band of the table and shears the
// product with a per-row strided roll (`pltpu.roll`), which has no Hopper
// counterpart. Here the shear is a band product read back on its diagonal,
// per warp: the warp that owns query rows [a0, a0 + 16) and keys [c0, c0 +
// KS) of a (query tile, key tile) pair reads table window rows (BQ - 1) - a +
// c, 16 + KS - 1 consecutive rows. It forms band = q_v Pwᵀ over those rows
// (plus one: (KS + 16) / 8 slabs of 8), stores the [16, KS + 16] result to a
// warp-private shared-memory tile and reads element (a', 15 - a' + c') back
// into the score fragment's (a', c') place. No [T, 2T-1] or [T, T] tensor is
// ever written.
//
// What bounds it: operations (0.81 GFLOP against 13 MB at [8,4,256,64]), and
// at B = 1 the grid (64 groups of 16 query rows for 132 SMs). So:
//  - All three products, s = q_u Kᵀ, the band and o += p V, run on the tensor
//    cores as m16n8k8 TF32 `mma.sync` in 3xTF32 (tc_mma.cuh's split and
//    mma3).
//  - A block is RW row groups of 16 queries by KW key slices: each warp runs
//    the online softmax of masked_attention.cu over its KS = 16 keys of every
//    key tile of KS KW keys (running max and sum, reduced over the 4 lanes of
//    a row; p from the accumulator to the A operand of p V in registers, V's
//    fragment rows read in the accumulator's key order), and at the end the
//    key slices of a row group merge their (acc, max, sum) through shared
//    memory, rescaled to the rows' overall max and added in slice order. The
//    key slices put each row group on KW warps at once: at B = 1 a warp alone
//    on its SM sub-partition waits on each product's latency (1 x 1 read
//    0.0734 ms at [1,4,256,64], 1 x 8 0.0154; tools/sweep_attention_fwd.py).
//  - Two cuts, picked by the launcher from B·H·T: 1 x 8 (128-key tiles, a
//    row group on 8 warps) while the row groups number fewer than two per SM,
//    4 x 4 (64 query rows share each staged tile, a quarter of the key and
//    table traffic a query row of 1 x 8) above; a head dim whose tiles do not
//    fit takes fewer key slices, then fewer row groups, and a key tile that
//    does not divide T becomes 64 keys.
//  - q_u and q_v are split into hi and lo once a block, into shared tiles
//    (16 tf32 operands a k-step in registers, 128 at D = 64, do not fit
//    beside the accumulators): 8 of a k-step's 20 operand fragments are then
//    read, not split (4-6 % off the time of a split at every k-step at the
//    sweep's shapes). K, V, the table window (BQ + BK rows) and the bias tile
//    [BQ, BK] come in by 16-byte `cp.async` (T % 64 == 0, so bias rows are
//    16-byte aligned) into one stage, refilled after each tile's products:
//    at 199 KB (4 x 4) and 155 KB (1 x 8) at D = 64 a block holds its SM
//    alone, and a second stage does not fit beside the split q tiles.
// `mma.sync` and not `wgmma`: TF32 `wgmma` reads its operands K-major only,
// and V in p V is not K-major; the two score products could take it, but
// they share the online softmax's fragment layout with p V.
//
// Training adds dropout (rate > 0, `_kernel` :84-87) and the row statistics
// output (stats != null, [B, H, T, 2]: max and 1 / sum), both exactly as in
// masked_attention.cu: the keep bits of dropout.cuh drawn on the score
// fragments beside the exponentials (tc_mma.cuh keep_slab), scaling the
// weights that go into p V only, never the running sum;
// relpos_attention_bwd.cu reads the statistics.
//
// Head dims: every multiple of 8 from 8 to 256. T must be a multiple of 64.

#include <math.h>

#include "tc_mma.cuh"

// Compile-time choices of the build (tools/sweep_attention_fwd.py times
// others): one cut forced at every shape (RW row groups of 16 queries by KW
// key slices a block; 0: the launcher's two cuts and its rule), and the keys
// a warp takes of a tile.
#ifndef RELPOS_FWD_CUT_RW
#define RELPOS_FWD_CUT_RW 0
#endif
#ifndef RELPOS_FWD_CUT_KW
#define RELPOS_FWD_CUT_KW 0
#endif
#ifndef RELPOS_FWD_KS
#define RELPOS_FWD_KS 16
#endif

namespace {

using namespace tc;

constexpr int kMaxD = 256;
constexpr int KS = RELPOS_FWD_KS;  // keys a warp a tile

// The shared memory of a block of RW row groups by KW key slices at head dim
// d, in bytes: q_u and q_v split, hi and lo [BQ][LD] each; one stage of K, V
// ([BK][LD] each), the table window ([BQ + BK][LD]) and the bias tile
// ([BQ][BK + 8]); a [16][KS + 24] band tile a warp.
constexpr size_t smem_of(int d, int rw, int kw) {
  const size_t bq = 16 * rw, bk = (size_t)KS * kw, ld = d + 4;
  return 4 * (4 * bq * ld + (3 * bk + bq) * ld + bq * (bk + 8) +
              (size_t)rw * kw * 16 * (KS + 24));
}

// A cut whose tiles do not fit shared memory takes fewer key slices, then
// fewer row groups, until they do.
constexpr int fit_kw(int d, int rw, int kw) {
  while (kw > 1 && smem_of(d, rw, kw) > kMaxSmem) kw /= 2;
  return kw;
}
constexpr int fit_rw(int d, int rw, int kw) {
  while (rw > 1 && smem_of(d, rw, fit_kw(d, rw, kw)) > kMaxSmem) rw /= 2;
  return rw;
}

// The tiles of one (head dim, cut): BQ = 16 RW query rows, BK = KS KW keys;
// rows of LD = D + 4 floats (smem_of). LDB and LDW are 8 mod 16, so a quad's
// float2 rows hit 32 banks. After the key loop the stage holds the key
// slices' (acc, max, sum) for the merge.
template <int D, int RW, int KW>
struct Rel {
  static constexpr int BQ = 16 * RW, BK = KS * KW;
  static constexpr int LD = D + 4, LDB = BK + 8, LDW = KS + 24;
  static constexpr int kWarps = RW * KW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr size_t kStage = (size_t)(3 * BK + BQ) * LD + (size_t)BQ * LDB;
  static constexpr size_t kSmem = smem_of(D, RW, KW);
  static constexpr int NT = KS / 8;         // 8-key slabs of a warp's keys
  static constexpr int NB = (KS + 16) / 8;  // 8-row slabs of a warp's band
  static constexpr int NO = D / 8;          // 8-channel slabs of the output
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  static_assert(kSmem <= kMaxSmem, "tiles do not fit shared memory");
  static_assert((size_t)(KW - 1) * RW * 16 * (LD + 2) <= kStage, "merge does not fit");
};

// Keys [k0, k0 + BK) of K and V, the table window from row u0 and the bias
// tile's columns k0.. (of the block's BQ rows from `brow`) into one stage.
template <int D, int RW, int KW>
__device__ __forceinline__ void stage_keys(float* dst, const float* kh, const float* vh,
                                           const float* ph, const float* brow, int k0,
                                           int u0, int T, int R, int tid) {
  using F = Rel<D, RW, KW>;
  constexpr int BQ = F::BQ, BK = F::BK, LD = F::LD, CH = BK / 4;
  async_load<BK, D, LD>(dst, kh, k0, T, tid, F::kThreads);
  async_load<BK, D, LD>(dst + BK * LD, vh, k0, T, tid, F::kThreads);
  async_load<BQ + BK, D, LD>(dst + 2 * BK * LD, ph, u0, R, tid, F::kThreads);
  float* bs = dst + (3 * BK + BQ) * LD;
  for (int i = tid; i < BQ * CH; i += F::kThreads) {
    const int r = i / CH, c = (i % CH) * 4;
    cp_async16(bs + r * F::LDB + c, brow + (size_t)r * T + k0 + c, true);
  }
}

// A [ROWS][LD] tile split in place: hi where x was, lo (bits of an fp32)
// LO floats on, by all `nthreads` threads.
template <int ROWS, int D, int LD, int LO>
__device__ __forceinline__ void split_tile(float* t, int tid, int nthreads) {
  constexpr int CH = D / 4;
  for (int i = tid; i < ROWS * CH; i += nthreads) {
    float* x = t + (i / CH) * LD + (i % CH) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x);
    uint4 hi, lo;
    split(v.x, hi.x, lo.x);
    split(v.y, hi.y, lo.y);
    split(v.z, hi.z, lo.z);
    split(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(x) = hi;
    *reinterpret_cast<uint4*>(x + LO) = lo;
  }
}

// load_a's fragment (rows m0.., depth k0..) of a tile split_tile split: hi
// at t, lo LO floats on.
template <int LO>
__device__ __forceinline__ void load_a_split(const float* t, int ld, int m0, int k0, int g,
                                             int q, uint32_t hi[4], uint32_t lo[4]) {
  const int at[4] = {(m0 + g) * ld + k0 + q, (m0 + g + 8) * ld + k0 + q,
                     (m0 + g) * ld + k0 + q + 4, (m0 + g + 8) * ld + k0 + q + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = __float_as_uint(t[at[i]]);
    lo[i] = __float_as_uint(t[at[i] + LO]);
  }
}

template <int D, int RW, int KW>
__global__ void __launch_bounds__(Rel<D, RW, KW>::kThreads)
relpos_attention_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
                        const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ p, const float* __restrict__ bias,
                        float* __restrict__ out, const long long* __restrict__ seed,
                        float rate, uint32_t thr, float* __restrict__ stats, int B, int H,
                        int T, int R, int bias_heads, float scale) {
  using F = Rel<D, RW, KW>;
  constexpr int BQ = F::BQ, BK = F::BK, LD = F::LD, LDB = F::LDB, LDW = F::LDW;
  constexpr int NT = F::NT, NB = F::NB, NO = F::NO;
  constexpr int kUnroll = NO <= 8 ? NO : 2;  // k-steps of the score loop unrolled
  extern __shared__ __align__(16) float smem[];
  float* qus = smem;                // q_u: hi [BQ][LD], then lo [BQ][LD]
  float* qvs = qus + 2 * BQ * LD;   // q_v likewise
  float* ring = qvs + 2 * BQ * LD;  // [K, V, table window, bias tile]
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, lq = tid % 4;
  const int wr = w % RW, wk = w / RW;  // the warp's row group and key slice
  float* band = ring + F::kStage + w * 16 * LDW;  // this warp's [16][LDW]

  const int bh = blockIdx.x % (B * H), qt = (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const size_t head = (size_t)bh * T * D;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* ph = p + (size_t)h * R * D;
  const int q0 = qt * BQ, rw = 16 * wr;  // the warp's rows: q0 + rw .. + 16
  const int row0 = q0 + rw + g;          // this lane's rows: row0, row0 + 8
  const int kc = KS * wk;                // the warp's keys of a tile: k0 + kc .. + KS
  const int wb = BQ - 16 - rw + kc;      // the warp's first window row
  const float* brow =
      bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) * T * T + (size_t)q0 * T;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  async_load<BQ, D, LD>(qus, qu + head, q0, T, tid, F::kThreads);
  async_load<BQ, D, LD>(qvs, qv + head, q0, T, tid, F::kThreads);
  cp_commit();
  // window row 0 of key tile k0 is table row T-1 - (q0 + BQ-1) + k0, in [0, 2T-2]
  stage_keys<D, RW, KW>(ring, kh, vh, ph, brow, 0, T - q0 - BQ, T, R, tid);
  cp_commit();
  // q_u and q_v split once, while the first tile lands (the loop's barrier
  // orders these stores before the fragments' reads)
  cp_wait<1>();
  __syncthreads();
  split_tile<BQ, D, LD, BQ * LD>(qus, tid, F::kThreads);
  split_tile<BQ, D, LD, BQ * LD>(qvs, tid, F::kThreads);

  const float* ks = ring;
  const float* vs = ks + BK * LD;
  const float* pw = vs + BK * LD;
  const float* bs = pw + (BQ + BK) * LD;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero<NO>(acc);
  for (int k0 = 0; k0 < T; k0 += BK) {
    cp_wait<0>();
    __syncthreads();

    // s = q_u Kᵀ over the warp's [16, KS] part of the tile, and its band
    // q_v Pwᵀ over window rows wb .. wb + KS + 16
    float s[NT][4], wf[NB][4];
    zero<NT>(s);
    zero<NB>(wf);
#pragma unroll kUnroll
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t uh[4], ul[4], vh4[4], vl4[4];
      load_a_split<BQ * LD>(qus, LD, rw, kk, g, lq, uh, ul);
      load_a_split<BQ * LD>(qvs, LD, rw, kk, g, lq, vh4, vl4);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t fh[2], fl[2];
        load_b<true>(ks, LD, kk, kc + 8 * n, g, lq, fh, fl);
        mma3(s[n], uh, ul, fh, fl);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t fh[2], fl[2];
        load_b<true>(pw, LD, kk, wb + 8 * n, g, lq, fh, fl);
        mma3(wf[n], vh4, vl4, fh, fl);
      }
    }
    // the band to the warp's tile; (a', c') reads it back at column 15 - a' + c'
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(band + (g + 8 * i) * LDW + 8 * n + 2 * lq) =
            make_float2(wf[n][2 * i], wf[n][2 * i + 1]);
    __syncwarp();

    // (ac + bd) * scale + bias, in the forward's order; the tile's row max
    // over the 4 lanes of a row
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = g + 8 * (e >> 1), c = 8 * n + 2 * lq + (e & 1);
        const float x = (s[n][e] + band[a * LDW + 15 - a + c]) * scale +
                        bs[(rw + a) * LDB + kc + c];
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = expf(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
    }
    // p = exp(x - max); the sum takes p, the V accumulation p * kf (the
    // lane's Philox row recomputed a tile: registers are short)
    const dropout::Row dr = drop ? keep_lane(sd, b, h, row0, lq) : dropout::Row{};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint32_t kb = drop ? keep_slab(dr, k0 + kc + 8 * n, lq, thr) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += pr;
        s[n][e] = drop ? keep_apply(kb, e, pr, inv_keep) : pr;
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

    // o += p V: A's column q is key 2q of the slab, column q + 4 key 2q + 1
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ah[4], al[4];
      split(s[n][0], ah[0], al[0]);
      split(s[n][2], ah[1], al[1]);
      split(s[n][1], ah[2], al[2]);
      split(s[n][3], ah[3], al[3]);
      const float* vr = vs + (kc + 8 * n + 2 * lq) * LD + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t bh_[2], bl_[2];
        split(vr[8 * j], bh_[0], bl_[0]);
        split(vr[LD + 8 * j], bh_[1], bl_[1]);
        mma3(acc[j], ah, al, bh_, bl_);
      }
    }
    __syncthreads();  // the stage and the band tile are rewritten next
    if (k0 + BK < T) {
      stage_keys<D, RW, KW>(ring, kh, vh, ph, brow, k0 + BK, T - q0 - BQ + k0 + BK, T, R, tid);
      cp_commit();
    }
  }

  // the merge: key slices 1.. hand (acc, max, sum) over through the stage (no
  // copy is in flight: the last tile's was waited for); slice 0 rescales
  // each to the rows' overall max and adds them, in slice order
  if constexpr (KW > 1) {
    float* part = ring;                              // [KW-1][RW][16][LD]
    float* ml = ring + (size_t)(KW - 1) * RW * 16 * LD;  // [KW-1][RW][16][2]
    const int slot = ((wk - 1) * RW + wr) * 16;
    if (wk > 0) {
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(part + (size_t)(slot + g + 8 * i) * LD + 8 * j + 2 * lq) =
              make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      if (lq == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ml[(slot + g + 8 * i) * 2] = m[i];
          ml[(slot + g + 8 * i) * 2 + 1] = l[i];
        }
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int s2 = 1; s2 < KW; ++s2) mx = fmaxf(mx, ml[(((s2 - 1) * RW + wr) * 16 + g + 8 * i) * 2]);
      const float f0 = expf(m[i] - mx);
      l[i] *= f0;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * i] *= f0;
        acc[j][2 * i + 1] *= f0;
      }
#pragma unroll
      for (int s2 = 1; s2 < KW; ++s2) {
        const int r = ((s2 - 1) * RW + wr) * 16 + g + 8 * i;
        const float f = expf(ml[r * 2] - mx);
        l[i] += ml[r * 2 + 1] * f;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const float2 o = *reinterpret_cast<const float2*>(part + (size_t)r * LD + 8 * j + 2 * lq);
          acc[j][2 * i] += o.x * f;
          acc[j][2 * i + 1] += o.y * f;
        }
      }
      m[i] = mx;
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / l[i];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(out + head + (size_t)(row0 + 8 * i) * D + 8 * j + 2 * lq) =
          make_float2(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
  if (stats != nullptr && lq == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* st = stats + ((size_t)bh * T + row0 + 8 * i) * 2;
      st[0] = m[i];
      st[1] = inv[i];
    }
}

template <int D, int RW, int KW>
int launch_cut(const float* qu, const float* qv, const float* k, const float* v,
               const float* p, const float* bias, float* out, const long long* seed,
               float rate, float* stats, int B, int H, int T, int R, int bias_heads,
               float scale, cudaStream_t stream) {
  using F = Rel<D, RW, KW>;
  const long long blocks = (long long)(T / F::BQ) * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  static bool raised[kMaxDevices] = {};
  const int err = raise_smem(relpos_attention_kernel<D, RW, KW>, F::kSmem, raised);
  if (err != 0) return err;
  relpos_attention_kernel<D, RW, KW><<<(unsigned)blocks, F::kThreads, F::kSmem, stream>>>(
      qu, qv, k, v, p, bias, out, seed, rate, dropout::threshold(rate), stats, B, H, T, R,
      bias_heads, scale);
  return (int)cudaGetLastError();
}

// The cut <RW, KW> as it fits this head dim; where its key tile does not
// divide T, as many key slices as make a 64-key tile (T is a multiple of 64).
template <int D, int RW0, int KW0>
int launch_fitted(const float* qu, const float* qv, const float* k, const float* v,
                  const float* p, const float* bias, float* out, const long long* seed,
                  float rate, float* stats, int B, int H, int T, int R, int bias_heads,
                  float scale, cudaStream_t stream) {
  constexpr int RW = fit_rw(D, RW0, KW0), KW = fit_kw(D, RW, KW0);
  constexpr int KW64 = KW * KS > 64 ? 64 / KS : KW;
  if (KW != KW64 && T % (KS * KW) != 0)
    return launch_cut<D, RW, KW64>(qu, qv, k, v, p, bias, out, seed, rate, stats, B, H, T,
                                   R, bias_heads, scale, stream);
  return launch_cut<D, RW, KW>(qu, qv, k, v, p, bias, out, seed, rate, stats, B, H, T, R,
                               bias_heads, scale, stream);
}

// The cut: 4 x 4 once the 16-row groups number at least two per SM, 1 x 8,
// whose key slices spread each row group over more warps, below.
template <int D>
int launch(const float* qu, const float* qv, const float* k, const float* v,
           const float* p, const float* bias, float* out, const long long* seed,
           float rate, float* stats, int B, int H, int T, int R, int bias_heads,
           float scale, cudaStream_t stream) {
  // 16-byte cp.async: rows are D or T floats, both multiples of 8, so the bases decide
  if (((uintptr_t)qu | (uintptr_t)qv | (uintptr_t)k | (uintptr_t)v | (uintptr_t)p |
       (uintptr_t)bias) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if constexpr (RELPOS_FWD_CUT_RW > 0)
    return launch_fitted<D, RELPOS_FWD_CUT_RW, RELPOS_FWD_CUT_KW>(
        qu, qv, k, v, p, bias, out, seed, rate, stats, B, H, T, R, bias_heads, scale, stream);
  if ((long long)B * H * (T / 16) >= 2LL * sm_count())
    return launch_fitted<D, 4, 4>(qu, qv, k, v, p, bias, out, seed, rate, stats, B, H, T, R,
                                  bias_heads, scale, stream);
  return launch_fitted<D, 1, 8>(qu, qv, k, v, p, bias, out, seed, rate, stats, B, H, T, R,
                                bias_heads, scale, stream);
}

}  // namespace

// q_u, q_v, k, v, out: [B, H, T, D]; p: [H, R, D] with R >= 2T-1 (row u <->
// relative position T-1-u); bias: [B, bias_heads, T, T] with bias_heads 1 or H;
// all contiguous fp32, the inputs 16-byte aligned. T a multiple of 64; D a
// multiple of 8 from 8 to 256. rate in [0, 1): with rate > 0, seed points at
// one int64 on the device; stats: null, or [B, H, T, 2] fp32 to receive each
// row's max and 1 / sum.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int relpos_attention_f32(const float* qu, const float* qv, const float* k,
                                    const float* v, const float* p, const float* bias,
                                    float* out, const long long* seed, float* stats,
                                    int B, int H, int T, int D, int R, int bias_heads,
                                    float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0 || R < 2 * T - 1 ||
      !(bias_heads == 1 || bias_heads == H) || !(rate >= 0.f && rate < 1.f) ||
      (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d)                                                                         \
  case d:                                                                               \
    return launch<d>(qu, qv, k, v, p, bias, out, seed, rate, stats, B, H, T, R, \
                     bias_heads, scale, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
