// Causal self-attention with a key-validity bias, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `masked_attention` / `_causal_kernel` in
// streamspeech_tpu/ops/pallas_attention.py (the unit decoder's causal
// self-attention inside synthesize_units). It computes, for every (b, h, i):
//
//   out[b,h,i] = sum_j softmax_j( q_i . k_j * scale + kvb[b,j]
//                                 + (j <= i ? 0 : -1e9) ) * v_j
//
// The TPU kernel keeps a whole K/V row in VMEM; at T = 3200, D = 64 that row
// is 1.6 MB per (b, h), far above the 227 KB of shared memory an H100 block
// may use. So the design is the online-softmax (flash-attention) form: one
// block of 4 warps per (64-query tile, h, b), each warp owning 16 query rows
// across the whole key tile (its row max and sum are reduced over the 4 lanes
// of a row, no shared memory), a running max, sum and [16, D] accumulator in
// registers, no [T, T] tensor written. Key tiles wholly above the diagonal are
// skipped, which halves the work and is exact: exp(-1e9 - m) is 0 in fp32
// once a row has one allowed key, and key 0 (the EOS prefix row) is always
// valid on the serving and training paths. Blocks are numbered with the query
// tile slowest and the last tiles (the longest walks of the triangle) first.
//
// What bounds it: operations (10.5 GFLOP against 26 MB at [1,8,3200,64]).
// Both products, s = q Kᵀ and o += p V, run on the tensor cores as m16n8k8
// TF32 `mma.sync` in 3xTF32 (tc_mma.cuh: each operand split hi + lo, three
// products into a zeroed accumulator added in fp32), fp32-faithful: one TF32
// product is 6e-4 of max|ref| off, the serving path is held to 1e-5.
//  - q is split once per block: into registers up to D = 64 (2 D registers),
//    into shared memory as hi and lo tiles above that.
//  - p goes from the accumulator to the A operand of p V in registers, with
//    no shuffle and no shared memory: the accumulator's lane (g, q) holds
//    keys 2q and 2q + 1 of each 8-key slab, the A operand wants columns q and
//    q + 4, so A's column q is taken to be key 2q and column q + 4 key 2q + 1,
//    and V's fragment rows are read in that same order (the contraction over
//    the 8 keys does not depend on their order).
//  - K, V and the key bias stream through a two-stage ring filled by 16-byte
//    `cp.async`, the next tile's loads under this tile's products. Rows are
//    D + 4 floats: K read by rows (g, q) and V by rows (2q, 2q + 1) both hit
//    32 banks.
// `mma.sync` and not `wgmma`: TF32 `wgmma` reads its operands K-major only,
// and V in p V is not K-major unless it is transposed while it is staged.
//
// Head dims: every multiple of 8 from 8 to 256, the TPU route's gate
// (head_dim % 8 == 0); key tiles of 64 rows up to D = 144, 32 up to 248 and
// 16 at 256 (the shared-memory limit). Any other D is refused.
//
// Training adds two options (`_causal_kernel` :414-417 and the backward's
// residual). rate > 0 drops attention probabilities after the softmax: the
// keep bits of dropout.cuh, drawn on the score fragments (tc_mma.cuh
// keep_slab) beside the exponentials, scale each tile's un-normalised weights in
// the V accumulation only, never in the running sum. stats != null writes
// each row's max and 1 / sum, [B, H, T, 2], which masked_attention_bwd.cu
// reads instead of recomputing whole rows. (Two numbers, not one
// log-sum-exp: a wholly masked row sits at -1e9, where fp32 cannot carry
// log(sum).)

#include <math.h>

#include "tc_mma.cuh"

namespace {

using namespace tc;

constexpr int kBQ = 64;                   // query rows per block
constexpr int kWarps = kBQ / 16;          // one warp per 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e9f;

// The tiles of one head dim: rows of LD = D + 4 floats; q split into hi and
// lo tiles (above D = 64); two ring stages of K, V ([BK][LD] each) and the
// key bias ([BK]); BK the largest of 64, 32, 16 that fits.
template <int D>
struct Fwd {
  static constexpr int LD = D + 4;
  static constexpr bool kQInRegisters = D <= 64;
  static constexpr size_t kQFloats = kQInRegisters ? 0 : (size_t)2 * kBQ * LD;
  static constexpr size_t floats(int bk) { return kQFloats + 2 * ((size_t)2 * bk * LD + bk); }
  static constexpr int BK = floats(64) * 4 <= kMaxSmem   ? 64
                            : floats(32) * 4 <= kMaxSmem ? 32
                                                         : 16;
  static constexpr size_t kStage = (size_t)2 * BK * LD + BK;  // floats of one ring stage
  static constexpr size_t kSmem = floats(BK) * 4;
  static constexpr int NT = BK / 8;  // 8-key slabs of a key tile
  static constexpr int NO = D / 8;   // 8-channel slabs of the output
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  static_assert(kSmem <= kMaxSmem, "tiles do not fit shared memory");
};

// Keys [k0, k0 + BK) of K, V and the key bias into one ring stage.
template <int D>
__device__ __forceinline__ void stage_keys(float* dst, const float* kh, const float* vh,
                                           const float* kb, int k0, int T, int tid) {
  using F = Fwd<D>;
  async_load<F::BK, D, F::LD>(dst, kh, k0, T, tid, kThreads);
  async_load<F::BK, D, F::LD>(dst + F::BK * F::LD, vh, k0, T, tid, kThreads);
  for (int i = tid; i < F::BK / 4; i += kThreads)
    cp_async16(dst + 2 * F::BK * F::LD + 4 * i, kb + k0 + 4 * i, true);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
causal_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ kvb,
                        float* __restrict__ out, const long long* __restrict__ seed,
                        float rate, uint32_t thr, float* __restrict__ stats, int B, int H,
                        int T, float scale) {
  using F = Fwd<D>;
  constexpr int LD = F::LD, BK = F::BK, NT = F::NT, NO = F::NO;
  constexpr int kUnrollQ = F::kQInRegisters ? NO : 4;  // in full while q is in registers
  extern __shared__ __align__(16) float smem[];
  uint32_t* qhi = reinterpret_cast<uint32_t*>(smem);  // [kBQ][LD], above D = 64
  uint32_t* qlo = qhi + kBQ * LD;
  float* ring = smem + F::kQFloats;                    // [2][K, V, key bias]

  const int nq = T / kBQ;
  const int bh = blockIdx.x % (B * H), qt = nq - 1 - (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, lq = tid % 4;
  const size_t head = (size_t)bh * T * D;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* kb = kvb + (size_t)b * T;
  const int q0 = qt * kBQ, rw = 16 * w;  // this warp's rows: q0 + rw .. + 16
  const int row0 = q0 + rw + g;          // this lane's rows: row0, row0 + 8
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  const bool serial_drop = D > kDropoutCopyMaxD && drop;  // no copy for dropout
  const int kend = q0 + kBQ;  // key tiles past the diagonal weigh 0

  stage_keys<D>(ring, kh, vh, kb, 0, T, tid);
  cp_commit();

  // q, split once: the A fragments of the warp's rows, or the block's tiles
  uint32_t qa[F::kQInRegisters ? NO : 1][2][4];
  if constexpr (F::kQInRegisters) {
#pragma unroll
    for (int kk = 0; kk < NO; ++kk)
      load_a<false>(qh, D, q0 + rw, 8 * kk, g, lq, qa[kk][0], qa[kk][1]);
  } else {
    for (int i = tid; i < kBQ * D / 4; i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(qh + (size_t)(q0 + r) * D + c);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(xs[e], qhi[r * LD + c + e], qlo[r * LD + c + e]);
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero<NO>(acc);
  for (int k0 = 0, it = 0; k0 < kend; k0 += BK, ++it) {
    const float* ks = ring + (it & 1) * F::kStage;
    const float* vs = ks + BK * LD;
    const float* bs = vs + BK * LD;
    if (k0 + BK < kend) stage_keys<D>(ring + ((it + 1) & 1) * F::kStage, kh, vh, kb, k0 + BK,
                                      T, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // s = q Kᵀ over the warp's [16, BK] part of the tile, then the weights of
    // p V; kDraw: the copy for dropout (tc_mma.cuh with_draws)
    float s[NT][4], alpha[2];
    auto weights = [&](auto draw) {
      constexpr bool kDraw = decltype(draw)::value;
      zero<NT>(s);
#pragma unroll kUnrollQ
      for (int kk = 0; kk < NO; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (F::kQInRegisters) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qa[kk][0][e];
            al[e] = qa[kk][1][e];
          }
        } else {
          const int a0 = (rw + g) * LD + 8 * kk + lq;
          const int offs[4] = {a0, a0 + 8 * LD, a0 + 4, a0 + 8 * LD + 4};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qhi[offs[e]];
            al[e] = qlo[offs[e]];
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh_[2], bl_[2];
          load_b<true>(ks, LD, 8 * kk, 8 * n, g, lq, bh_, bl_);
          mma3(s[n], ah, al, bh_, bl_);
        }
      }

      // scale, key bias and causal mask in the forward's order; the tile's
      // row max over the 4 lanes of a row
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * lq + (e & 1);
          float x = s[n][e] * scale + bs[c];
          if (k0 + c > row0 + 8 * (e >> 1)) x += kNegInf;
          s[n][e] = x;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
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
      const bool dropped = kDraw || serial_drop;
      const dropout::Row dr = dropped ? keep_lane(sd, b, h, row0, lq) : dropout::Row{};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t kb = dropped ? keep_slab(dr, k0 + 8 * n, lq, thr) : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e >> 1]);
          sum[e >> 1] += p;
          s[n][e] = dropped ? keep_apply(kb, e, p, inv_keep) : p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
    };
    with_draws<D>(drop, weights);
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
      const float* vr = vs + (8 * n + 2 * lq) * LD + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t bh_[2], bl_[2];
        split(vr[8 * j], bh_[0], bl_[0]);
        split(vr[LD + 8 * j], bh_[1], bl_[1]);
        mma3(acc[j], ah, al, bh_, bl_);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
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

template <int D>
int launch(const float* q, const float* k, const float* v, const float* kvb,
           float* out, const long long* seed, float rate, float* stats, int B, int H,
           int T, float scale, cudaStream_t stream) {
  using F = Fwd<D>;
  // 16-byte cp.async and float4 loads: rows are D floats, D a multiple of 8,
  // T a multiple of 64, so the bases decide
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)kvb) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (long long)(T / kBQ) * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  static bool raised[kMaxDevices] = {};
  const int err = raise_smem(causal_attention_kernel<D>, F::kSmem, raised);
  if (err != 0) return err;
  causal_attention_kernel<D><<<(unsigned)blocks, kThreads, F::kSmem, stream>>>(
      q, k, v, kvb, out, seed, rate, dropout::threshold(rate), stats, B, H, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, H, T, D] contiguous fp32; kvb: [B, T] fp32 additive key
// bias (0 valid, -1e9 masked); all 16-byte aligned. T must be a multiple of
// 64; D a multiple of 8 from 8 to 256. rate in [0, 1): with rate > 0, seed
// points at one int64 on the device; stats: null, or [B, H, T, 2] fp32 to
// receive each row's max and 1 / sum. Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int masked_attention_f32(const float* q, const float* k,
                                    const float* v, const float* kvb,
                                    float* out, const long long* seed, float* stats,
                                    int B, int H, int T, int D, float scale,
                                    float rate, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % kBQ != 0 || !(rate >= 0.f && rate < 1.f) ||
      (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d) \
  case d: return launch<d>(q, k, v, kvb, out, seed, rate, stats, B, H, T, scale, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
