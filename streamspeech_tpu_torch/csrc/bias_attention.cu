// Attention under an arbitrary additive bias, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `bias_attention` / `_bias_kernel` in
// streamspeech_tpu/ops/pallas_attention.py (the unit decoder's wait-k
// cross-attention and any no-cache attention whose mask is per query, at
// S >= 512). For q [B, H, TQ, D], k/v [B, H, TK, D] and bias [B, TQ, TK]:
//
//   out[b,h,i] = sum_j softmax_j( q_i . k_j * scale + bias[b,i,j] ) * v_j
//
// The bias carries the whole mask (streaming mask, key validity); the kernel
// adds no structure of its own and masks its own ragged edges (queries past
// TQ are not written, keys past TK weigh 0 by -inf), so TQ and TK need no
// padding; the TPU pads TK = 24 to 128.
//
// What bounds it: bytes. At the unit decoder's train shape [8,8,1200×48,64]
// the kernel moves ~43 MB (q and out 19.7 MB each), 0.0129 ms at 3.35 TB/s,
// against 0.0057 ms for its 0.94 GFLOP as 3xTF32 on the tensor cores. So:
//  - Both products, s = q Kᵀ and o += p V, run as m16n8k8 TF32 `mma.sync` in
//    3xTF32 (tc_mma.cuh's mma3), as masked_attention.cu: one warp per 16
//    query rows, the online softmax's max and sum reduced over the 4 lanes of
//    a row, p handed from the accumulator to the A operand of p V in
//    registers (V's fragment rows read in the accumulator's key order). q is
//    split once a block while TK <= 64: its fragments are loaded once a
//    k-step for all the tile's key slabs.
//  - Key tiles are TK rounded up to 8 keys: one tile while TK <= 64 (the
//    48 or 24 of the unit decoder), a loop of 64-key tiles (32 or 16 at the
//    widest head dims) only past it; within a tile, only the 8-key slabs
//    that hold a key are multiplied. The ring has a second stage only when
//    there is a second tile, and the block's shared memory is sized to the
//    tile it runs, so small TK leaves room for many blocks an SM.
//  - q comes in by 16-byte `cp.async`, K and V likewise; the bias rows
//    [BQ, TK] by 16-byte `cp.async` when TK % 4 == 0, else by 4-byte copies
//    (rows of TK = 30 floats are not 16-byte aligned).
//  - out is staged through the q tile and stored 16 bytes a lane.
//  - Query tiles of kBQ rows (BIAS_FWD_BQ, 64 as built: 4 warps; 80 blocks at
//    [1,8,600×24,64], 0.0075 ms there against 0.0077 for 32-row tiles' 152,
//    and 0.0564 against 0.0589 at the train shape;
//    tools/sweep_attention_fwd.py).
// `mma.sync` and not `wgmma`: TF32 `wgmma` reads its operands K-major only,
// and V in p V is not K-major.
//
// Head dims: every multiple of 8 from 8 to 256, as masked_attention.cu.
//
// Training adds dropout (rate > 0, `_bias_kernel` :614-617) and the row
// statistics output (stats != null, [B, H, TQ, 2]: max and 1 / sum), both
// exactly as in masked_attention.cu: the keep bits drawn on the score
// fragments beside the exponentials scale the weights that go into p V only,
// never the running sum; bias_attention_bwd.cu reads the statistics.

#include <math.h>

#include "tc_mma.cuh"

#ifndef BIAS_FWD_BQ
#define BIAS_FWD_BQ 64  // query rows per block, 16 a warp: 16, 32 or 64
#endif

namespace {

using namespace tc;

constexpr int kBQ = BIAS_FWD_BQ;
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;
static_assert(kBQ == 16 || kBQ == 32 || kBQ == 64, "BIAS_FWD_BQ must be 16, 32 or 64");

// The bias tile's row stride for a tile of bk keys: >= bk, 8 mod 16, so a
// quad's rows hit 32 banks.
__host__ __device__ constexpr int bias_ld(int bk) { return (bk + 7) / 16 * 16 + 8; }

// The tiles of one head dim: rows of LD = D + 4 floats; q [kBQ][LD]; ring
// stages of K, V ([bk][LD] each) and the bias tile ([kBQ][bias_ld(bk)]); BK,
// the most keys a tile, the largest of 64, 32, 16 whose two stages fit.
template <int D>
struct Fwd {
  static constexpr int LD = D + 4;
  static constexpr int NO = D / 8;
  __host__ __device__ static constexpr size_t stage(int bk) {
    return (size_t)2 * bk * LD + (size_t)kBQ * bias_ld(bk);
  }
  static constexpr size_t floats(int bk, int stages) {
    return (size_t)kBQ * LD + stages * stage(bk);
  }
  static constexpr int BK = floats(64, 2) * 4 <= kMaxSmem   ? 64
                            : floats(32, 2) * 4 <= kMaxSmem ? 32
                                                            : 16;
  static constexpr int NT = BK / 8;
  static constexpr size_t kSmemMax = floats(BK, 2) * 4;
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  static_assert(kSmemMax <= kMaxSmem, "tiles do not fit shared memory");
};

// Keys [k0, k0 + bk) of K and V (zeros past TK) and the bias tile of the
// block's rows q0.. and columns k0.. (zeros outside [TQ, TK]) into one stage.
template <int D>
__device__ __forceinline__ void stage_keys(float* dst, const float* kh, const float* vh,
                                           const float* bb, int k0, int bk, int q0, int TQ,
                                           int TK, bool vec_bias, int tid) {
  constexpr int LD = Fwd<D>::LD, CH = D / 4;
  for (int i = tid; i < bk * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool in = k0 + r < TK;
    const size_t at = (size_t)(k0 + r) * D + c;
    cp_async16(dst + r * LD + c, in ? kh + at : kh, in);
    cp_async16(dst + (bk + r) * LD + c, in ? vh + at : vh, in);
  }
  float* bs = dst + 2 * bk * LD;
  const int ldb = bias_ld(bk);
  if (vec_bias) {  // TK % 4 == 0: a 4-column group is wholly in or out
    const int cg = bk / 4;
    for (int i = tid; i < kBQ * cg; i += kThreads) {
      const int r = i / cg, c = (i % cg) * 4;
      const bool in = q0 + r < TQ && k0 + c < TK;
      cp_async16(bs + r * ldb + c, in ? bb + (size_t)(q0 + r) * TK + k0 + c : bb, in);
    }
  } else {
    for (int i = tid; i < kBQ * bk; i += kThreads) {
      const int r = i / bk, c = i % bk;
      const bool in = q0 + r < TQ && k0 + c < TK;
      cp_async4(bs + r * ldb + c, in ? bb + (size_t)(q0 + r) * TK + k0 + c : bb, in);
    }
  }
}

// bk: keys a tile, TK rounded up to 8 and at most Fwd<D>::BK.
template <int D>
__global__ void __launch_bounds__(kThreads)
bias_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, const long long* __restrict__ seed,
                      float rate, uint32_t thr, float* __restrict__ stats, int B, int H,
                      int TQ, int TK, int bk, float scale) {
  using F = Fwd<D>;
  constexpr int LD = F::LD, NT = F::NT, NO = F::NO;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [kBQ][LD]; out on its way to global memory
  float* ring = qs + kBQ * LD;  // [1 or 2][K, V, bias tile]
  const size_t stage = F::stage(bk);
  const int ldb = bias_ld(bk);

  const int bh = blockIdx.x % (B * H), qt = (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, lq = lane % 4;
  const float* qh = q + (size_t)bh * TQ * D;
  const float* kh = k + (size_t)bh * TK * D;
  const float* vh = v + (size_t)bh * TK * D;
  const float* bb = bias + (size_t)b * TQ * TK;
  const int q0 = qt * kBQ, rw = 16 * w;  // this warp's rows: q0 + rw .. + 16
  const int row0 = q0 + rw + g;          // this lane's rows: row0, row0 + 8
  const bool vec_bias = TK % 4 == 0;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  async_load<kBQ, D, LD>(qs, qh, q0, TQ, tid, kThreads);
  stage_keys<D>(ring, kh, vh, bb, 0, bk, q0, TQ, TK, vec_bias, tid);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero<NO>(acc);
  for (int k0 = 0, it = 0; k0 < TK; k0 += bk, ++it) {
    const float* ks = ring + (it & 1) * stage;
    const float* vs = ks + bk * LD;
    const float* bs = vs + bk * LD;
    if (k0 + bk < TK)
      stage_keys<D>(ring + ((it + 1) & 1) * stage, kh, vh, bb, k0 + bk, bk, q0, TQ, TK,
                    vec_bias, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    // the 8-key slabs of this tile that hold a key (warp-uniform)
    const int ns = min(NT, (TK - k0 + 7) / 8);

    // s = q Kᵀ over the warp's [16, 8 ns] part of the tile
    float s[NT][4];
    zero<NT>(s);
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ah[4], al[4];
      load_a<false>(qs, LD, rw, kk, g, lq, ah, al);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= ns) break;
        uint32_t fh[2], fl[2];
        load_b<true>(ks, LD, kk, 8 * n, g, lq, fh, fl);
        mma3(s[n], ah, al, fh, fl);
      }
    }

    // scale and bias in the forward's order; keys past TK and rows past TQ
    // weigh nothing: -inf, not the -1e9 of the bias. The tile's row max over
    // the 4 lanes of a row
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= ns) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = g + 8 * (e >> 1), c = 8 * n + 2 * lq + (e & 1);
        const float x = row0 + 8 * (e >> 1) < TQ && k0 + c < TK
                            ? s[n][e] * scale + bs[(rw + a) * ldb + c]
                            : -INFINITY;
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      // a row past TQ stays at -inf: keep its arithmetic finite (it is not written)
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use[i]);  // 0 on the first tile
      m[i] = m_new;
    }
    // p = exp(x - max); the sum takes p, the V accumulation p * kf
    const dropout::Row dr = drop ? keep_lane(sd, b, h, row0, lq) : dropout::Row{};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= ns) break;
      const uint32_t kb = drop ? keep_slab(dr, k0 + 8 * n, lq, thr) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(s[n][e] - m_use[e >> 1]);
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

    // o += p V: A's column q is key 2q of the slab, column q + 4 key 2q + 1;
    // V's rows past TK are zeros
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= ns) break;
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

  // out through the warp's own rows of the q tile, 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / l[i];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(qs + (rw + g + 8 * i) * LD + 8 * j + 2 * lq) =
          make_float2(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
  __syncwarp();
  constexpr int CH = D / 4;
  float* oh = out + (size_t)bh * TQ * D;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 4;
    if (q0 + rw + r < TQ)
      *reinterpret_cast<float4*>(oh + (size_t)(q0 + rw + r) * D + c) =
          *reinterpret_cast<const float4*>(qs + (rw + r) * LD + c);
  }
  if (stats != nullptr && lq == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < TQ) {
        float* st = stats + ((size_t)bh * TQ + row0 + 8 * i) * 2;
        st[0] = m[i];
        st[1] = inv[i];
      }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, const long long* seed, float rate, float* stats, int B, int H,
           int TQ, int TK, float scale, cudaStream_t stream) {
  using F = Fwd<D>;
  // 16-byte cp.async and stores: rows of q, k, v and out are D floats, D a
  // multiple of 8, so the bases decide (bias rows go by 4 bytes unless TK % 4 == 0)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0 ||
      (TK % 4 == 0 && (uintptr_t)bias % 16 != 0) || (uintptr_t)bias % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (long long)((TQ + kBQ - 1) / kBQ) * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  static bool raised[kMaxDevices] = {};
  const int err = raise_smem(bias_attention_kernel<D>, F::kSmemMax, raised);
  if (err != 0) return err;
  const int bk8 = (TK + 7) / 8 * 8;
  const int bk = bk8 < F::BK ? bk8 : F::BK;
  const size_t smem = F::floats(bk, TK > bk ? 2 : 1) * 4;
  bias_attention_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, bias, out, seed, rate, dropout::threshold(rate), stats, B, H, TQ, TK, bk,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, H, TQ, D]; k, v: [B, H, TK, D]; bias: [B, TQ, TK]; all contiguous
// fp32, q, k, v and out 16-byte aligned (bias too when TK % 4 == 0). D a
// multiple of 8 from 8 to 256; TQ, TK >= 1. rate in [0, 1): with rate > 0,
// seed points at one int64 on the device; stats: null, or [B, H, TQ, 2] fp32
// to receive each row's max and 1 / sum.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int bias_attention_f32(const float* q, const float* k, const float* v,
                                  const float* bias, float* out, const long long* seed,
                                  float* stats, int B, int H, int TQ, int TK, int D,
                                  float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0 || !(rate >= 0.f && rate < 1.f) ||
      (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d) \
  case d: return launch<d>(q, k, v, bias, out, seed, rate, stats, B, H, TQ, TK, scale, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
