// Backward of the relative-position self-attention, fp32, for Hopper
// (sm_90a): dq_u, dq_v, dK, dV and the table's gradient dP in one pass over
// the scores and one ordered reduction.
//
// Replaces `_relpos_bwd` (its two `pallas_call`s, `_bwd_kernel_a` and
// `_bwd_kernel_p`, and the scatter-add of overlapping windows after them) in
// streamspeech_tpu/ops/pallas_attention.py. For the forward of
// relpos_attention.cu,
//
//   s[i,j] = (q_u[i] . k[j] + q_v[i] . p[T-1-i+j]) * scale + bias[i,j]
//   out[i] = sum_j dropout(softmax_j(s[i,j])) * v[j],
//
// and g = d loss / d out it computes, with kf the keep factors of dropout.cuh,
// delta = rowsum(g * out) and ds = p * (dp * kf - delta) * scale, dp = g Vᵀ,
//
//   dq_u = ds K      dq_v[i] = sum_j ds[i,j] p[T-1-i+j]      dK = dsᵀ q_u
//   dV = (p kf)ᵀ g   dP[h,u] = sum_b sum_{T-1-i+j = u} ds[b,h,i,j] q_v[b,h,i].
//
// One block per (query tile of BT rows, h, b) walks the key tiles once. For
// each it forms, on the tensor cores (3xTF32 `mma.sync`, tc_mma.cuh):
//   s = q_u Kᵀ and dp = g Vᵀ, [BT, BT];
//   the shear as a dense product, as the TPU kernel does: W = q_v Pwᵀ over
//   the 2 BT rows of the table the tile pair touches (window row
//   w = BT-1 - a + c for local query a, key c), [BT, 2 BT], read back on its
//   diagonal band from shared memory;
//   p from the forward's row statistics, ds, and the un-sheared ds: ds
//   scattered into a [BT, 2 BT] band tile Z that is zero off the band;
//   then dq_u += ds K and dq_v += Z Pw in registers; this tile pair's dK = dsᵀ
//   q_u and dV = (p kf)ᵀ g, written once to per-query-tile partials; and the
//   dP window Zᵀ q_v, added into a rolling window of the query tile's table
//   rows held in registers, whose rows are written out once no later key
//   tile reaches them.
// delta = rowsum(g * out) is formed in the block (a warp per row), so there
// is no delta launch. A second kernel adds the dK/dV
// partials over query tiles and the dP windows over query tiles and batch, in
// a fixed order: no atomics, one seed gives the same gradients bit for bit.
// Two launches a call, the scores computed once.
//
// What bounds it: operations at the train shape [8,4,256,64] (eight products,
// 2.15 GFLOP, against 24 MB; the band products add 0.81 GFLOP of multiplies by
// the zeros off the band, and the partials 52 MB of traffic). The keep bits
// are drawn on the score fragments beside the exponentials (tc_mma.cuh
// keep_slab), one Philox call per 4 elements. Tiles of BT = 32 rows up to
// D = 136 (256 blocks at the train shape for 132 SMs, 123 KB of shared memory
// at D = 64), 16 above; 8 warps.
// Head dims: every multiple of 8 from 8 to 256. T a multiple of 64, R >= 2T-1.

#include <math.h>

#include "tc_mma.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

// The tiles of one head dim, BT query rows by BT keys. Shared memory, in
// floats: q_u, q_v and g ([BT][LD], resident); two ring stages of K, V
// ([BT][LD]) and the table window ([2 BT][LD]); W and Z ([BT][LW]); ds and
// p * kf ([BT][LS]); delta, max and 1/sum of the block's rows.
// Warp w owns, in the score phase, rows 16 (w % WR).. of the score and band
// tiles and their 8-column slabs w / WR + WC n; in the product phase the same
// rows of a [BT, D] output and the slabs w / WR + WC j; and in the dP phase
// the row group (slot) w % WRP of the rolling [2 BT, D] window and the slabs
// w / WRP + WCP j.
template <int D>
struct Rel {
  static constexpr int LD = D + 4;
  static constexpr size_t floats(int bt) {
    return (size_t)11 * bt * LD + 2 * bt * (2 * bt + 4) + 2 * bt * (bt + 4) + 3 * bt;
  }
  static constexpr int BT = floats(32) * 4 <= kMaxSmem ? 32 : 16;
  static constexpr int LW = 2 * BT + 4, LS = BT + 4;
  static constexpr size_t kStage = (size_t)4 * BT * LD;  // K, V, 2 BT table rows
  static constexpr size_t kSmem = floats(BT) * 4;
  static constexpr int WR = BT / 16, WC = kWarps / WR;
  static constexpr int WRP = 2 * WR, WCP = kWarps / WRP;
  static constexpr int NS = BT / 8, NTS = (NS + WC - 1) / WC;      // score slabs
  static constexpr int NW = 2 * BT / 8, NTW = (NW + WC - 1) / WC;  // band slabs
  static constexpr int ND = D / 8, NO = (ND + WC - 1) / WC, NOP = (ND + WCP - 1) / WCP;
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  static_assert(kSmem <= kMaxSmem, "tiles do not fit shared memory");
};

// Key tile k0's K and V rows and the 2 BT table rows from u0 into one stage.
template <int D>
__device__ __forceinline__ void stage_keys(float* dst, const float* kh, const float* vh,
                                           const float* ph, int k0, int u0, int T, int R,
                                           int tid) {
  using F = Rel<D>;
  async_load<F::BT, D, F::LD>(dst, kh, k0, T, tid, kThreads);
  async_load<F::BT, D, F::LD>(dst + F::BT * F::LD, vh, k0, T, tid, kThreads);
  async_load<2 * F::BT, D, F::LD>(dst + 2 * F::BT * F::LD, ph, u0, R, tid, kThreads);
}

// part: dK partials [nq][B H][T][D], then dV partials alike, then the dP
// windows [B H][nq][T + BT][D] (window row r of query tile qt is table row
// T - BT - qt BT + r).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
relpos_bwd_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ p, const float* __restrict__ bias,
                  const float* __restrict__ g, const float* __restrict__ out,
                  const float* __restrict__ stats, const long long* __restrict__ seed,
                  float rate, uint32_t thr, float* __restrict__ part, float* __restrict__ dqu,
                  float* __restrict__ dqv, int B, int H, int T, int R, int bias_heads,
                  float scale) {
  using F = Rel<D>;
  constexpr int BT = F::BT, LD = F::LD, LW = F::LW, LS = F::LS;
  constexpr int WR = F::WR, WC = F::WC, WRP = F::WRP, WCP = F::WCP;
  constexpr int NS = F::NS, NTS = F::NTS, NW = F::NW, NTW = F::NTW;
  constexpr int ND = F::ND, NO = F::NO, NOP = F::NOP;
  extern __shared__ __align__(16) float smem[];
  float* qus = smem;
  float* qvs = qus + BT * LD;
  float* gs = qvs + BT * LD;
  float* ring = gs + BT * LD;        // [2][K, V, table window]
  float* wt = ring + 2 * F::kStage;  // W = q_v Pwᵀ, [BT][LW]
  float* zs = wt + BT * LW;          // Z, ds on its band, [BT][LW]
  float* dss = zs + BT * LW;         // ds, [BT][LS]
  float* pks = dss + BT * LS;        // p * kf, [BT][LS]
  float* rows = pks + BT * LS;       // delta, max, 1/sum of the block's rows

  const int nt = T / BT;  // query tiles, and key tiles
  const int bh = blockIdx.x % (B * H), qt = (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, lg = lane / 4, lq = lane % 4;
  const int wr = w % WR, wc = w / WR, wrp = w % WRP, wcp = w / WRP;
  const size_t head = (size_t)bh * T * D;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* ph = p + (size_t)h * R * D;
  const float* bb = bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) * T * T;
  const int q0 = qt * BT;
  const size_t n_kv = (size_t)B * H * T * D;
  float* part_k = part + ((size_t)qt * B * H + bh) * T * D;
  float* part_v = part_k + (size_t)nt * n_kv;
  float* part_p = part + 2 * (size_t)nt * n_kv + ((size_t)bh * nt + qt) * (T + BT) * D;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;
  const bool serial_drop = D > kDropoutCopyMaxD && drop;  // no copy for dropout
  // the lane's Philox row: the block's rows are fixed along its key tiles
  const dropout::Row dr = keep_lane(sd, b, h, q0 + 16 * wr + lg, lq);

  async_load<BT, D, LD>(qus, qu + head, q0, T, tid, kThreads);
  async_load<BT, D, LD>(qvs, qv + head, q0, T, tid, kThreads);
  async_load<BT, D, LD>(gs, g + head, q0, T, tid, kThreads);
  stage_keys<D>(ring, kh, vh, ph, 0, T - q0 - BT, T, R, tid);
  cp_commit();
  for (int r = w; r < BT; r += kWarps) {  // delta = rowsum(g * out), a warp a row
    const size_t row = (size_t)bh * T + q0 + r;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += g[row * D + d] * out[row * D + d];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      rows[r] = sum;
      rows[BT + r] = stats[row * 2];
      rows[2 * BT + r] = stats[row * 2 + 1];
    }
  }
  for (int i = tid; i < BT * LW; i += kThreads) zs[i] = 0.f;  // off the band for good
  __syncthreads();
  float dl[2], mx[2], il[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int a = 16 * wr + lg + 8 * i;
    dl[i] = rows[a];
    mx[i] = rows[BT + a];
    il[i] = rows[2 * BT + a];
  }

  float au[NO][4], av[NO][4], ap[NOP][4];
  zero<NO>(au);
  zero<NO>(av);
  zero<NOP>(ap);
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * BT;
    const float* ks = ring + (kt & 1) * F::kStage;
    const float* vs = ks + BT * LD;
    const float* pw = vs + BT * LD;
    if (kt + 1 < nt)
      stage_keys<D>(ring + ((kt + 1) & 1) * F::kStage, kh, vh, ph, k0 + BT,
                    T - q0 - BT + k0 + BT, T, R, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // s = q_u Kᵀ, dp = g Vᵀ and the band product W = q_v Pwᵀ, over D; then p
    // and ds; kDraw: the copy for dropout (tc_mma.cuh with_draws)
    auto tile = [&](auto draw) {
      constexpr bool kDraw = decltype(draw)::value;
      float s[NTS][4], dp[NTS][4], wf[NTW][4];
      zero<NTS>(s);
      zero<NTS>(dp);
      zero<NTW>(wf);
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        uint32_t uh[4], ul[4], gh[4], gl[4], vh4[4], vl4[4];
        load_a<false>(qus, LD, 16 * wr, kk, lg, lq, uh, ul);
        load_a<false>(gs, LD, 16 * wr, kk, lg, lq, gh, gl);
        load_a<false>(qvs, LD, 16 * wr, kk, lg, lq, vh4, vl4);
#pragma unroll
        for (int n = 0; n < NTS; ++n) {
          const int slab = wc + WC * n;
          if (NS % WC != 0 && slab >= NS) break;
          uint32_t fh[2], fl[2];
          load_b<true>(ks, LD, kk, 8 * slab, lg, lq, fh, fl);
          mma3(s[n], uh, ul, fh, fl);
          load_b<true>(vs, LD, kk, 8 * slab, lg, lq, fh, fl);
          mma3(dp[n], gh, gl, fh, fl);
        }
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int slab = wc + WC * n;
          if (NW % WC != 0 && slab >= NW) break;
          uint32_t fh[2], fl[2];
          load_b<true>(pw, LD, kk, 8 * slab, lg, lq, fh, fl);
          mma3(wf[n], vh4, vl4, fh, fl);
        }
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int slab = wc + WC * n;
        if (NW % WC != 0 && slab >= NW) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wt[(16 * wr + lg + 8 * (e >> 1)) * LW + 8 * slab + 2 * lq + (e & 1)] = wf[n][e];
      }
      __syncthreads();

      // the sheared term from W's band; p, ds; ds and p * kf into their
      // tiles, ds also onto Z's band
      const bool dropped = kDraw || serial_drop;
#pragma unroll
      for (int n = 0; n < NTS; ++n) {
        const int slab = wc + WC * n;
        if (NS % WC != 0 && slab >= NS) break;
        const uint32_t kb = dropped ? keep_slab(dr, k0 + 8 * slab, lq, thr) : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = 16 * wr + lg + 8 * (e >> 1), c = 8 * slab + 2 * lq + (e & 1);
          const int band = (BT - 1) - a + c;
          const float x = (s[n][e] + wt[a * LW + band]) * scale +
                          bb[(size_t)(q0 + a) * T + k0 + c];
          const float pr = expf(x - mx[e >> 1]) * il[e >> 1];
          const float dpk = dropped ? keep_apply(kb, e, dp[n][e], inv_keep) : dp[n][e];
          const float ds = pr * (dpk - dl[e >> 1]) * scale;
          dss[a * LS + c] = ds;
          pks[a * LS + c] = dropped ? keep_apply(kb, e, pr, inv_keep) : pr;
          zs[a * LW + band] = ds;
        }
      }
    };
    with_draws<D>(drop, tile);
    __syncthreads();

    // dq_u += ds K, dq_v += Z Pw
    product<BT, NO, WC, ND, false>(au, dss, LS, 16 * wr, ks, LD, wc, lg, lq);
    product<2 * BT, NO, WC, ND, false>(av, zs, LW, 16 * wr, pw, LD, wc, lg, lq);
    // this tile pair's dK = dsᵀ q_u and dV = (p kf)ᵀ g
    {
      float ak[NO][4], avv[NO][4];
      zero<NO>(ak);
      zero<NO>(avv);
      product<BT, NO, WC, ND, true>(ak, dss, LS, 16 * wr, qus, LD, wc, lg, lq);
      product<BT, NO, WC, ND, true>(avv, pks, LS, 16 * wr, gs, LD, wc, lg, lq);
      store_frags<D, NO, WC>(part_k, ak, k0 + 16 * wr, T, wc, lg, lq);
      store_frags<D, NO, WC>(part_v, avv, k0 + 16 * wr, T, wc, lg, lq);
    }
    // dP: the slot's window rows += Zᵀ q_v; a slot whose rows no later key
    // tile reaches is written out and starts over
    const int sp = ((wrp - kt * WR) % WRP + WRP) % WRP;  // its window row group
    product<BT, NOP, WCP, ND, true>(ap, zs, LW, 16 * sp, qvs, LD, wcp, lg, lq);
    if (sp < WR) {
      store_frags<D, NOP, WCP>(part_p, ap, 16 * (kt * WR + sp), T + BT, wcp, lg, lq);
      zero<NOP>(ap);
    }
    __syncthreads();  // the tiles above and this stage are rewritten next
  }
  const int sp = ((wrp - (nt - 1) * WR) % WRP + WRP) % WRP;
  if (sp >= WR)
    store_frags<D, NOP, WCP>(part_p, ap, 16 * ((nt - 1) * WR + sp), T + BT, wcp, lg, lq);
  store_frags<D, NO, WC>(dqu + head, au, q0 + 16 * wr, T, wc, lg, lq);
  store_frags<D, NO, WC>(dqv + head, av, q0 + 16 * wr, T, wc, lg, lq);
}

// dK = sum_qt part_k[qt], dV likewise, and dP[h, u] = sum_b sum_qt of the
// windows that hold table row u (row u - (T - BT - qt BT) of window qt), in
// that fixed order; table rows no window holds (u >= 2T - 1) get 0.
__global__ void __launch_bounds__(kThreads)
relpos_reduce_kernel(const float* __restrict__ part, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dp, int B, int H, int T,
                     int R, int D, int BT) {
  const int nq = T / BT;
  const long long n_kv = (long long)B * H * T * D, n_p = (long long)H * R * D;
  const float* part_p = part + 2 * nq * n_kv;
  // the dP rows first: each adds B * nq windows, the longest walks
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n_p + 2 * n_kv;
       i += (long long)gridDim.x * kThreads) {
    if (i < n_p) {
      const int h = (int)(i / ((long long)R * D)), u = (int)(i / D % R), d = (int)(i % D);
      float sum = 0.f;
      for (int b = 0; b < B; ++b) {
        const float* win = part_p + (long long)(b * H + h) * nq * (T + BT) * D + d;
#pragma unroll 4
        for (int qt = 0; qt < nq; ++qt) {
          const int r = u - (T - BT - qt * BT);  // 0 where window qt misses row u
          sum += r >= 0 && r < T + BT ? win[((long long)qt * (T + BT) + r) * D] : 0.f;
        }
      }
      dp[i] = sum;
    } else {
      const long long j = i - n_p;
      const bool is_v = j >= n_kv;
      const long long e = is_v ? j - n_kv : j;
      const float* src = part + (is_v ? nq * n_kv : 0) + e;
      float sum = src[0];
      for (int qt = 1; qt < nq; ++qt) sum += src[qt * n_kv];
      (is_v ? dv : dk)[e] = sum;
    }
  }
}

template <int D>
long long scratch_floats(int B, int H, int T) {
  constexpr int BT = Rel<D>::BT;
  const long long nq = T / BT;
  return nq * B * H * ((long long)2 * T + T + BT) * D;
}

template <int D>
int launch(const float* qu, const float* qv, const float* k, const float* v,
           const float* p, const float* bias, const float* g, const float* out,
           const float* stats, const long long* seed, float* part, float* dqu, float* dqv,
           float* dk, float* dv, float* dp, int B, int H, int T, int R, int bias_heads,
           float scale, float rate, cudaStream_t stream) {
  using F = Rel<D>;
  // 16-byte cp.async: rows are D floats, D a multiple of 8, so the bases decide
  if (((uintptr_t)qu | (uintptr_t)qv | (uintptr_t)k | (uintptr_t)v | (uintptr_t)p |
       (uintptr_t)g) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (long long)(T / F::BT) * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  static bool raised[kMaxDevices] = {};
  int err = raise_smem(relpos_bwd_kernel<D>, F::kSmem, raised);
  if (err != 0) return err;
  relpos_bwd_kernel<D><<<(unsigned)blocks, kThreads, F::kSmem, stream>>>(
      qu, qv, k, v, p, bias, g, out, stats, seed, rate, dropout::threshold(rate), part, dqu,
      dqv, B, H, T, R, bias_heads, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long n = (long long)B * H * T * D * 2 + (long long)H * R * D;
  const long long rblocks = (n + kThreads - 1) / kThreads;
  relpos_reduce_kernel<<<(unsigned)(rblocks < 8192 ? rblocks : 8192), kThreads, 0, stream>>>(
      part, dk, dv, dp, B, H, T, R, D, F::BT);
  return (int)cudaGetLastError();
}

}  // namespace

// The fp32 scratch relpos_attention_bwd_f32 takes at this shape, in floats;
// -1 for a head dim it does not take or a count past 2^31 - 1.
extern "C" int relpos_attention_bwd_scratch(int B, int H, int T, int D) {
  long long n = -1;
#define CASE(d) \
  case d: n = scratch_floats<d>(B, H, T); break;
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: break;
  }
#undef CASE
  return n > 2147483647LL ? -1 : (int)n;
}

// q_u, q_v, k, v, g, out, dq_u, dq_v, dk, dv: [B, H, T, D]; p, dp: [H, R, D]
// with R >= 2T-1; bias: [B, bias_heads, T, T] with bias_heads 1 or H; stats:
// [B, H, T, 2] (the forward's row max and 1 / sum); seed: one int64 on the
// device, read when rate > 0; part: relpos_attention_bwd_scratch floats; all
// fp32 and contiguous, q_u, q_v, k, v, p and g 16-byte aligned. T a multiple
// of 64; D a multiple of 8 from 8 to 256.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int relpos_attention_bwd_f32(const float* qu, const float* qv, const float* k,
                                        const float* v, const float* p, const float* bias,
                                        const float* g, const float* out,
                                        const float* stats, const long long* seed,
                                        float* part, float* dqu, float* dqv, float* dk,
                                        float* dv, float* dp, int B, int H, int T, int D,
                                        int R, int bias_heads, float scale, float rate,
                                        void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0 || R < 2 * T - 1 ||
      !(bias_heads == 1 || bias_heads == H) || !(rate >= 0.f && rate < 1.f) ||
      (rate > 0.f && seed == nullptr) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d)                                                                          \
  case d:                                                                                \
    return launch<d>(qu, qv, k, v, p, bias, g, out, stats, seed, part, dqu, dqv, dk, dv, \
                     dp, B, H, T, R, bias_heads, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
