// Backward of the relative-position self-attention, fp32, for Hopper
// (sm_90a): dq_u, dq_v, dK and dV. The table's gradient dP is
// relpos_attention_dp.cu.
//
// Replaces `_bwd_kernel_a` (the first `pallas_call` of `_relpos_bwd`) in
// streamspeech_tpu/ops/pallas_attention.py. For the forward of
// relpos_attention.cu,
//
//   s[i,j] = (q_u[i] . k[j] + q_v[i] . p[T-1-i+j]) * scale + bias[i,j]
//   out[i] = sum_j dropout(softmax_j(s[i,j])) * v[j],
//
// and g = d loss / d out it computes, with ds = p * (dp - delta) * scale as
// in attention_bwd.cuh,
//
//   dq_u[i] = sum_j ds[i,j] k[j]          dq_v[i] = sum_j ds[i,j] p[T-1-i+j]
//   dK[j]   = sum_i ds[i,j] q_u[i]        dV[j]   = sum_i (p * kf)[i,j] g[i].
//
// The TPU kernel un-shears ds with two exchange-matrix products and a strided
// roll; here the shear is by index over the staged window of the table, as in
// the forward: local (a, c) of a tile pair reads window row (BT-1) - a + c. The
// TPU accumulates dK/dV over query blocks through its ordered grid; here a dQ
// pass (one block per query tile, a loop over key tiles) and a dK/dV pass (one
// block per key tile, a loop over query tiles) each own their outputs, so
// there are no atomics and one seed gives the same gradients bit for bit. Both
// recompute the scores from the forward's row statistics. Plain fp32 FMA on
// the CUDA cores; bound by the shared-memory loads of the FMA loops.
//
// Shared memory: q_u, q_v, g, K, V tiles, the [2*BT-1] window and the score
// tiles. Tiles are 64 rows up to D = 104, 32 up to D = 248, 16 at D = 256.
// Head dims: every multiple of 8 from 8 to 256. T a multiple of 64.

#include "attention_bwd.cuh"

namespace {

using attn_bwd::kThreads;
using attn_bwd::load_tile;

template <int D>
__host__ __device__ constexpr int rel_rows() {
  return attn_bwd::tile_rows<D, 7, -1, 2>();
}

// One (query tile, key tile) pair's ac + bd and dp = g vᵀ in registers.
template <int D, int BT>
__device__ __forceinline__ void scores_and_dp(const float* qus, const float* qvs,
                                              const float* gs, const float* ks,
                                              const float* vs, const float* pw, int ty,
                                              int tx, float (&s)[BT / 16][BT / 16],
                                              float (&dp)[BT / 16][BT / 16]) {
  constexpr int R = BT / 16;
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qa[R], qb[R], ga[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qa[i] = qus[(ty * R + i) * LD + d];
      qb[i] = qvs[(ty * R + i) * LD + d];
      ga[i] = gs[(ty * R + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = ks[(tx + 16 * j) * LD + d];
      vv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        // the shear: local (a, c) reads window row (BT-1) - a + c
        const int w = (BT - 1) - (ty * R + i) + tx + 16 * j;
        s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
        s[i][j] = fmaf(qb[i], pw[w * LD + d], s[i][j]);
        dp[i][j] = fmaf(ga[i], vv[j], dp[i][j]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
relpos_dq_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
                 const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ p, const float* __restrict__ bias,
                 const float* __restrict__ g, const float* __restrict__ stats,
                 const float* __restrict__ delta, const long long* __restrict__ seed,
                 float rate, float* __restrict__ dqu, float* __restrict__ dqv, int H, int T,
                 int R_, int bias_heads, float scale) {
  constexpr int BT = rel_rows<D>();
  constexpr int R = BT / 16;
  constexpr int BW = 2 * BT - 1;
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int DC = (D + 15) / 16;
  static_assert(D % 8 == 0 && D <= attn_bwd::kMaxD, "head dim: a multiple of 8, <= 256");
  extern __shared__ float smem[];
  float* qus = smem;            // [BT][LD]
  float* qvs = qus + BT * LD;   // [BT][LD]
  float* gs = qvs + BT * LD;    // [BT][LD]
  float* ks = gs + BT * LD;     // [BT][LD]
  float* vs = ks + BT * LD;     // [BT][LD]
  float* pw = vs + BT * LD;     // [BW][LD] window of the table
  float* ps = pw + BW * LD;     // [BT][LP] keep factors, then ds

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)b * H + h;
  const size_t head = bh * (size_t)T * D;
  const float* ph = p + (size_t)h * R_ * D;
  const float* bb = bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) * T * T;
  const int q0 = qt * BT;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  load_tile<BT, D>(qus, qu + head, q0, T, tid);
  load_tile<BT, D>(qvs, qv + head, q0, T, tid);
  load_tile<BT, D>(gs, g + head, q0, T, tid);

  float mx[R], il[R], dl[R], au[R][DC], av[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t row = bh * T + q0 + ty * R + i;
    mx[i] = stats[row * 2];
    il[i] = stats[row * 2 + 1];
    dl[i] = delta[row];
#pragma unroll
    for (int c = 0; c < DC; ++c) au[i][c] = av[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BT) {
    // table row of window row 0: T-1 - (q0 + BT-1) + k0, always in [0, 2T-2]
    const int u0 = T - q0 - BT + k0;
    __syncthreads();  // the previous tile's ks/vs/pw/ps are no longer read
    load_tile<BT, D>(ks, k + head, k0, T, tid);
    load_tile<BT, D>(vs, v + head, k0, T, tid);
    load_tile<BW, D>(pw, ph, u0, R_, tid);
    if (drop)
      dropout::fill_keep_tile<BT, BT>(ps, LP, sd, b, h, q0, k0, rate, inv_keep, tid,
                                      kThreads);
    __syncthreads();

    float s[R][R], dp[R][R];
    scores_and_dp<D, BT>(qus, qvs, gs, ks, vs, pw, ty, tx, s, dp);

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float* brow = bb + (size_t)(q0 + ty * R + i) * T + k0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float* slot = &ps[(ty * R + i) * LP + tx + 16 * j];
        const float pr = expf(s[i][j] * scale + brow[tx + 16 * j] - mx[i]) * il[i];
        const float kf = drop ? *slot : 1.f;
        *slot = pr * (dp[i][j] * kf - dl[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BT; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        kv[c] = (D % 16 == 0 || tx + 16 * c < D) ? ks[kk * LD + tx + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ds = ps[(ty * R + i) * LP + kk];
        const float* prow = pw + ((BT - 1) - (ty * R + i) + kk) * LD;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          au[i][c] = fmaf(ds, kv[c], au[i][c]);
          if (D % 16 == 0 || tx + 16 * c < D)
            av[i][c] = fmaf(ds, prow[tx + 16 * c], av[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t off = head + (size_t)(q0 + ty * R + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) {
        dqu[off + tx + 16 * c] = au[i][c];
        dqv[off + tx + 16 * c] = av[i][c];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
relpos_dkv_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ p, const float* __restrict__ bias,
                  const float* __restrict__ g, const float* __restrict__ stats,
                  const float* __restrict__ delta, const long long* __restrict__ seed,
                  float rate, float* __restrict__ dk, float* __restrict__ dv, int H, int T,
                  int R_, int bias_heads, float scale) {
  constexpr int BT = rel_rows<D>();
  constexpr int R = BT / 16;
  constexpr int BW = 2 * BT - 1;
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int DC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* ks = smem;             // [BT][LD]
  float* vs = ks + BT * LD;     // [BT][LD]
  float* qus = vs + BT * LD;    // [BT][LD]
  float* qvs = qus + BT * LD;   // [BT][LD]
  float* gs = qvs + BT * LD;    // [BT][LD]
  float* pw = gs + BT * LD;     // [BW][LD] window of the table
  float* pd = pw + BW * LD;     // [BT][LP] keep factors, then p * kf, [query][key]
  float* dst = pd + BT * LP;    // [BT][LP] ds, [query][key]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)b * H + h;
  const size_t head = bh * (size_t)T * D;
  const float* ph = p + (size_t)h * R_ * D;
  const float* bb = bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) * T * T;
  const int k0 = kt * BT;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  load_tile<BT, D>(ks, k + head, k0, T, tid);
  load_tile<BT, D>(vs, v + head, k0, T, tid);

  // in the accumulation this thread owns keys ty*R + jj and channels tx + 16c
  float dka[R][DC], dva[R][DC];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[j][c] = dva[j][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += BT) {
    const int u0 = T - q0 - BT + k0;
    __syncthreads();  // the previous tile's qus/qvs/gs/pw/pd/dst are no longer read
    load_tile<BT, D>(qus, qu + head, q0, T, tid);
    load_tile<BT, D>(qvs, qv + head, q0, T, tid);
    load_tile<BT, D>(gs, g + head, q0, T, tid);
    load_tile<BW, D>(pw, ph, u0, R_, tid);
    if (drop)
      dropout::fill_keep_tile<BT, BT>(pd, LP, sd, b, h, q0, k0, rate, inv_keep, tid,
                                      kThreads);
    __syncthreads();

    float s[R][R], dp[R][R];
    scores_and_dp<D, BT>(qus, qvs, gs, ks, vs, pw, ty, tx, s, dp);

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const size_t row = bh * T + q0 + ty * R + i;
      const float mx = stats[row * 2], il = stats[row * 2 + 1], dl = delta[row];
      const float* brow = bb + (size_t)(q0 + ty * R + i) * T + k0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int slot = (ty * R + i) * LP + tx + 16 * j;
        const float pr = expf(s[i][j] * scale + brow[tx + 16 * j] - mx) * il;
        const float kf = drop ? pd[slot] : 1.f;
        pd[slot] = pr * kf;
        dst[slot] = pr * (dp[i][j] * kf - dl) * scale;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int ii = 0; ii < BT; ++ii) {
      float gv[DC], qv_[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const bool in = D % 16 == 0 || tx + 16 * c < D;
        gv[c] = in ? gs[ii * LD + tx + 16 * c] : 0.f;
        qv_[c] = in ? qus[ii * LD + tx + 16 * c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float pk = pd[ii * LP + ty * R + j];
        const float ds = dst[ii * LP + ty * R + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dva[j][c] = fmaf(pk, gv[c], dva[j][c]);
          dka[j][c] = fmaf(ds, qv_[c], dka[j][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const size_t off = head + (size_t)(k0 + ty * R + j) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) {
        dk[off + tx + 16 * c] = dka[j][c];
        dv[off + tx + 16 * c] = dva[j][c];
      }
  }
}

template <int D>
int launch(const float* qu, const float* qv, const float* k, const float* v,
           const float* p, const float* bias, const float* g, const float* out,
           const float* stats, const long long* seed, float* delta, float* dqu,
           float* dqv, float* dk, float* dv, int B, int H, int T, int R, int bias_heads,
           float scale, float rate, cudaStream_t stream) {
  constexpr int BT = rel_rows<D>();
  constexpr size_t smem = attn_bwd::smem_bytes(D, BT, 7, -1, 2);
  static_assert(smem <= attn_bwd::kMaxSmem, "tiles do not fit shared memory");
  static bool raised_dq[attn_bwd::kMaxDevices] = {}, raised_dkv[attn_bwd::kMaxDevices] = {};
  int err = attn_bwd::raise_smem(relpos_dq_kernel<D>, smem, raised_dq);
  if (err != 0) return err;
  err = attn_bwd::raise_smem(relpos_dkv_kernel<D>, smem, raised_dkv);
  if (err != 0) return err;
  err = attn_bwd::launch_rowdot(g, out, delta, (long long)B * H * T, D, stream);
  if (err != 0) return err;
  const dim3 grid(T / BT, H, B);
  relpos_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      qu, qv, k, v, p, bias, g, stats, delta, seed, rate, dqu, dqv, H, T, R, bias_heads,
      scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  relpos_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      qu, qv, k, v, p, bias, g, stats, delta, seed, rate, dk, dv, H, T, R, bias_heads,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_u, q_v, k, v, g, out, dq_u, dq_v, dk, dv: [B, H, T, D]; p: [H, R, D] with
// R >= 2T-1; bias: [B, bias_heads, T, T] with bias_heads 1 or H; stats:
// [B, H, T, 2] (the forward's row max and 1 / sum); delta: [B, H, T], written
// here and read again by relpos_attention_dp_f32; seed: one int64 on the
// device, read when rate > 0; all fp32 and contiguous. T a multiple of 64; D a
// multiple of 8 from 8 to 256.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int relpos_attention_bwd_f32(const float* qu, const float* qv, const float* k,
                                        const float* v, const float* p, const float* bias,
                                        const float* g, const float* out,
                                        const float* stats, const long long* seed,
                                        float* delta, float* dqu, float* dqv, float* dk,
                                        float* dv, int B, int H, int T, int D, int R,
                                        int bias_heads, float scale, float rate,
                                        void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0 || R < 2 * T - 1 || H > 65535 ||
      B > 65535 || !(bias_heads == 1 || bias_heads == H) ||
      !(rate >= 0.f && rate < 1.f) || (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d)                                                                         \
  case d:                                                                               \
    return launch<d>(qu, qv, k, v, p, bias, g, out, stats, seed, delta, dqu, dqv, dk,  \
                     dv, B, H, T, R, bias_heads, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
