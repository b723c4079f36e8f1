// Backward of the relative-position self-attention, fp32, for Hopper
// (sm_90a): dP, the gradient of the per-head position table.
//
// Replaces `_bwd_kernel_p` (the second `pallas_call` of `_relpos_bwd`) and the
// scatter-add of overlapping windows after it
// (streamspeech_tpu/ops/pallas_attention.py:283-313). With ds as in
// relpos_attention_bwd.cu,
//
//   dP[h, u] = sum_b sum_{(i,j): T-1-i+j = u} ds[b,h,i,j] * q_v[b,h,i].
//
// The TPU accumulates per-query-block windows over the batch through its
// ordered grid and adds the overlapping windows on the host. Here one block
// owns a tile of BT table rows of one head and one batch element, walks the
// query tiles, and for each recomputes ds on the band of (i, j) that belongs
// to its rows: local (a, e) is query q0 + a, table row u0 + e, key
// j = u0 - (T-1) + q0 + a + e, so the keys read are a window of 2*BT-1 rows of
// K and V. Every (i, j) belongs to exactly one u: this is one more sweep of
// the T x T scores, the same extra work as the TPU's second kernel. Each block
// writes its rows of a per-batch partial [B, H, R, D] once, and a second small
// kernel adds the B partials in batch order: no atomics and no scatter, so one
// seed gives the same dP bit for bit. (One block per (table tile, h) walking
// the batch itself needs no partials, but is 32 blocks for 132 SMs at T = 256,
// H = 4: 0.85 ms a call against 0.11 ms for the dQ pass.) Table rows past 2T-2
// get 0. The keep factor is drawn per element (`keep_factor`), since a band
// row's keys do not start on a multiple of 4.
//
// Shared memory: the table tile, q_u, q_v, g tiles, the K and V windows and
// one score tile. Tiles are 64 rows up to D = 104, 32 up to D = 216, 16 above.
// Head dims: every multiple of 8 from 8 to 256. T a multiple of 64.

#include "attention_bwd.cuh"

namespace {

using attn_bwd::kThreads;
using attn_bwd::load_tile;

template <int D>
__host__ __device__ constexpr int dp_rows() {
  return attn_bwd::tile_rows<D, 8, -2, 1>();
}

template <int D>
__global__ void __launch_bounds__(kThreads)
relpos_dp_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
                 const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ p, const float* __restrict__ bias,
                 const float* __restrict__ g, const float* __restrict__ stats,
                 const float* __restrict__ delta, const long long* __restrict__ seed,
                 float rate, float* __restrict__ dp_part, int H, int T, int R_,
                 int bias_heads, float scale) {
  constexpr int BT = dp_rows<D>();
  constexpr int R = BT / 16;
  constexpr int BW = 2 * BT - 1;
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int DC = (D + 15) / 16;
  static_assert(D % 8 == 0 && D <= attn_bwd::kMaxD, "head dim: a multiple of 8, <= 256");
  extern __shared__ float smem[];
  float* pt = smem;             // [BT][LD] this block's table rows
  float* qus = pt + BT * LD;    // [BT][LD]
  float* qvs = qus + BT * LD;   // [BT][LD]
  float* gs = qvs + BT * LD;    // [BT][LD]
  float* kw = gs + BT * LD;     // [BW][LD] window of K
  float* vw = kw + BW * LD;     // [BW][LD] window of V
  float* ps = vw + BW * LD;     // [BT][LP] ds, [query a][table row e]

  const int ut = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int u0 = ut * BT;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  load_tile<BT, D>(pt, p + (size_t)h * R_ * D, u0, R_, tid);

  // in the accumulation this thread owns table rows ty*R + jj, channels tx + 16c
  float acc[R][DC];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[j][c] = 0.f;

  const size_t bh = (size_t)b * H + h;
  const size_t head = bh * (size_t)T * D;
  const float* bb = bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) * T * T;
  for (int q0 = 0; q0 < T; q0 += BT) {
    const int jbase = u0 - (T - 1) + q0;  // key of local (a, e) = jbase + a + e
    if (jbase > T - 1 || jbase + 2 * BT - 2 < 0) continue;  // the band misses [0, T)
    __syncthreads();  // the previous step's tiles are no longer read
    load_tile<BT, D>(qus, qu + head, q0, T, tid);
    load_tile<BT, D>(qvs, qv + head, q0, T, tid);
    load_tile<BT, D>(gs, g + head, q0, T, tid);
    load_tile<BW, D>(kw, k + head, jbase, T, tid);
    load_tile<BW, D>(vw, v + head, jbase, T, tid);
    __syncthreads();

    float s[R][R], dpv[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qa[R], qb[R], ga[R], pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qa[i] = qus[(ty * R + i) * LD + d];
        qb[i] = qvs[(ty * R + i) * LD + d];
        ga[i] = gs[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) pv[j] = pt[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int w = ty * R + i + tx + 16 * j;  // window row of key jbase + a + e
          s[i][j] = fmaf(qa[i], kw[w * LD + d], s[i][j]);
          s[i][j] = fmaf(qb[i], pv[j], s[i][j]);
          dpv[i][j] = fmaf(ga[i], vw[w * LD + d], dpv[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int a = ty * R + i, row = q0 + a;
      const float mx = stats[(bh * T + row) * 2], il = stats[(bh * T + row) * 2 + 1];
      const float dl = delta[bh * T + row];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int e = tx + 16 * j, col = jbase + a + e;
        float ds = 0.f;
        if (col >= 0 && col < T) {
          const float pr =
              expf(s[i][j] * scale + bb[(size_t)row * T + col] - mx) * il;
          const float kf =
              drop ? dropout::keep_factor(sd, b, h, row, col, rate, inv_keep) : 1.f;
          ds = pr * (dpv[i][j] * kf - dl) * scale;
        }
        ps[a * LP + e] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int a = 0; a < BT; ++a) {
      float qb[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        qb[c] = (D % 16 == 0 || tx + 16 * c < D) ? qvs[a * LD + tx + 16 * c] : 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float ds = ps[a * LP + ty * R + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[j][c] = fmaf(ds, qb[c], acc[j][c]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int u = u0 + ty * R + j;
    if (u >= R_) continue;
    float* orow = dp_part + (bh * R_ + u) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) orow[tx + 16 * c] = acc[j][c];
  }
}

// dp[i] = sum_b part[b][i] over n = H*R*D elements, in batch order.
__global__ void __launch_bounds__(kThreads)
sum_batch_kernel(const float* __restrict__ part, float* __restrict__ dp, int B, size_t n) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) sum += part[(size_t)b * n + i];
  dp[i] = sum;
}

template <int D>
int launch(const float* qu, const float* qv, const float* k, const float* v,
           const float* p, const float* bias, const float* g, const float* stats,
           const float* delta, const long long* seed, float* part, float* dp, int B, int H,
           int T, int R, int bias_heads, float scale, float rate, cudaStream_t stream) {
  constexpr int BT = dp_rows<D>();
  constexpr size_t smem = attn_bwd::smem_bytes(D, BT, 8, -2, 1);
  static_assert(smem <= attn_bwd::kMaxSmem, "tiles do not fit shared memory");
  static bool raised[attn_bwd::kMaxDevices] = {};
  int err = attn_bwd::raise_smem(relpos_dp_kernel<D>, smem, raised);
  if (err != 0) return err;
  relpos_dp_kernel<D><<<dim3((R + BT - 1) / BT, H, B), kThreads, smem, stream>>>(
      qu, qv, k, v, p, bias, g, stats, delta, seed, rate, part, H, T, R, bias_heads,
      scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t n = (size_t)H * R * D;
  sum_batch_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, dp, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

// q_u, q_v, k, v, g: [B, H, T, D]; p, dp: [H, R, D] with R >= 2T-1; part:
// [B, H, R, D] scratch; bias: [B, bias_heads, T, T]; stats: [B, H, T, 2];
// delta: [B, H, T] as relpos_attention_bwd_f32 wrote it; seed: one int64 on the
// device, read when rate > 0; all fp32 and contiguous. T a multiple of 64; D a
// multiple of 8 from 8 to 256.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int relpos_attention_dp_f32(const float* qu, const float* qv, const float* k,
                                       const float* v, const float* p, const float* bias,
                                       const float* g, const float* stats,
                                       const float* delta, const long long* seed,
                                       float* part, float* dp, int B, int H, int T, int D,
                                       int R, int bias_heads, float scale, float rate,
                                       void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0 || R < 2 * T - 1 || H > 65535 ||
      B > 65535 || !(bias_heads == 1 || bias_heads == H) || !(rate >= 0.f && rate < 1.f) ||
      (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d)                                                                        \
  case d:                                                                              \
    return launch<d>(qu, qv, k, v, p, bias, g, stats, delta, seed, part, dp, B, H, T,  \
                     R, bias_heads, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
