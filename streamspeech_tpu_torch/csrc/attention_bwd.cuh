// The backward of softmax(q Kᵀ·scale + additive bias)·V with dropout, fp32, for
// Hopper (sm_90a): the body shared by masked_attention_bwd.cu (causal, key
// bias) and bias_attention_bwd.cu (arbitrary [B, TQ, TK] bias), which differ
// only in where the additive bias comes from, and the helpers the rel-pos
// backward shares.
//
// Replaces `_causal_bwd_kernel` and `_bias_bwd_kernel` of
// streamspeech_tpu/ops/pallas_attention.py. Those accumulate dK and dV across
// query blocks by running the TPU grid in order (zero at q-block 0, then +=);
// Hopper blocks run in no order, so here the work is three launches:
//
//   delta[b,h,i] = sum_d g[i,d] * out[i,d]       (= rowsum(dprobs * probs), with
//                                                 or without dropout, since out
//                                                 holds the dropped probs)
//   dQ pass:   one block per (query tile, h, b), a loop over key tiles
//   dK/dV pass: one block per (key tile, h, b), a loop over query tiles
//              (causal: only those at or below the key tile)
//
// Each pass recomputes p = exp(s - max) / sum from the forward's saved row
// statistics, regenerates the keep factors kf of dropout.cuh, and forms
//   dp = (g vᵀ) * kf,  ds = p * (dp - delta) * scale,
//   dq = ds K,  dK = dsᵀ q,  dV = (p * kf)ᵀ g.
// No atomics: one seed gives the same gradients bit for bit. No [TQ, TK]
// tensor is written. Both passes recompute q Kᵀ and g Vᵀ, so a head costs
// 14*TQ*TK*D flops (6 in the dQ pass, 8 in the dK/dV pass) against the 10 of
// the five products themselves: the price of keeping 8 bytes a row instead of
// TQ*TK*4. Plain fp32 FMA on the CUDA cores, bound by the shared-memory loads
// of the FMA loops.
//
// Tiles are 64 rows while four [64, D+1] tiles and the score tiles fit one
// block's shared memory (D <= 192) and 32 rows above. Head dims: every
// multiple of 8 from 8 to 256.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "dropout.cuh"

namespace attn_bwd {

constexpr int kThreads = 256;  // 16 x 16: ty owns BT/16 rows, tx BT/16 columns / D/16 channels
constexpr int kMaxD = 256;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared-memory limit
constexpr float kNegInf = -1e9f;

// (a * bt + c) rows of [D + 1] floats and `squares` [bt, bt + 1] score tiles
__host__ __device__ constexpr size_t smem_bytes(int d, int bt, int a, int c, int squares) {
  return sizeof(float) * ((size_t)(a * bt + c) * (d + 1) + (size_t)squares * bt * (bt + 1));
}

// The largest tile of 64, 32 or 16 rows whose shared memory fits one block.
template <int D, int A, int C, int SQ>
__host__ __device__ constexpr int tile_rows() {
  return smem_bytes(D, 64, A, C, SQ) <= kMaxSmem   ? 64
         : smem_bytes(D, 32, A, C, SQ) <= kMaxSmem ? 32
                                                   : 16;
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <class Kernel>
int raise_smem(Kernel kernel, size_t smem, bool* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  return 0;
}

// delta[row] = sum_d g[row, d] * out[row, d]; one warp per row.
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const float* __restrict__ g, const float* __restrict__ out,
              float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += g[row * D + d] * out[row * D + d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) delta[row] = sum;
}

inline int launch_rowdot(const float* g, const float* out, float* delta, long long rows,
                         int D, cudaStream_t stream) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  rowdot_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(g, out, delta, rows, D);
  return (int)cudaGetLastError();
}

// Causal mask computed from the indices plus a key-validity bias [B, T]; the
// adds are in the forward's order.
struct CausalBias {
  static constexpr bool kCausal = true;
  const float* kvb;
  int T;
  __device__ __forceinline__ float add(float x, int b, int row, int col) const {
    x += kvb[(size_t)b * T + col];
    if (col > row) x += kNegInf;
    return x;
  }
};

// An arbitrary additive bias [B, TQ, TK] that carries the whole mask.
struct FullBias {
  static constexpr bool kCausal = false;
  const float* bias;
  int TQ, TK;
  __device__ __forceinline__ float add(float x, int b, int row, int col) const {
    return x + bias[((size_t)b * TQ + row) * TK + col];
  }
};

// Copy rows [r0, r0 + ROWS) of a [n, D] matrix into a [ROWS][D + 1] tile,
// zeros past row n.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src,
                                          int r0, int n, int tid) {
  constexpr int LD = D + 1;
  for (int i = tid; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    tile[r * LD + c] = (r0 + r >= 0 && r0 + r < n) ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

template <int D, class Bias>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ g,
          const float* __restrict__ stats, const float* __restrict__ delta, Bias bias,
          const long long* __restrict__ seed, float rate, float* __restrict__ dq, int H,
          int TQ, int TK, float scale) {
  constexpr int BT = tile_rows<D, 4, 0, 2>();
  constexpr int R = BT / 16;
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int DC = (D + 15) / 16;
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  extern __shared__ float smem[];
  float* qs = smem;            // [BT][LD]
  float* gs = qs + BT * LD;    // [BT][LD]
  float* ks = gs + BT * LD;    // [BT][LD]
  float* vs = ks + BT * LD;    // [BT][LD]
  float* ps = vs + BT * LD;    // [BT][LP] keep factors, then ds, of the current tile

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)b * H + h;
  const float* kh = k + bh * (size_t)TK * D;
  const float* vh = v + bh * (size_t)TK * D;
  const int q0 = qt * BT;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  load_tile<BT, D>(qs, q + bh * (size_t)TQ * D, q0, TQ, tid);
  load_tile<BT, D>(gs, g + bh * (size_t)TQ * D, q0, TQ, tid);

  float mx[R], il[R], dl[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    const bool in = row < TQ;
    mx[i] = in ? stats[(bh * TQ + row) * 2] : 0.f;
    il[i] = in ? stats[(bh * TQ + row) * 2 + 1] : 0.f;
    dl[i] = in ? delta[bh * TQ + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles above the diagonal weigh 0, as in the forward
  const int kend = Bias::kCausal ? (q0 + BT < TK ? q0 + BT : TK) : TK;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    load_tile<BT, D>(ks, kh, k0, TK, tid);
    load_tile<BT, D>(vs, vh, k0, TK, tid);
    if (drop)
      dropout::fill_keep_tile<BT, BT>(ps, LP, sd, b, h, q0, k0, rate, inv_keep, tid,
                                      kThreads);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = qs[(ty * R + i) * LD + d];
        gv[i] = gs[(ty * R + i) * LD + d];
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
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        float* slot = &ps[(ty * R + i) * LP + tx + 16 * j];
        float ds = 0.f;
        if (row < TQ && col < TK) {
          const float p = expf(bias.add(s[i][j] * scale, b, row, col) - mx[i]) * il[i];
          const float kf = drop ? *slot : 1.f;
          ds = p * (dp[i][j] * kf - dl[i]) * scale;
        }
        *slot = ds;
      }
    }
    __syncthreads();

    const int kmax = TK - k0 < BT ? TK - k0 : BT;
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        kv[c] = (D % 16 == 0 || tx + 16 * c < D) ? ks[kk * LD + tx + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float x = ps[(ty * R + i) * LP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(x, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= TQ) continue;
    float* orow = dq + (bh * TQ + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) orow[tx + 16 * c] = acc[i][c];
  }
}

template <int D, class Bias>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ g,
           const float* __restrict__ stats, const float* __restrict__ delta, Bias bias,
           const long long* __restrict__ seed, float rate, float* __restrict__ dk,
           float* __restrict__ dv, int H, int TQ, int TK, float scale) {
  constexpr int BT = tile_rows<D, 4, 0, 2>();
  constexpr int R = BT / 16;
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int DC = (D + 15) / 16;
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  extern __shared__ float smem[];
  float* ks = smem;            // [BT][LD]
  float* vs = ks + BT * LD;    // [BT][LD]
  float* qs = vs + BT * LD;    // [BT][LD]
  float* gs = qs + BT * LD;    // [BT][LD]
  float* pd = gs + BT * LD;    // [BT][LP] keep factors, then p * kf, [query][key]
  float* dst = pd + BT * LP;   // [BT][LP] ds, [query][key]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)b * H + h;
  const float* qh = q + bh * (size_t)TQ * D;
  const float* gh = g + bh * (size_t)TQ * D;
  const int k0 = kt * BT;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  load_tile<BT, D>(ks, k + bh * (size_t)TK * D, k0, TK, tid);
  load_tile<BT, D>(vs, v + bh * (size_t)TK * D, k0, TK, tid);

  // in the accumulation this thread owns keys ty*R + jj and channels tx + 16c
  float dka[R][DC], dva[R][DC];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[j][c] = dva[j][c] = 0.f;

  // causal: query tiles above the key tile see none of its keys
  for (int q0 = Bias::kCausal ? k0 : 0; q0 < TQ; q0 += BT) {
    __syncthreads();  // the previous tile's qs/gs/pd/dst are no longer read
    load_tile<BT, D>(qs, qh, q0, TQ, tid);
    load_tile<BT, D>(gs, gh, q0, TQ, tid);
    if (drop)
      dropout::fill_keep_tile<BT, BT>(pd, LP, sd, b, h, q0, k0, rate, inv_keep, tid,
                                      kThreads);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = qs[(ty * R + i) * LD + d];
        gv[i] = gs[(ty * R + i) * LD + d];
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
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
      const bool in = row < TQ;
      const float mx = in ? stats[(bh * TQ + row) * 2] : 0.f;
      const float il = in ? stats[(bh * TQ + row) * 2 + 1] : 0.f;
      const float dl = in ? delta[bh * TQ + row] : 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const int slot = (ty * R + i) * LP + tx + 16 * j;
        float pk = 0.f, ds = 0.f;
        if (in && col < TK) {
          const float p = expf(bias.add(s[i][j] * scale, b, row, col) - mx) * il;
          const float kf = drop ? pd[slot] : 1.f;
          pk = p * kf;
          ds = p * (dp[i][j] * kf - dl) * scale;
        }
        pd[slot] = pk;
        dst[slot] = ds;
      }
    }
    __syncthreads();

    const int qmax = TQ - q0 < BT ? TQ - q0 : BT;
#pragma unroll 2
    for (int ii = 0; ii < qmax; ++ii) {
      float gv[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const bool in = D % 16 == 0 || tx + 16 * c < D;
        gv[c] = in ? gs[ii * LD + tx + 16 * c] : 0.f;
        qv[c] = in ? qs[ii * LD + tx + 16 * c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float pk = pd[ii * LP + ty * R + j];
        const float ds = dst[ii * LP + ty * R + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dva[j][c] = fmaf(pk, gv[c], dva[j][c]);
          dka[j][c] = fmaf(ds, qv[c], dka[j][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int key = k0 + ty * R + j;
    if (key >= TK) continue;
    float* krow = dk + (bh * TK + key) * D;
    float* vrow = dv + (bh * TK + key) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) {
        krow[tx + 16 * c] = dka[j][c];
        vrow[tx + 16 * c] = dva[j][c];
      }
  }
}

// delta, the dQ pass and the dK/dV pass on `stream`; returns the cudaError_t code.
template <int D, class Bias>
int launch_bwd(const float* q, const float* k, const float* v, const float* g,
               const float* out, const float* stats, const long long* seed, float* delta,
               float* dq, float* dk, float* dv, Bias bias, int B, int H, int TQ, int TK,
               float scale, float rate, cudaStream_t stream) {
  constexpr int BT = tile_rows<D, 4, 0, 2>();
  constexpr size_t smem = smem_bytes(D, BT, 4, 0, 2);
  static_assert(smem <= kMaxSmem, "tiles do not fit shared memory");
  static bool raised_dq[kMaxDevices] = {}, raised_dkv[kMaxDevices] = {};
  int err = raise_smem(dq_kernel<D, Bias>, smem, raised_dq);
  if (err != 0) return err;
  err = raise_smem(dkv_kernel<D, Bias>, smem, raised_dkv);
  if (err != 0) return err;
  err = launch_rowdot(g, out, delta, (long long)B * H * TQ, D, stream);
  if (err != 0) return err;
  dq_kernel<D, Bias><<<dim3((TQ + BT - 1) / BT, H, B), kThreads, smem, stream>>>(
      q, k, v, g, stats, delta, bias, seed, rate, dq, H, TQ, TK, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<D, Bias><<<dim3((TK + BT - 1) / BT, H, B), kThreads, smem, stream>>>(
      q, k, v, g, stats, delta, bias, seed, rate, dk, dv, H, TQ, TK, scale);
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd

// `switch (D)` over every head dim the attention kernels take.
#define ATTN_FOR_EACH_HEAD_DIM(CASE)                                                  \
  CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64) CASE(72)     \
  CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120) CASE(128) CASE(136)        \
  CASE(144) CASE(152) CASE(160) CASE(168) CASE(176) CASE(184) CASE(192) CASE(200)     \
  CASE(208) CASE(216) CASE(224) CASE(232) CASE(240) CASE(248) CASE(256)
