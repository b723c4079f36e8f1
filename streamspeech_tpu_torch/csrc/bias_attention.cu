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
// adds no structure of its own. What bounds it on this card: at the unit
// decoder's shape (TQ = 600, TK = 24, D = 64) the bias [B, TQ, TK] and the
// output dominate the bytes and the work is 4*TQ*TK*D flops per head, far
// below one fp32 FMA's worth per byte: the kernel is bound by latency and
// memory, not arithmetic. Design: the online-softmax form of
// masked_attention.cu without its causal tile skip: one block per
// (64-query tile, h, b), a loop over 64-key tiles staged through shared
// memory, running row max and sum, a [64, D] accumulator in registers. The
// kernel masks its own ragged edges (queries past TQ are not written, keys past
// TK weigh 0), so TQ and TK need no padding; the TPU pads TK = 24 to 128.
//
// Head dims: every multiple of 8 from 8 to 256, as masked_attention.cu.
//
// Training adds dropout (rate > 0, `_bias_kernel` :614-617) and the row
// statistics output (stats != null), both exactly as in masked_attention.cu;
// bias_attention_bwd.cu reads the statistics.

#include <cuda_runtime.h>
#include <math.h>

#include "dropout.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 query rows, tx 4 keys / D/16 channels
constexpr int kMaxD = 256;
constexpr int kMaxDevices = 64;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBQ * (D + 1) + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bias_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, const long long* __restrict__ seed,
                      float rate, float* __restrict__ stats, int H, int TQ, int TK,
                      float scale) {
  constexpr int LD = D + 1;   // padded row stride: column reads hit distinct banks
  constexpr int LP = kBK + 1;
  constexpr int DC = (D + 15) / 16;  // output channels per thread
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][LD]
  float* ks = qs + kBQ * LD;    // [kBK][LD]
  float* vs = ks + kBK * LD;    // [kBK][LD]
  float* ps = vs + kBK * LD;    // [kBQ][LP] probabilities of the current tile

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)b * H + h;
  const float* qh = q + bh * (size_t)TQ * D;
  const float* kh = k + bh * (size_t)TK * D;
  const float* vh = v + bh * (size_t)TK * D;
  const float* bb = bias + (size_t)b * TQ * TK;
  const int q0 = qt * kBQ;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] = q0 + r < TQ ? qh[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < TK; k0 += kBK) {
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < TK;
      ks[r * LD + c] = in ? kh[(size_t)(k0 + r) * D + c] : 0.f;
      vs[r * LD + c] = in ? vh[(size_t)(k0 + r) * D + c] : 0.f;
    }
    if (drop)
      dropout::fill_keep_tile<kBQ, kBK>(ps, LP, sd, b, h, q0, k0, rate, inv_keep, tid,
                                        kThreads);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        // keys past TK (and rows past TQ) weigh nothing: -inf, not the -1e9 bias
        const float x = (row < TQ && col < TK)
                            ? s[i][j] * scale + bb[(size_t)row * TK + col]
                            : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads sharing a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row past TQ stays at -inf: keep its arithmetic finite (it is not written)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        float* slot = &ps[(ty * 4 + i) * LP + tx + 16 * j];
        *slot = drop ? p * *slot : p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kmax = TK - k0 < kBK ? TK - k0 : kBK;
#pragma unroll 8
    for (int kk = 0; kk < kmax; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        vv[c] = (D % 16 == 0 || tx + 16 * c < D) ? vs[kk * LD + tx + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * LP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= TQ) continue;
    const float inv = 1.f / l[i];
    float* orow = out + bh * (size_t)TQ * D + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) orow[tx + 16 * c] = acc[i][c] * inv;
    if (stats != nullptr && tx == 0) {
      float* st = stats + (bh * (size_t)TQ + row) * 2;
      st[0] = m[i];
      st[1] = inv;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, const long long* seed, float rate, float* stats, int B, int H,
           int TQ, int TK, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the dynamic shared-memory limit is raised once per device and head dim
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(bias_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const dim3 grid((TQ + kBQ - 1) / kBQ, H, B);
  bias_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, out, seed, rate, stats, H, TQ, TK, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, H, TQ, D]; k, v: [B, H, TK, D]; bias: [B, TQ, TK]; all contiguous
// fp32. D a multiple of 8 from 8 to 256; TQ, TK >= 1. rate in [0, 1): with
// rate > 0, seed points at one int64 on the device; stats: null, or
// [B, H, TQ, 2] fp32 to receive each row's max and 1 / sum.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int bias_attention_f32(const float* q, const float* k, const float* v,
                                  const float* bias, float* out, const long long* seed,
                                  float* stats, int B, int H, int TQ, int TK, int D,
                                  float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0 || H > 65535 || B > 65535 ||
      !(rate >= 0.f && rate < 1.f) || (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d) \
  case d: \
    return launch<d>(q, k, v, bias, out, seed, rate, stats, B, H, TQ, TK, scale, s);
  switch (D) {
    CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64)
    CASE(72) CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120) CASE(128)
    CASE(136) CASE(144) CASE(152) CASE(160) CASE(168) CASE(176) CASE(184) CASE(192)
    CASE(200) CASE(208) CASE(216) CASE(224) CASE(232) CASE(240) CASE(248) CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
