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
// counterpart. Here the shear is done by index: for a (query tile, key tile)
// pair the rows read are one window of BQ + BK - 1 consecutive table rows,
// staged in shared memory beside the K/V tiles, and row (a, c) of the tile
// reads window row (BQ - 1) - a + c. No [T, 2T-1] or [T, T] tensor is ever
// written: the online-softmax form of masked_attention.cu, one block per
// (query tile, h, b), a loop over every key tile (no tile is skipped: the
// bias is arbitrary), running row max and sum, accumulator in registers.
//
// What bounds it on this card: at the encoder's shape (T = 256, D = 64) the
// work is 6*T*T*D flops per head against ~16 bytes of input per score, so the
// FP32 pipes, not device memory, are the limit; the kernel runs on the CUDA
// cores (no TF32, no wgmma) with about one shared-memory load per FMA. At
// B = 1, H = 4, T = 256 the grid is only 16 blocks for 132 SMs, so most of the
// card is idle: recorded, not fixed here.
//
// Training adds dropout (rate > 0, `_kernel` :84-87) and the row statistics
// output (stats != null, [B, H, T, 2]: max and 1 / sum), both exactly as in
// masked_attention.cu; relpos_attention_bwd.cu and relpos_attention_dp.cu read
// the statistics.
//
// Shared memory: q_u, q_v, K, V tiles [64, D+1], the P window [127, D+1] and
// the probability tile: 113 KB at D = 64. Tiles are 64 rows up to the largest
// D that fits 227 KB (D = 136) and 32 rows above it. Head dims: every multiple
// of 8 from 8 to 256. T must be a multiple of 64.

#include <cuda_runtime.h>
#include <math.h>

#include "dropout.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty owns BQ/16 query rows, tx BK/16 keys / D/16 channels
constexpr int kMaxD = 256;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared-memory limit

__host__ __device__ constexpr size_t smem_bytes(int d, int bq) {
  return sizeof(float) * ((size_t)(4 * bq + 2 * bq - 1) * (d + 1) + (size_t)bq * (bq + 1));
}

template <int D>
__host__ __device__ constexpr int tile_rows() {
  return smem_bytes(D, 64) <= kMaxSmem ? 64 : 32;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
relpos_attention_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
                        const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ p, const float* __restrict__ bias,
                        float* __restrict__ out, const long long* __restrict__ seed,
                        float rate, float* __restrict__ stats, int H, int T, int R,
                        int bias_heads, float scale) {
  constexpr int BQ = tile_rows<D>();
  constexpr int BK = BQ;
  constexpr int RQ = BQ / 16;        // query rows per thread
  constexpr int RK = BK / 16;        // keys per thread
  constexpr int BW = BQ + BK - 1;    // table rows one tile pair reads
  constexpr int LD = D + 1;          // padded row stride: column reads hit distinct banks
  constexpr int LP = BK + 1;
  constexpr int DC = (D + 15) / 16;  // output channels per thread
  static_assert(D % 8 == 0 && D <= kMaxD, "head dim must be a multiple of 8, <= 256");
  static_assert(smem_bytes(D, BQ) <= kMaxSmem, "tiles do not fit shared memory");
  extern __shared__ float smem[];
  float* qus = smem;            // [BQ][LD]
  float* qvs = qus + BQ * LD;   // [BQ][LD]
  float* ks = qvs + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* pw = vs + BK * LD;     // [BW][LD] window of the table
  float* ps = pw + BW * LD;     // [BQ][LP] probabilities of the current tile

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t head = ((size_t)b * H + h) * (size_t)T * D;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* ph = p + (size_t)h * R * D;
  const float* bh = bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) * T * T;
  const int q0 = qt * BQ;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qus[r * LD + c] = qu[head + (size_t)(q0 + r) * D + c];
    qvs[r * LD + c] = qv[head + (size_t)(q0 + r) * D + c];
  }

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    // table row of window row 0: T-1 - (q0 + BQ-1) + k0, always in [0, 2T-2]
    const int u0 = T - q0 - BQ + k0;
    __syncthreads();  // the previous tile's ks/vs/pw/ps are no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      ks[r * LD + c] = kh[(size_t)(k0 + r) * D + c];
      vs[r * LD + c] = vh[(size_t)(k0 + r) * D + c];
    }
    for (int i = tid; i < BW * D; i += kThreads) {
      const int r = i / D, c = i % D;
      pw[r * LD + c] = ph[(size_t)(u0 + r) * D + c];
    }
    if (drop)
      dropout::fill_keep_tile<BQ, BK>(ps, LP, sd, b, h, q0, k0, rate, inv_keep, tid,
                                      kThreads);
    __syncthreads();

    float ac[RQ][RK], bd[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) ac[i][j] = bd[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RQ], qb[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qa[i] = qus[(ty * RQ + i) * LD + d];
        qb[i] = qvs[(ty * RQ + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          ac[i][j] = fmaf(qa[i], kv[j], ac[i][j]);
          // the shear: local (a, c) reads window row (BQ-1) - a + c
          const int w = (BQ - 1) - (ty * RQ + i) + tx + 16 * j;
          bd[i][j] = fmaf(qb[i], pw[w * LD + d], bd[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      const float* brow = bh + (size_t)row * T + k0;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float x = (ac[i][j] + bd[i][j]) * scale + brow[tx + 16 * j];
        ac[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads sharing a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float pr = expf(ac[i][j] - m_new);
        float* slot = &ps[(ty * RQ + i) * LP + tx + 16 * j];
        *slot = drop ? pr * *slot : pr;
        sum += pr;
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

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        vv[c] = (D % 16 == 0 || tx + 16 * c < D) ? vs[kk * LD + tx + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float pr = ps[(ty * RQ + i) * LP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float inv = 1.f / l[i];
    float* orow = out + head + (size_t)(q0 + ty * RQ + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) orow[tx + 16 * c] = acc[i][c] * inv;
    if (stats != nullptr && tx == 0) {
      float* st = stats + (((size_t)b * H + h) * T + q0 + ty * RQ + i) * 2;
      st[0] = m[i];
      st[1] = inv;
    }
  }
}

template <int D>
int launch(const float* qu, const float* qv, const float* k, const float* v,
           const float* p, const float* bias, float* out, const long long* seed,
           float rate, float* stats, int B, int H, int T, int R, int bias_heads,
           float scale, cudaStream_t stream) {
  constexpr int BQ = tile_rows<D>();
  constexpr size_t smem = smem_bytes(D, BQ);
  if (T % BQ != 0) return (int)cudaErrorInvalidValue;
  // the dynamic shared-memory limit is raised once per device and head dim
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(relpos_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const dim3 grid(T / BQ, H, B);
  relpos_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      qu, qv, k, v, p, bias, out, seed, rate, stats, H, T, R, bias_heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_u, q_v, k, v, out: [B, H, T, D]; p: [H, R, D] with R >= 2T-1 (row u <->
// relative position T-1-u); bias: [B, bias_heads, T, T] with bias_heads 1 or H;
// all contiguous fp32. T a multiple of 64; D a multiple of 8 from 8 to 256.
// rate in [0, 1): with rate > 0, seed points at one int64 on the device; stats:
// null, or [B, H, T, 2] fp32 to receive each row's max and 1 / sum.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int relpos_attention_f32(const float* qu, const float* qv, const float* k,
                                    const float* v, const float* p, const float* bias,
                                    float* out, const long long* seed, float* stats,
                                    int B, int H, int T, int D, int R, int bias_heads,
                                    float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0 || R < 2 * T - 1 || H > 65535 ||
      B > 65535 || !(bias_heads == 1 || bias_heads == H) ||
      !(rate >= 0.f && rate < 1.f) || (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d) \
  case d:                                                                          \
    return launch<d>(qu, qv, k, v, p, bias, out, seed, rate, stats, B, H, T, R, \
                     bias_heads, scale, s);
  switch (D) {
    CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64)
    CASE(72) CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120) CASE(128)
    CASE(136) CASE(144) CASE(152) CASE(160) CASE(168) CASE(176) CASE(184) CASE(192)
    CASE(200) CASE(208) CASE(216) CASE(224) CASE(232) CASE(240) CASE(248) CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
