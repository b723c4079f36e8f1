// Causal self-attention with a key-validity bias, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `masked_attention` / `_causal_kernel` in
// streamspeech_tpu/ops/pallas_attention.py (the unit decoder's causal
// self-attention inside synthesize_units). It computes, for every (b, h, i):
//
//   out[b,h,i] = sum_j softmax_j( q_i . k_j * scale + kvb[b,j]
//                                 + (j <= i ? 0 : -1e9) ) * v_j
//
// What bounds it on this card: the TPU kernel keeps a whole K/V row in VMEM;
// at T = 3200, D = 64 that row is 1.6 MB per (b, h), far above the 227 KB of
// shared memory an H100 block may use, and the [T, T] score matrix would be
// 41 MB per head in device memory. So the design is the online-softmax
// (flash-attention) form: one block per (64-query tile, h, b), a loop over
// 64-key tiles staged through shared memory, a running row max and sum, and a
// [64, D] accumulator in registers. No [T, T] tensor is ever written. Key
// tiles wholly above the diagonal are skipped, which halves the work and is
// exact: exp(-1e9 - m) is 0 in fp32 once a row has one allowed key, and key 0
// (the EOS prefix row) is always valid on the serving path. Arithmetic is
// plain fp32 FMA on the CUDA cores (no TF32, no wgmma), so the result agrees
// with the fp32 plain version to rounding; at these sizes the kernel is bound
// by shared-memory bandwidth of the FMA loops rather than by device memory.
//
// Head dims: every multiple of 8 from 8 to 256, the TPU route's gate
// (head_dim % 8 == 0) up to the largest D whose three [64, D + 1] tiles fit
// one block's shared memory (214 KB at D = 256). Any other D is refused.
//
// Training adds two options (`_causal_kernel` :414-417 and the backward's
// residual). rate > 0 drops attention probabilities after the softmax: the
// keep factors of dropout.cuh are staged into the probability tile while the
// K/V tile loads and multiply each tile's un-normalised weights in the V
// accumulation only, never in the running sum. stats != null writes each
// row's max and 1 / sum, [B, H, T, 2], which masked_attention_bwd.cu reads
// instead of recomputing whole rows. (Two numbers, not one log-sum-exp: a
// wholly masked row sits at -1e9, where fp32 cannot carry log(sum).)

#include <cuda_runtime.h>
#include <math.h>

#include "dropout.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 query rows, tx 4 keys / D/16 channels
constexpr int kMaxD = 256;
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e9f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBQ * (D + 1) + kBQ * (kBK + 1) + kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
causal_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ kvb,
                        float* __restrict__ out, const long long* __restrict__ seed,
                        float rate, float* __restrict__ stats, int H, int T,
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
  float* bs = ps + kBQ * LP;    // [kBK] key-validity bias of the current tile

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t head = ((size_t)b * H + h) * (size_t)T * D;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* kb = kvb + (size_t)b * T;
  const int q0 = qt * kBQ;
  const bool drop = rate > 0.f;
  const unsigned long long sd = drop ? (unsigned long long)*seed : 0ull;
  const float inv_keep = drop ? 1.f / (1.f - rate) : 1.f;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] = qh[(size_t)(q0 + r) * D + c];
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {  // tiles above the diagonal contribute 0
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      ks[r * LD + c] = kh[(size_t)(k0 + r) * D + c];
      vs[r * LD + c] = vh[(size_t)(k0 + r) * D + c];
    }
    if (tid < kBK) bs[tid] = kb[k0 + tid];
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
        float x = s[i][j] * scale + bs[tx + 16 * j];
        if (col > row) x += kNegInf;
        s[i][j] = x;
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
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
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

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
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
    const float inv = 1.f / l[i];
    float* orow = out + head + (size_t)(q0 + ty * 4 + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) orow[tx + 16 * c] = acc[i][c] * inv;
    if (stats != nullptr && tx == 0) {
      float* st = stats + (((size_t)b * H + h) * T + q0 + ty * 4 + i) * 2;
      st[0] = m[i];
      st[1] = inv;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* kvb,
           float* out, const long long* seed, float rate, float* stats, int B, int H,
           int T, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the dynamic shared-memory limit is raised once per device and head dim
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(causal_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const dim3 grid(T / kBQ, H, B);
  causal_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, kvb, out, seed, rate, stats, H, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, H, T, D] contiguous fp32; kvb: [B, T] fp32 additive key
// bias (0 valid, -1e9 masked). T must be a multiple of 64; D a multiple of 8
// from 8 to 256. rate in [0, 1): with rate > 0, seed points at one int64 on the
// device; stats: null, or [B, H, T, 2] fp32 to receive each row's max and 1 / sum.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int masked_attention_f32(const float* q, const float* k,
                                    const float* v, const float* kvb,
                                    float* out, const long long* seed, float* stats,
                                    int B, int H, int T, int D, float scale,
                                    float rate, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % kBQ != 0 || H > 65535 || B > 65535 ||
      !(rate >= 0.f && rate < 1.f) || (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d) \
  case d: return launch<d>(q, k, v, kvb, out, seed, rate, stats, B, H, T, scale, s);
  switch (D) {
    CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64)
    CASE(72) CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120) CASE(128)
    CASE(136) CASE(144) CASE(152) CASE(160) CASE(168) CASE(176) CASE(184) CASE(192)
    CASE(200) CASE(208) CASE(216) CASE(224) CASE(232) CASE(240) CASE(248) CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
