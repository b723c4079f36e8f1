// CTC not-blank posterior of one aux head, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `not_blank_probs_pallas` / `_nb_kernel` in
// streamspeech_tpu/ops/pallas_policy.py (the streaming mask's input, built
// from the ASR and ST CTC heads). For logits x [B, T, V] it computes, with
// p_t = softmax(x[b, t]) in fp32 and p_{-1} = 0:
//
//   out[b, t] = 1 - p_t[blank] - (sum_v p_t[v] p_{t-1}[v]
//                                 - p_t[blank] p_{t-1}[blank])
//
// What bounds it on this card: device memory. The work is a few flops per
// logit, the output only [B, T]: the least the card can do is read the logits
// once (B*T*V*4 bytes; 6.1 MB per head at [1, 256, 6000]). The TPU kernel
// walks time in order and carries the previous posterior row in scratch;
// blocks on the card run in no order, so nothing is carried: one block per
// (b, t) row reads rows t and t-1 itself. Each row's max, its sum of
// exponentials and the dot of the two rows' exponentials take two passes over
// the two rows, so the kernel reads every logit about four times (twice as
// row t, twice as row t-1 of the next block), the repeats mostly from L1/L2.
// Nothing of size [B, T, V] is written.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// sum (max) of `v` over the block; every thread gets the result
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kWarps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // all 32 lanes end with the total
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
not_blank_kernel(const float* __restrict__ logits, float* __restrict__ out,
                 int T, int V, int blank) {
  __shared__ float scratch[kWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const float* cur = logits + ((size_t)b * T + t) * V;
  const float* prev = cur - V;  // read only when t > 0
  const bool has_prev = t > 0;

  float mc = -INFINITY, mp = -INFINITY;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    mc = fmaxf(mc, cur[v]);
    if (has_prev) mp = fmaxf(mp, prev[v]);
  }
  mc = block_reduce<true>(mc, scratch);
  if (has_prev) mp = block_reduce<true>(mp, scratch);

  float sc = 0.f, sp = 0.f, dot = 0.f;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const float ec = expf(cur[v] - mc);
    sc += ec;
    if (has_prev) {
      const float ep = expf(prev[v] - mp);
      sp += ep;
      dot = fmaf(ec, ep, dot);
    }
  }
  sc = block_reduce<false>(sc, scratch);
  if (has_prev) {
    sp = block_reduce<false>(sp, scratch);
    dot = block_reduce<false>(dot, scratch);
  }

  if (threadIdx.x == 0) {
    const float blank_p = expf(cur[blank] - mc) / sc;
    float repeat = 0.f;
    if (has_prev) {
      const float prev_blank = expf(prev[blank] - mp) / sp;
      repeat = dot / (sc * sp) - blank_p * prev_blank;
    }
    out[(size_t)b * T + t] = 1.f - (repeat + blank_p);
  }
}

}  // namespace

// logits: [B, T, V] contiguous fp32; out: [B, T] fp32; 0 <= blank < V.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int not_blank_probs_f32(const float* logits, float* out, int B, int T,
                                   int V, int blank, void* stream) {
  if (B <= 0 || T <= 0 || V <= 0 || blank < 0 || blank >= V || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(T, B);
  not_blank_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, out, T, V, blank);
  return (int)cudaGetLastError();
}
