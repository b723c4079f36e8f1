// Backward of the causal self-attention with a key-validity bias, fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_masked_bwd` / `_causal_bwd_kernel` in
// streamspeech_tpu/ops/pallas_attention.py (the unit decoder's causal
// self-attention in training). For the forward of masked_attention.cu,
//
//   out[i] = sum_j dropout(softmax_j(q_i . k_j * scale + kvb[j]
//                                    + (j <= i ? 0 : -1e9))) * v_j,
//
// it computes dq, dK and dV from g = d loss / d out; kvb is a constant. The
// body is attention_bwd.cuh with the causal bias, in its two-pass form: a
// delta pass, a dQ pass (a block per query tile, key tiles up to the
// diagonal, the longest blocks launched first) and a dK/dV pass (a block per
// key tile, query tiles from the diagonal down, the longest first); fully
// masked tiles are skipped. The K/V row at T = 1280 is 655 KB in fp32, so keys
// stream through shared memory as in the forward. Bound by operations: 33.6
// GFLOP of products against 169 MB at the train shape [8,8,1280,64], so the
// products run on the tensor cores as 3xTF32 `mma.sync`, with the next tile's
// `cp.async` loads under this one's products. Every row must have one allowed
// key at or below it (key 0 on the training path), the forward's own
// condition for skipping tiles.

#include "attention_bwd.cuh"

// q, k, v, g, out, dq, dk, dv: [B, H, T, D]; kvb: [B, T]; stats: [B, H, T, 2]
// (the forward's row max and 1 / sum); delta: [B, H, T] scratch; seed: one
// int64 on the device, read when rate > 0; all fp32 and contiguous, q, k, v
// and g 16-byte aligned. T a multiple of 64; D a multiple of 8 from 8 to 256.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int masked_attention_bwd_f32(const float* q, const float* k, const float* v,
                                        const float* kvb, const float* g,
                                        const float* out, const float* stats,
                                        const long long* seed, float* delta, float* dq,
                                        float* dk, float* dv, int B, int H, int T, int D,
                                        float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0 || H > 65535 || B > 65535 ||
      !(rate >= 0.f && rate < 1.f) || (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn_bwd::CausalBias bias{kvb, T};
#define CASE(d)                                                                       \
  case d:                                                                             \
    return attn_bwd::launch_bwd<d>(q, k, v, g, out, stats, seed, delta, nullptr, 0, dq, \
                                   dk, dv, bias, B, H, T, T, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
