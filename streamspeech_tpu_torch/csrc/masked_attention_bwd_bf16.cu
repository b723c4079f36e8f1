// The backward of causal self-attention with a key-validity bias, bf16 q/k/v,
// for Hopper (sm_90a): the bf16 form of B4.
//
// Replaces the TPU kernel `_causal_bwd_kernel` / `_masked_bwd` in
// streamspeech_tpu/ops/pallas_attention.py where a bf16 train step calls it
// (the unit decoder's causal self-attention under STREAMSPEECH_PALLAS_TRAIN=1,
// `models/layers.py:289-323`). The design, its products and its delta are
// attention_bwd_bf16.cuh's; this file instantiates its two-pass form, causal,
// for every head dim: the keys span T / 64 tiles, so a deterministic dq
// (no atomics) needs the dQ pass apart from the dK/dV pass. Two CUDA kernels
// a call.

#include "attention_bwd_bf16.cuh"

// q, k, v: [B, H, T, D] contiguous bf16; kvb: [B, T] fp32 key bias; g: [B, H,
// T, D] fp32; stats: [B, H, T, 2] from masked_attention_bf16_train; seed: one
// int64 on the device (read when rate > 0); delta: a [B, H, T] fp32 scratch
// (the dQ pass writes Σ_j p dp there); gsplit: a [2, B, H, T, D] bf16 scratch
// (g's hi and lo parts); keep: a [B, H, T, T / 32] uint32 scratch of the keep
// words (rate > 0; else unused); dq, dk, dv: [B, H, T, D] bf16. T a multiple
// of 64, D a multiple of 8 from 8 to 256, TQ == TK == T. Launches on `stream`
// without synchronising; returns the cudaError_t code.
extern "C" int masked_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const float* kvb, const float* g,
                                         const float* stats, const long long* seed,
                                         float* delta, void* gsplit, void* keep, void* dq,
                                         void* dk, void* dv, int B, int H, int TQ, int TK,
                                         int D, float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TQ % 64 != 0 || TK != TQ || rate < 0.f || rate >= 1.f ||
      (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)kvb % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn_bwd_bf16::CausalBias bias{kvb, TQ};
#define CASE(d)                                                                            \
  case d:                                                                                  \
    return attn_bwd_bf16::launch_two_pass<d>(q, k, v, g, stats, seed, delta, gsplit,          \
                                             static_cast<uint32_t*>(keep), dq, dk, dv, bias, B, \
                                             H, TQ, TK, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The CUDA kernels a call launches at this shape (2; 0 for a head dim with no
// instance): the wrapper allocates gsplit and keep where it is 2.
extern "C" int masked_attention_bwd_bf16_kernels(int, int, int, int, int D) {
#define CASE(d) \
  case d: return 2;
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return 0;
  }
#undef CASE
}
