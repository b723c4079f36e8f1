// The backward of causal self-attention with a key-validity bias, bf16 q/k/v,
// for Hopper (sm_90a): the bf16 form of B4.
//
// Replaces the TPU kernel `_causal_bwd_kernel` / `_masked_bwd` in
// streamspeech_tpu/ops/pallas_attention.py where a bf16 train step calls it
// (the unit decoder's causal self-attention under STREAMSPEECH_PALLAS_TRAIN=1,
// `models/layers.py:289-323`). The design, its products and its delta are
// attention_bwd_bf16.cuh's; this file instantiates its causal form for every
// head dim.

#include "attention_bwd_bf16.cuh"

// q, k, v: [B, H, T, D] contiguous bf16; kvb: [B, T] fp32 key bias; g: [B, H,
// T, D] fp32; stats: [B, H, T, 2] from masked_attention_bf16_train; seed: one
// int64 on the device (read when rate > 0); delta: a [B, H, T] fp32 scratch;
// part: [2, groups, B, H, T, D] fp32 when groups > 1 (else unused); dq, dk,
// dv: [B, H, T, D] bf16. T a multiple of 64, D a multiple of 8 from 8 to 256,
// TQ == TK == T, groups from masked_attention_bwd_bf16_groups. Launches on
// `stream` without synchronising; returns the cudaError_t code.
extern "C" int masked_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const float* kvb, const float* g,
                                         const float* stats, const long long* seed,
                                         float* delta, float* part, void* dq, void* dk,
                                         void* dv, int B, int H, int TQ, int TK, int D,
                                         int groups, float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TQ % 64 != 0 || TK != TQ)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)kvb % 4 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn_bwd_bf16::CausalBias bias{kvb, TQ};
#define CASE(d)                                                                        \
  case d:                                                                              \
    return attn_bwd_bf16::launch_bwd<d>(q, k, v, g, stats, seed, delta, part, groups, dq, \
                                        dk, dv, bias, B, H, TQ, TK, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The query-tile groups the backward takes at this shape; 0 for a head dim
// with no instance.
extern "C" int masked_attention_bwd_bf16_groups(int B, int H, int TQ, int TK, int D) {
#define CASE(d) \
  case d: return attn_bwd_bf16::groups<d>(B, H, TQ, TK);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return 0;
  }
#undef CASE
}
