// The backward of attention under an arbitrary additive bias, bf16 q/k/v, for
// Hopper (sm_90a): the bf16 form of B6.
//
// Replaces the TPU kernel `_bias_bwd_kernel` / `_bias_bwd_rule` in
// streamspeech_tpu/ops/pallas_attention.py where a bf16 train step calls it
// (the unit decoder's cross-attention under the streaming mask with
// STREAMSPEECH_PALLAS_TRAIN=1, `models/layers.py:325-362`). The design, its
// products and its delta are attention_bwd_bf16.cuh's; this file instantiates
// its bias form for every head dim. The unit decoder's 48 keys are one key
// tile: the dQ pass sweeps them once, and the dK/dV pass splits the queries
// into groups whose fp32 partials a third kernel adds.

#include "attention_bwd_bf16.cuh"

// q: [B, H, TQ, D], k, v: [B, H, TK, D] contiguous bf16; bias: [B, TQ, TK]
// fp32; g: [B, H, TQ, D] fp32; stats: [B, H, TQ, 2] from
// bias_attention_bf16_train; seed: one int64 on the device (read when rate >
// 0); delta: a [B, H, TQ] fp32 scratch; part: [2, groups, B, H, TK, D] fp32
// when groups > 1 (else unused); dq: [B, H, TQ, D], dk, dv: [B, H, TK, D]
// bf16. D a multiple of 8 from 8 to 256; TQ, TK >= 1; groups from
// bias_attention_bwd_bf16_groups. Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int bias_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                       const float* bias, const float* g, const float* stats,
                                       const long long* seed, float* delta, float* part,
                                       void* dq, void* dk, void* dv, int B, int H, int TQ,
                                       int TK, int D, int groups, float scale, float rate,
                                       void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)bias % 4 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn_bwd_bf16::FullBias full{bias, TQ, TK};
#define CASE(d)                                                                          \
  case d:                                                                                \
    return attn_bwd_bf16::launch_bwd<d>(q, k, v, g, stats, seed, delta, part, groups, dq,   \
                                        dk, dv, full, B, H, TQ, TK, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The query-tile groups the backward takes at this shape; 0 for a head dim
// with no instance.
extern "C" int bias_attention_bwd_bf16_groups(int B, int H, int TQ, int TK, int D) {
#define CASE(d) \
  case d: return attn_bwd_bf16::groups<d>(B, H, TQ, TK);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return 0;
  }
#undef CASE
}
