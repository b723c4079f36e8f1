// The backward of attention under an arbitrary additive bias, bf16 q/k/v, for
// Hopper (sm_90a): the bf16 form of B6.
//
// Replaces the TPU kernel `_bias_bwd_kernel` / `_bias_bwd_rule` in
// streamspeech_tpu/ops/pallas_attention.py where a bf16 train step calls it
// (the unit decoder's cross-attention under the streaming mask with
// STREAMSPEECH_PALLAS_TRAIN=1, `models/layers.py:325-362`). The design, its
// products and its delta are attention_bwd_bf16.cuh's. Where TK <= 128 and
// D <= 64 (every path's shape: the MT decoder's keys padded to the 128 tile)
// it launches the one-kernel form: a cluster of blocks a (b, h), every key in
// one tile, delta local to the tile, dq written directly, dK and dV added over
// the cluster in rank order. Elsewhere (the wrapper's general case: TK > 128,
// or D > 64, whose K, V and stages do not fit one block's shared memory) the
// two-pass form of B4-bf16 with the bias tile beside each key tile.

#include "attention_bwd_bf16.cuh"

// the head dims of the one-kernel form
#define FUSED_HEAD_DIMS(CASE) CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64)

// q: [B, H, TQ, D], k, v: [B, H, TK, D] contiguous bf16; bias: [B, TQ, TK]
// fp32; g: [B, H, TQ, D] fp32; stats: [B, H, TQ, 2] from
// bias_attention_bf16_train; seed: one int64 on the device (read when rate >
// 0); delta: a [B, H, TQ] fp32 scratch (Σ_j p dp written there); where
// bias_attention_bwd_bf16_kernels gives 2 (else unused), gsplit: a [2, B, H,
// TQ, D] bf16 scratch and, at rate > 0, keep: a [B, H, TQ, 2 ceil(TK / 64)]
// uint32 scratch of the keep words; dq: [B, H, TQ, D], dk, dv: [B, H, TK, D]
// bf16. D a multiple of 8 from 8 to 256; TQ, TK >= 1. Launches on `stream`
// without synchronising; returns the cudaError_t code.
extern "C" int bias_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                       const float* bias, const float* g, const float* stats,
                                       const long long* seed, float* delta, void* gsplit,
                                       void* keep, void* dq, void* dk, void* dv, int B, int H,
                                       int TQ, int TK, int D, float scale, float rate,
                                       void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0 || rate < 0.f || rate >= 1.f ||
      (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)bias % (TK % 4 == 0 ? 16 : 4) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn_bwd_bf16::FullBias full{bias, TQ, TK};
  if (attn_bwd_bf16::fused(TK, D)) {
#define CASE(d)                                                                                \
  case d:                                                                                      \
    return attn_bwd_bf16::launch_fused<d>(q, k, v, g, stats, seed, delta, dq, dk, dv, full, B, \
                                          H, TQ, TK, scale, rate, s);
    switch (D) {
      FUSED_HEAD_DIMS(CASE)
      default: return (int)cudaErrorInvalidValue;
    }
#undef CASE
  }
#define CASE(d)                                                                            \
  case d:                                                                                  \
    return attn_bwd_bf16::launch_two_pass<d>(q, k, v, g, stats, seed, delta, gsplit,          \
                                             static_cast<uint32_t*>(keep), dq, dk, dv, full, B, \
                                             H, TQ, TK, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The CUDA kernels a call launches at this shape: 1 (the one-kernel form) or
// 2 (the two passes, whose gsplit and keep scratch the wrapper allocates); 0
// for a head dim with no instance.
extern "C" int bias_attention_bwd_bf16_kernels(int, int, int, int TK, int D) {
#define CASE(d) \
  case d: return attn_bwd_bf16::fused(TK, d) ? 1 : 2;
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return 0;
  }
#undef CASE
}
