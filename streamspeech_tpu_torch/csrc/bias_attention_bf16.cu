// Attention under an arbitrary additive bias, bf16 q/k/v, for Hopper
// (sm_90a): the bf16 form of B5.
//
// Replaces the TPU kernel `bias_attention` / `_bias_kernel` in
// streamspeech_tpu/ops/pallas_attention.py where a bf16 model calls it (the
// unit decoder's cross-attention under the streaming mask, `models/layers.py:
// 325-362`). The design, its bound and its rounding are attention_bf16.cuh's;
// this file instantiates its bias form for every head dim, inference and
// training: the wgmma form where D <= 64 and TK <= 128 (every key in one tile:
// the unit decoder's keys padded to the 128 tile), the mma.sync form
// elsewhere (key tiles of TK rounded up to 16 while that is at most 64, 32
// above D = 128). One CUDA kernel a call.

#include "attention_bf16.cuh"

// q: [B, H, TQ, D], k, v: [B, H, TK, D] contiguous bf16; bias: [B, TQ, TK]
// fp32; out: [B, H, TQ, D] fp32; q, k, v and out 16-byte aligned (the bias
// too when TK % 4 == 0). D a multiple of 8 from 8 to 256; TQ, TK >= 1.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int bias_attention_bf16(const void* q, const void* k, const void* v,
                                   const float* bias, float* out, int B, int H, int TQ,
                                   int TK, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d) \
  case d: return bf16attn::launch<d, false>(q, k, v, bias, out, B, H, TQ, TK, scale, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The training form: as bias_attention_bf16, with dropout and row statistics
// as masked_attention_bf16_train; the fp32 form's arguments.
extern "C" int bias_attention_bf16_train(const void* q, const void* k, const void* v,
                                         const float* bias, float* out, const long long* seed,
                                         float* stats, int B, int H, int TQ, int TK, int D,
                                         float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d)                                                                          \
  case d:                                                                                \
    return bf16attn::launch<d, false, true>(q, k, v, bias, out, B, H, TQ, TK, scale, s, seed, \
                                            stats, rate);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// Whether a call at this shape takes the wgmma form (1) or the mma.sync form
// (0); -1 for a head dim with no instance.
extern "C" int bias_attention_bf16_wgmma(int TK, int D) {
#define CASE(d) \
  case d: return bf16attn::wgmma_form(false, TK, d) ? 1 : 0;
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return -1;
  }
#undef CASE
}
