// Causal self-attention with a key-validity bias, bf16 q/k/v, for Hopper
// (sm_90a): the bf16 form of B3.
//
// Replaces the TPU kernel `masked_attention` / `_causal_kernel` in
// streamspeech_tpu/ops/pallas_attention.py where a bf16 model calls it (the
// unit decoder's causal self-attention, `models/layers.py:289-323`). The
// design, its bound and its rounding are attention_bf16.cuh's; this file
// instantiates its causal form for every head dim, inference and training:
// the wgmma form up to D = 64, the mma.sync form above. One CUDA kernel a
// call.

#include "attention_bf16.cuh"

// q, k, v: [B, H, T, D] contiguous bf16; kvb: [B, T] fp32 additive key bias
// (0 valid, -1e9 masked); out: [B, H, T, D] fp32; all 16-byte aligned. T a
// multiple of 64, D a multiple of 8 from 8 to 256. Every row must have one
// allowed key (key 0 on the paths). Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int masked_attention_bf16(const void* q, const void* k, const void* v,
                                     const float* kvb, float* out, int B, int H, int T,
                                     int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d) \
  case d: return bf16attn::launch<d, true>(q, k, v, kvb, out, B, H, T, T, scale, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The training form: as masked_attention_bf16, with attention-probability
// dropout at `rate` (seed: one int64 on the device, read when rate > 0) and,
// when `stats` is not null, each row's (max in log2 units, 1 / sum) written to
// stats [B, H, T, 2] fp32 (8-byte aligned) for masked_attention_bwd_bf16.cu.
// The fp32 form's arguments.
extern "C" int masked_attention_bf16_train(const void* q, const void* k, const void* v,
                                           const float* kvb, float* out,
                                           const long long* seed, float* stats, int B,
                                           int H, int T, int D, float scale, float rate,
                                           void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(d)                                                                         \
  case d:                                                                               \
    return bf16attn::launch<d, true, true>(q, k, v, kvb, out, B, H, T, T, scale, s, seed, \
                                           stats, rate);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// Whether a call at this shape takes the wgmma form (1) or the mma.sync form
// (0); -1 for a head dim with no instance.
extern "C" int masked_attention_bf16_wgmma(int T, int D) {
#define CASE(d) \
  case d: return bf16attn::wgmma_form(true, T, d) ? 1 : 0;
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return -1;
  }
#undef CASE
}
