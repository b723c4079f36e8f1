// Backward of the attention under an arbitrary additive bias, fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bias_bwd_rule` / `_bias_bwd_kernel` in
// streamspeech_tpu/ops/pallas_attention.py (the unit decoder's wait-k
// cross-attention in training). For the forward of bias_attention.cu,
//
//   out[i] = sum_j dropout(softmax_j(q_i . k_j * scale + bias[b,i,j])) * v_j,
//
// it computes dq, dK and dV from g = d loss / d out; the bias is a constant.
// The body is attention_bwd.cuh with the bias read from device memory: a delta
// pass, a dQ pass and a dK/dV pass. At the unit decoder's TK = 48 the whole
// K/V would fit one block, and one pass could do all three products; the two
// passes of the causal backward are kept instead, so that one body serves
// both: the dK/dV pass is then one block per (h, b) walking 19 query tiles.
// Ragged TQ and TK are masked in the kernels; nothing is padded.

#include "attention_bwd.cuh"

// q, g, out, dq: [B, H, TQ, D]; k, v, dk, dv: [B, H, TK, D]; bias:
// [B, TQ, TK]; stats: [B, H, TQ, 2] (the forward's row max and 1 / sum);
// delta: [B, H, TQ] scratch; seed: one int64 on the device, read when
// rate > 0; all fp32 and contiguous. D a multiple of 8 from 8 to 256.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int bias_attention_bwd_f32(const float* q, const float* k, const float* v,
                                      const float* bias, const float* g,
                                      const float* out, const float* stats,
                                      const long long* seed, float* delta, float* dq,
                                      float* dk, float* dv, int B, int H, int TQ, int TK,
                                      int D, float scale, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0 || H > 65535 || B > 65535 ||
      !(rate >= 0.f && rate < 1.f) || (rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn_bwd::FullBias full{bias, TQ, TK};
#define CASE(d)                                                                       \
  case d:                                                                             \
    return attn_bwd::launch_bwd<d>(q, k, v, g, out, stats, seed, delta, dq, dk, dv,   \
                                   full, B, H, TQ, TK, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
