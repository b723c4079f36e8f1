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
// The body is attention_bwd.cuh (3xTF32 products on the tensor cores) with
// the bias read from device memory. While the keys fit one resident tile
// (TK <= 64 for D <= 120, 32 above; the unit decoder's TK = 48), the TPU
// kernel's single pass carries over: one block per (group of query tiles, h,
// b) keeps K and V in shared memory and does all five products, ten instead
// of the two passes' fourteen, then a small kernel adds the groups' dK/dV
// partials in order. Grouping the query tiles gives the bytes-bound work
// (2.4 GFLOP against 84 MB at the train shape) enough blocks: the dK/dV pass
// of the two-pass form had one per (h, b), 64 for 132 SMs. Above one tile it
// runs the two passes of the causal backward. Ragged TQ and TK are masked in
// the kernels; nothing is padded.

#include "attention_bwd.cuh"

// The number of query-tile groups bias_attention_bwd_f32 takes for this
// shape: 0 for the two-pass form, else the fused pass's G (its scratch is
// [2, G, B, H, TK, D] fp32). -1 for a head dim it does not take.
extern "C" int bias_attention_bwd_groups(int B, int H, int TQ, int TK, int D) {
#define CASE(d) \
  case d: return attn_bwd::fused_groups<d>(B, H, TQ, TK);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return -1;
  }
#undef CASE
}

// q, g, out, dq: [B, H, TQ, D]; k, v, dk, dv: [B, H, TK, D]; bias:
// [B, TQ, TK]; stats: [B, H, TQ, 2] (the forward's row max and 1 / sum);
// seed: one int64 on the device, read when rate > 0; groups: what
// bias_attention_bwd_groups gives; delta: [B, H, TQ] scratch when groups is
// 0, part: [2, groups, B, H, TK, D] scratch when it is not (the other may be
// null); all fp32 and contiguous, q, k, v and g 16-byte aligned. D a multiple
// of 8 from 8 to 256. Launches on `stream` without synchronising; returns the
// cudaError_t code.
extern "C" int bias_attention_bwd_f32(const float* q, const float* k, const float* v,
                                      const float* bias, const float* g,
                                      const float* out, const float* stats,
                                      const long long* seed, float* delta, float* part,
                                      float* dq, float* dk, float* dv, int B, int H, int TQ,
                                      int TK, int D, int groups, float scale, float rate,
                                      void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0 || !(rate >= 0.f && rate < 1.f) ||
      (rate > 0.f && seed == nullptr) || (groups == 0 && delta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn_bwd::FullBias full{bias, TQ, TK};
#define CASE(d)                                                                       \
  case d:                                                                             \
    return attn_bwd::launch_bwd<d>(q, k, v, g, out, stats, seed, delta, part, groups, \
                                   dq, dk, dv, full, B, H, TQ, TK, scale, rate, s);
  switch (D) {
    ATTN_FOR_EACH_HEAD_DIM(CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}
