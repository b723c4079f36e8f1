// The attention kernels' dropout keep mask, for Hopper (sm_90a).
//
// Replaces `_dropout_keep` in streamspeech_tpu/ops/pallas_attention.py, which
// seeds the TPU's PRNG from (seed, b, h, q-block) and draws a [BQ, T] block of
// bits. On this card the forwards and the backwards tile the [TQ, TK] scores
// differently and all must regenerate the forward's mask, so the mask is a
// function of the element, not of a block:
//
//   bits = Philox4x32-10(key = seed, counter = (b, h, query row, key col / 4))
//   keep = ((bits[col % 4] >> 8) * 2^-24) >= rate    (pallas_attention.py:48-50)
//
// Philox is written out here (no cuRAND). It does not give the TPU's bits;
// `dropout_keep_reference` in kernels/attention.py gives these bits exactly.
// Nothing [B, H, TQ, TK] is stored: ~70 integer operations per 4 elements.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dropout {

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The four draws of key columns 4*colgroup ... 4*colgroup + 3 of one query row.
__device__ __forceinline__ void draw4(unsigned long long seed, int b, int h, int row,
                                      int colgroup, uint32_t out[4]) {
  philox4x32_10((uint32_t)b, (uint32_t)h, (uint32_t)row, (uint32_t)colgroup,
                (uint32_t)seed, (uint32_t)(seed >> 32), out);
}

__device__ __forceinline__ bool keeps(uint32_t bits, float rate) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f) >= rate;
}

}  // namespace dropout
