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
// Nothing [B, H, TQ, TK] is stored.
//
// What bounds it: integer operations, which issue at half the fp32 lane rate
// on this card. A draw (4 elements) is ten Philox rounds of two 32 x 32 -> 64
// bit multiplies and two three-input XORs. Two things cut that here, with the
// same bits:
//  - Row: of a row's counter only the column group changes along the row.
//    Round 1's products read c0 = b and c2 = row, round 2's first reads c0 of
//    round 1, round 3's second c2 of round 2: all fixed for the row. So a
//    lane computes them once (row_state) and a draw (keep4) starts in round 1
//    with one XOR, runs rounds 2 and 3 at one product each, and 7 full rounds.
//  - threshold: the fp32 compare is an integer compare of the bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dropout {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox-4x32 multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // its key increments

// keep = ((bits >> 8) * 2^-24 >= rate) in fp32 is bits >= threshold(rate):
// (bits >> 8) * 2^-24 is exact in fp32, so the compare is u >= rate * 2^24 over
// the integers u = bits >> 8, that is u >= ceil(rate * 2^24), and rate * 2^24
// is exact in double. A rate in [0, 1) gives ceil(...) <= 2^24 - 1, so the
// threshold shifted back by 8 bits fits 32; rate 0 gives 0, which keeps all.
inline uint32_t threshold(float rate) {
  return (uint32_t)ceil((double)rate * 16777216.0) << 8;
}

// (hi, lo) of m x: one IMAD.WIDE.U32. A 64-bit product in C++ leaves an add of
// a zero high word after it in the SASS; __umulhi and * are two multiplies
// (the mask writer read 5 % slower with them).
__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t x, uint32_t& hi, uint32_t& lo) {
  asm("{\n\t.reg .u64 p;\n\tmul.wide.u32 p, %2, %3;\n\tmov.b64 {%1, %0}, p;\n\t}"
      : "=r"(hi), "=r"(lo)
      : "r"(x), "r"(m));
}

// What a draw of one (seed, b, h, row) needs beyond its column group: the
// words its rounds 1-4 take from rounds before that do not depend on it, each
// already XORed with its round key, and the key.
struct Row {
  uint32_t x2;   // round 1: c2 = x2 ^ colgroup
  uint32_t y1;   // round 2: c0 = hi(M1 c2) ^ y1
  uint32_t y2;   // round 3: c0 = c1 ^ y2
  uint32_t y3;   // round 3: c2 = hi(M0 c0) ^ y3
  uint32_t y4;   // round 4: c0 = hi(M1 c2) ^ y4
  uint32_t k0, k1;
};

__device__ __forceinline__ Row row_state(unsigned long long seed, int b, int h, int row) {
  Row r;
  r.k0 = (uint32_t)seed;
  r.k1 = (uint32_t)(seed >> 32);
  uint32_t hb, lb, hr, lr;
  mulhilo(kM0, (uint32_t)b, hb, lb);
  mulhilo(kM1, (uint32_t)row, hr, lr);
  // round 1: (b, h, row, cg) -> (hr ^ h ^ k0, lr, hb ^ cg ^ k1, lb)
  const uint32_t c0 = hr ^ (uint32_t)h ^ r.k0;
  r.x2 = hb ^ r.k1;
  r.y1 = lr ^ (r.k0 + kW0);
  // round 2: c0 and c3 = lb are fixed, so c2 and c3 after it are
  uint32_t h0, l0;
  mulhilo(kM0, c0, h0, l0);
  const uint32_t c2 = h0 ^ lb ^ (r.k1 + kW1);
  // round 3 multiplies that fixed c2
  uint32_t h1, l1;
  mulhilo(kM1, c2, h1, l1);
  r.y2 = h1 ^ (r.k0 + 2 * kW0);
  r.y3 = l0 ^ (r.k1 + 2 * kW1);
  r.y4 = l1 ^ (r.k0 + 3 * kW0);
  return r;
}

// Bit e (e < 4) set where column 4 cg + e of the row is kept: word e of
// Philox4x32-10(seed, (b, h, row, cg)) >= thr.
__device__ __forceinline__ uint32_t keep4(const Row& r, uint32_t cg, uint32_t thr) {
  uint32_t c0, c1, c2, c3, hi, lo;
  // rounds 1 and 2
  mulhilo(kM1, r.x2 ^ cg, hi, c1);
  c0 = hi ^ r.y1;
  // round 3: c2 (fixed) was multiplied in row_state
  mulhilo(kM0, c0, hi, lo);
  c0 = c1 ^ r.y2;
  c2 = hi ^ r.y3;
  c3 = lo;
  // round 4: c1 is the fixed l1, folded into y4
  {
    uint32_t h0, l0, h1, l1;
    mulhilo(kM0, c0, h0, l0);
    mulhilo(kM1, c2, h1, l1);
    c0 = h1 ^ r.y4;
    c1 = l1;
    c2 = h0 ^ c3 ^ (r.k1 + 3 * kW1);
    c3 = l0;
  }
#pragma unroll
  for (uint32_t k = 4; k < 10; ++k) {
    uint32_t h0, l0, h1, l1;
    mulhilo(kM0, c0, h0, l0);
    mulhilo(kM1, c2, h1, l1);
    c0 = h1 ^ c1 ^ (r.k0 + k * kW0);
    c1 = l1;
    c2 = h0 ^ c3 ^ (r.k1 + k * kW1);
    c3 = l0;
  }
  return (uint32_t)(c0 >= thr) | (uint32_t)(c1 >= thr) << 1 | (uint32_t)(c2 >= thr) << 2 |
         (uint32_t)(c3 >= thr) << 3;
}

}  // namespace dropout
