// CTC not-blank posterior of one aux head, fp32 or bf16 logits, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `not_blank_probs_pallas` / `_nb_kernel` in
// streamspeech_tpu/ops/pallas_policy.py (the streaming mask's input, built
// from the ASR and ST CTC heads). For logits x [B, T, V] it computes, with
// p_t = softmax(x[b, t]) in fp32 and p_{-1} = 0:
//
//   out[b, t] = 1 - p_t[blank] - (sum_v p_t[v] p_{t-1}[v]
//                                 - p_t[blank] p_{t-1}[blank])
//
// What bounds it on this card: device memory. The work is a few flops per
// logit, the output only [B, T]: the least the card can do is read the logits
// once (B*T*V*4 bytes; 6.1 MB per head at [1, 256, 6000]). The TPU kernel
// walks time in order and carries the previous posterior row in scratch;
// blocks on the card run in no order, so nothing is carried: the warps of a
// row read rows t and t - 1 themselves, in one pass. Each lane keeps, for its
// columns, an online max and sum of exponentials of each row and the dot of
// the two rows' exponentials; when a max rises, the sum and the dot it
// touches are rescaled by exp(old max - new max). Lanes merge by shuffles
// (a butterfly: xor 16, 8, 4, 2, 1), then the warps of a row in order through
// shared memory. Loads are 16 bytes (V % 4 == 0 and a 16-byte aligned base;
// otherwise 4), kUnroll of them in flight per row and lane. Consecutive rows
// go to consecutive warps, so row t - 1 comes again from L1/L2, not device
// memory. Nothing of size [B, T, V] is written.
//
// A row's columns go to WPR warps (1, 2, 4 or 8; the launcher picks the
// fewest that put 8 warps an SM in flight, while each warp keeps two rounds
// of kUnroll loads): one warp a row at [8, 256, 6000], four at [1, 256, 6000]
// on an H100's 132 SMs. tools/sweep_dropout.py timed 1, 2, 4 and 8 at both
// by building with -DNOT_BLANK_WPR=<n>, a define for that sweep alone.
//
// bf16 logits (a bf16 model's CTC heads; the TPU kernel widens any float
// input in VMEM, pallas_policy.py:76): the same pass, a 16-byte load carrying
// 8 logits, each widened to fp32 in registers (exact: a bf16 is the top half
// of an fp32); the bytes, and so the bound, are halved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"

#ifndef NOT_BLANK_WPR
#define NOT_BLANK_WPR 0  // sweep only: warps a row at every shape; 0: the launcher's rule
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads of each row in flight per lane
constexpr int kWarpsAnSm = 8;  // warps in flight an SM that the launcher aims for

// A partial over some columns: row t's max and sum of exp(x - mc), row t-1's
// likewise, and sum exp(x_t - mc) exp(x_{t-1} - mp).
struct Online {
  float mc, sc, mp, sp, dot;
};

// exp(m - m_new), exactly 1 where they are equal (both -inf included)
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == m_new ? 1.f : expf(m - m_new);
}

// Fold N columns (xc of row t, xp of row t - 1; -inf where there is none)
// into o, in order.
template <int N>
__device__ __forceinline__ void fold(Online& o, const float (&xc)[N], const float (&xp)[N]) {
  float mc = o.mc, mp = o.mp;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mc = fmaxf(mc, xc[i]);
    mp = fmaxf(mp, xp[i]);
  }
  const float ac = rescale(o.mc, mc), ap = rescale(o.mp, mp);
  float sc = o.sc * ac, sp = o.sp * ap, dot = o.dot * (ac * ap);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ec = expf(xc[i] - mc), ep = expf(xp[i] - mp);
    sc += ec;
    sp += ep;
    dot = fmaf(ec, ep, dot);
  }
  o = {mc, sc, mp, sp, dot};
}

__device__ __forceinline__ Online merge(const Online& a, const Online& b) {
  const float mc = fmaxf(a.mc, b.mc), mp = fmaxf(a.mp, b.mp);
  const float ca = rescale(a.mc, mc), cb = rescale(b.mc, mc);
  const float pa = rescale(a.mp, mp), pb = rescale(b.mp, mp);
  return {mc, a.sc * ca + b.sc * cb, mp, a.sp * pa + b.sp * pb,
          a.dot * (ca * pa) + b.dot * (cb * pb)};
}

// One logit, widened to fp32.
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Columns W j .. W j + W - 1 of a row, -inf past n units of W logits: a
// 16-byte load (W = 4 floats or 8 bf16) or one logit (W = 1).
template <int W, class L>
__device__ __forceinline__ void load(const L* row, int j, int n, float* x) {
  if constexpr (W == 1) {
    x[0] = j < n ? ld1(row + j) : -INFINITY;
  } else if constexpr (W == 4) {
    float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    if (j < n) v = __ldg(reinterpret_cast<const float4*>(row) + j);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    static_assert(W == 8, "a 16-byte load holds 4 floats or 8 bf16");
    if (j < n) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + j);
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // the low half is the first logit
        x[2 * i] = __uint_as_float(words[i] << 16);
        x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = -INFINITY;
    }
  }
}

// W: logits a load (16 bytes when V % (16 / sizeof(L)) == 0 and the logits
// are 16-byte aligned; else 1).
template <int W, class L>
__global__ void __launch_bounds__(kThreads)
not_blank_kernel(const L* __restrict__ logits, float* __restrict__ out, long long rows,
                 int T, int V, int blank, int wpr) {
  __shared__ Online part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, slice = warp % wpr;
  const long long row = (long long)blockIdx.x * (kWarps / wpr) + warp / wpr;
  const bool live = row < rows;
  const int t = live ? (int)(row % T) : 0;
  const L* cur = logits + (live ? row : 0) * V;
  const L* prev = t > 0 ? cur - V : cur;  // t = 0: read, never used

  // the blank logits the last lane-0 step needs, fetched before the pass
  const bool last = live && lane == 0 && slice == 0;
  const float xb = last ? ld1(cur + blank) : 0.f, xpb = last ? ld1(prev + blank) : 0.f;

  Online o = {-INFINITY, 0.f, -INFINITY, 0.f, 0.f};
  if (live) {
    const int n = V / W, stride = 32 * wpr;
    for (int i = 32 * slice + lane; i < n; i += kUnroll * stride) {
      float xc[kUnroll * W], xp[kUnroll * W];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<W>(cur, i + u * stride, n, xc + u * W);
        load<W>(prev, i + u * stride, n, xp + u * W);
      }
      fold(o, xc, xp);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Online x = {__shfl_xor_sync(0xffffffffu, o.mc, off),
                      __shfl_xor_sync(0xffffffffu, o.sc, off),
                      __shfl_xor_sync(0xffffffffu, o.mp, off),
                      __shfl_xor_sync(0xffffffffu, o.sp, off),
                      __shfl_xor_sync(0xffffffffu, o.dot, off)};
    o = merge(o, x);
  }
  if (wpr > 1) {  // the row's warps in order
    if (lane == 0) part[warp] = o;
    __syncthreads();
    if (lane == 0 && slice == 0)
      for (int s = 1; s < wpr; ++s) o = merge(o, part[warp + s]);
  }
  if (last) {
    const float blank_p = expf(xb - o.mc) / o.sc;
    float repeat = 0.f;
    if (t > 0) {
      const float prev_blank = expf(xpb - o.mp) / o.sp;
      repeat = o.dot / (o.sc * o.sp) - blank_p * prev_blank;
    }
    out[row] = 1.f - (repeat + blank_p);
  }
}

// Warps a row: the fewest (1, 2, 4, 8) that put kWarpsAnSm warps an SM on
// the card, while each warp keeps two rounds of kUnroll loads of the row's n
// units.
int warps_a_row(long long rows, int n) {
  if (NOT_BLANK_WPR > 0) return NOT_BLANK_WPR;
  const long long in_flight = (long long)kWarpsAnSm * tc::sm_count();
  int wpr = 1;
  while (wpr < kWarps && rows * wpr < in_flight && n >= 2 * kUnroll * 32 * (2 * wpr))
    wpr *= 2;
  return wpr;
}

// L: the logits' type, float or __nv_bfloat16.
template <class L>
int run(const L* logits, float* out, int B, int T, int V, int blank, void* stream) {
  if (B <= 0 || T <= 0 || V <= 0 || blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(L);  // logits a 16-byte load
  const long long rows = (long long)B * T;
  const bool vec = V % kVec == 0 && (uintptr_t)logits % 16 == 0;
  // the rule counts 4 logits a unit for both types: bf16's loads carry 8, but
  // at [1,256,6000] 4 warps a row (0.0068 ms) beat the 2 its loads would give
  // (0.0076), and at [8,256,6000] one warp stays the fastest
  // (tools/sweep_bf16.py)
  const int wpr = warps_a_row(rows, vec ? V / 4 : V);
  if (wpr < 1 || wpr > kWarps || kWarps % wpr != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows * wpr + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    not_blank_kernel<kVec, L><<<(unsigned)blocks, kThreads, 0, s>>>(logits, out, rows, T, V,
                                                                   blank, wpr);
  else
    not_blank_kernel<1, L><<<(unsigned)blocks, kThreads, 0, s>>>(logits, out, rows, T, V,
                                                                blank, wpr);
  return (int)cudaGetLastError();
}

}  // namespace

// logits: [B, T, V] contiguous fp32; out: [B, T] fp32; 0 <= blank < V.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int not_blank_probs_f32(const float* logits, float* out, int B, int T,
                                   int V, int blank, void* stream) {
  return run(logits, out, B, T, V, blank, stream);
}

// The same for [B, T, V] contiguous bf16 logits.
extern "C" int not_blank_probs_bf16(const void* logits, float* out, int B, int T,
                                    int V, int blank, void* stream) {
  return run(static_cast<const __nv_bfloat16*>(logits), out, B, T, V, blank, stream);
}
