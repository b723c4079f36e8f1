// CTC alpha and beta recursions over the blank-interleaved extended label
// sequence, fp32, for Hopper (sm_90a).
//
// Replace the TPU kernels `_run_alpha` / `_alpha_kernel` (B8) and
// `_run_beta_grad` / `_beta_kernel` (B9) in streamspeech_tpu/ops/pallas_ctc.py,
// the forward and backward of the criterion's CTC losses. Inputs are the
// gathered extended-state log-probs lp[b, t, s] (S = 2N + 1) and additive fp32
// masks (0 or NNEG), so the kernels never index with labels:
//   skip[b, s]  0 where state s may come from s - 2 (a label change), else NNEG
//   init[b, s]  0 at the states a path may start in, else NNEG
//   end[b, s]   0 at the states a path may end in, else NNEG
//   valid[b, t] 1 for a real frame, 0 for padding (the state holds)
//
// ctc_alpha:  alpha[0] = init + lp[0]; for t >= 1 on a valid frame
//   alpha[t, s] = lse(alpha[t-1, s], alpha[t-1, s-1], alpha[t-1, s-2] + skip[s])
//                 + lp[t, s];
//   every alpha[t] is written (the backward reads them).
// ctc_beta_grad: beta[T-1] = end; walking t down, on a valid frame
//   grad[t, s] = -exp(min(alpha[t, s] + beta[t, s] + zbias, 0))   (else 0)
//   beta[t-1, s] = lse(q[s], q[s+1], q[s+2] + skip[s+2]), q = beta[t] + lp[t];
//   zbias = -logZ of the row, or NNEG for an impossible alignment, whose grad
//   is then exactly 0.
// lse is the TPU kernel's `_lse3`, NNEG guard included; expf/logf are the
// accurate ones (no fast-math).
//
// What bounds it on this card: neither bytes nor operations. The recursion is
// a chain of T dependent steps, each a few flops per state; the unit CTC of
// the train step (B=8, T=1200, S=513) moves ~39 MB (12 us at 3.35 TB/s) and
// does ~60 MFLOP. The TPU runs the time blocks in order on one core and
// carries alpha [B, S] in VMEM between grid steps; blocks on the card run in
// no order, so the time loop lives inside the block: one block per batch row,
// the S states spread over up to 256 threads (K states each), the row's own
// alpha (beta) in registers, the neighbours' values exchanged through a
// double-buffered shared-memory row with one __syncthreads() per frame. The
// next frame's lp (and alpha) are loaded while this frame computes. With 8 to
// 16 rows the kernels use 8 to 16 SMs and their time is T times the latency
// of one step; a warp per row with shuffles and no block barrier is the next
// step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNneg = -1e30f;   // the TPU kernel's NNEG
constexpr int kMaxThreads = 256;
constexpr int kMaxStates = 16 * kMaxThreads;

__device__ __forceinline__ float lse3(float a0, float a1, float a2) {
  const float m = fmaxf(fmaxf(a0, a1), a2);
  const float out = m + logf(expf(a0 - m) + expf(a1 - m) + expf(a2 - m));
  return m <= kNneg / 2 ? kNneg : out;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ initmask,
                 const float* __restrict__ skipmask, const float* __restrict__ valid,
                 float* __restrict__ alpha, int T, int S) {
  extern __shared__ float rows[];  // [2][S]: alpha of the previous frame
  const int b = blockIdx.x, nt = blockDim.x;
  const float* lp_b = lp + (size_t)b * T * S;
  const float* valid_b = valid + (size_t)b * T;
  float* alpha_b = alpha + (size_t)b * T * S;

  float skip[K], cur[K], next_lp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * nt;
    skip[k] = s < S ? skipmask[(size_t)b * S + s] : kNneg;
    cur[k] = s < S ? initmask[(size_t)b * S + s] + lp_b[s] : kNneg;
    next_lp[k] = (s < S && T > 1) ? lp_b[S + s] : 0.f;
    if (s < S) {
      rows[s] = cur[k];
      alpha_b[s] = cur[k];
    }
  }
  float next_valid = T > 1 ? valid_b[1] : 0.f;
  __syncthreads();

  int p = 0;
  for (int t = 1; t < T; ++t) {
    float lp_t[K];
#pragma unroll
    for (int k = 0; k < K; ++k) lp_t[k] = next_lp[k];
    const float v = next_valid;
    if (t + 1 < T) {  // the next frame's loads fly while this one computes
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = threadIdx.x + k * nt;
        if (s < S) next_lp[k] = lp_b[(size_t)(t + 1) * S + s];
      }
      next_valid = valid_b[t + 1];
    }
    const float* prev = rows + p * S;
    float* out = rows + (p ^ 1) * S;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * nt;
      if (s < S) {
        const float a1 = s >= 1 ? prev[s - 1] : kNneg;
        const float a2 = (s >= 2 ? prev[s - 2] : kNneg) + skip[k];
        const float a = lse3(cur[k], a1, a2) + lp_t[k];
        cur[k] = v > 0.f ? a : cur[k];
        out[s] = cur[k];
        alpha_b[(size_t)t * S + s] = cur[k];
      }
    }
    __syncthreads();
    p ^= 1;
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_beta_grad_kernel(const float* __restrict__ lp, const float* __restrict__ endmask,
                     const float* __restrict__ skipmask, const float* __restrict__ zbias,
                     const float* __restrict__ valid, const float* __restrict__ alpha,
                     float* __restrict__ grad, int T, int S) {
  extern __shared__ float smem[];  // [2][S] q = beta + lp of this frame, then skip [S]
  float* skip_s = smem + 2 * S;
  const int b = blockIdx.x, nt = blockDim.x;
  const float* lp_b = lp + (size_t)b * T * S;
  const float* alpha_b = alpha + (size_t)b * T * S;
  const float* valid_b = valid + (size_t)b * T;
  float* grad_b = grad + (size_t)b * T * S;
  const float zb = zbias[b];

  float beta[K], next_lp[K], next_alpha[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * nt;
    beta[k] = s < S ? endmask[(size_t)b * S + s] : kNneg;
    if (s < S) {
      skip_s[s] = skipmask[(size_t)b * S + s];
      next_lp[k] = lp_b[(size_t)(T - 1) * S + s];
      next_alpha[k] = alpha_b[(size_t)(T - 1) * S + s];
    }
  }
  float next_valid = valid_b[T - 1];
  __syncthreads();

  int p = 0;
  for (int t = T - 1; t >= 0; --t) {
    float lp_t[K], alpha_t[K], q_own[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lp_t[k] = next_lp[k];
      alpha_t[k] = next_alpha[k];
    }
    const float v = next_valid;
    if (t > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = threadIdx.x + k * nt;
        if (s < S) {
          next_lp[k] = lp_b[(size_t)(t - 1) * S + s];
          next_alpha[k] = alpha_b[(size_t)(t - 1) * S + s];
        }
      }
      next_valid = valid_b[t - 1];
    }
    float* q = smem + p * S;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * nt;
      if (s < S) {
        const float gamma = expf(fminf(alpha_t[k] + beta[k] + zb, 0.f));
        grad_b[(size_t)t * S + s] = v > 0.f ? -gamma : 0.f;
        q_own[k] = beta[k] + lp_t[k];
        q[s] = q_own[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * nt;
      if (s < S) {
        const float q1 = s + 1 < S ? q[s + 1] : kNneg;
        const float q2 = s + 2 < S ? q[s + 2] + skip_s[s + 2] : kNneg;
        const float nb = lse3(q_own[k], q1, q2);
        beta[k] = v > 0.f ? nb : beta[k];
      }
    }
    p ^= 1;
  }
}

// threads for S states: a multiple of 32, at most 256; K states per thread
inline void plan(int S, int* threads, int* k) {
  int nt = ((S + 31) / 32) * 32;
  if (nt > kMaxThreads) nt = kMaxThreads;
  *threads = nt;
  *k = (S + nt - 1) / nt;
}

template <template <int> class Launch, typename... Args>
int dispatch(int k, Args... args) {
  if (k <= 1) return Launch<1>::run(args...);
  if (k <= 2) return Launch<2>::run(args...);
  if (k <= 4) return Launch<4>::run(args...);
  if (k <= 8) return Launch<8>::run(args...);
  return Launch<16>::run(args...);
}

template <int K>
struct AlphaLaunch {
  static int run(dim3 grid, int threads, size_t smem, cudaStream_t stream, const float* lp,
                 const float* initmask, const float* skipmask, const float* valid,
                 float* alpha, int T, int S) {
    ctc_alpha_kernel<K><<<grid, threads, smem, stream>>>(lp, initmask, skipmask, valid,
                                                         alpha, T, S);
    return (int)cudaGetLastError();
  }
};

template <int K>
struct BetaLaunch {
  static int run(dim3 grid, int threads, size_t smem, cudaStream_t stream, const float* lp,
                 const float* endmask, const float* skipmask, const float* zbias,
                 const float* valid, const float* alpha, float* grad, int T, int S) {
    ctc_beta_grad_kernel<K><<<grid, threads, smem, stream>>>(
        lp, endmask, skipmask, zbias, valid, alpha, grad, T, S);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// lp, alpha: [B, T, S]; initmask, skipmask: [B, S]; valid: [B, T]; all
// contiguous fp32; 1 <= S <= 4096, T >= 1. Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int ctc_alpha_f32(const float* lp, const float* initmask, const float* skipmask,
                             const float* valid, float* alpha, int B, int T, int S,
                             void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > kMaxStates) return (int)cudaErrorInvalidValue;
  int threads, k;
  plan(S, &threads, &k);
  const size_t smem = 2 * (size_t)S * sizeof(float);
  return dispatch<AlphaLaunch>(k, dim3(B), threads, smem,
                               static_cast<cudaStream_t>(stream), lp, initmask,
                               skipmask, valid, alpha, T, S);
}

// lp, alpha, grad: [B, T, S]; endmask, skipmask: [B, S]; zbias: [B];
// valid: [B, T]; all contiguous fp32; the same limits as ctc_alpha_f32.
extern "C" int ctc_beta_grad_f32(const float* lp, const float* endmask,
                                 const float* skipmask, const float* zbias,
                                 const float* valid, const float* alpha, float* grad,
                                 int B, int T, int S, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > kMaxStates) return (int)cudaErrorInvalidValue;
  int threads, k;
  plan(S, &threads, &k);
  const size_t smem = 3 * (size_t)S * sizeof(float);
  return dispatch<BetaLaunch>(k, dim3(B), threads, smem,
                              static_cast<cudaStream_t>(stream), lp, endmask, skipmask,
                              zbias, valid, alpha, grad, T, S);
}
