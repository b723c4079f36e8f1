// Writes the attention kernels' dropout keep mask out, for Hopper (sm_90a).
//
// The six attention kernels regenerate the mask of dropout.cuh inside their
// tile loops and never store it. This entry point stores it, through the same
// `fill_keep_tile` and `keep_factor` they call, so that a check can hold the
// kernels' mask against `dropout_keep_reference` bit for bit. It is bound by
// the Philox integer operations (~18 an element), not by the one byte written.

#include <cuda_runtime.h>

#include "dropout.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;

// Even query tiles go through fill_keep_tile (the forward, dQ and dK/dV passes'
// way), odd ones through keep_factor (the rel-pos dP pass's way).
__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(const long long* __restrict__ seed, unsigned char* __restrict__ out,
                 int H, int TQ, int TK, float rate) {
  __shared__ float tile[kTile * (kTile + 1)];
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const unsigned long long sd = (unsigned long long)*seed;
  const bool by_tile = blockIdx.y % 2 == 0;
  if (by_tile)
    dropout::fill_keep_tile<kTile, kTile>(tile, kTile + 1, sd, b, h, q0, k0, rate, 1.f,
                                          threadIdx.x, kThreads);
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    if (q0 + r >= TQ || k0 + c >= TK) continue;
    const float f = by_tile ? tile[r * (kTile + 1) + c]
                            : dropout::keep_factor(sd, b, h, q0 + r, k0 + c, rate, 1.f);
    out[((size_t)bh * TQ + q0 + r) * TK + k0 + c] = f > 0.f ? 1 : 0;
  }
}

}  // namespace

// out: [B, H, TQ, TK] bytes, 1 where the element is kept; seed: one int64 on
// the device. Launches on `stream` without synchronising; returns the
// cudaError_t code.
extern "C" int dropout_keep_u8(const long long* seed, unsigned char* out, int B, int H,
                               int TQ, int TK, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((TK + kTile - 1) / kTile, (TQ + kTile - 1) / kTile, B * H);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  keep_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, out, H, TQ, TK, rate);
  return (int)cudaGetLastError();
}
