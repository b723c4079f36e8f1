// Writes the attention kernels' dropout keep mask out, for Hopper (sm_90a).
//
// The six attention kernels regenerate the mask of dropout.cuh inside their
// tile loops and never store it. This entry point stores it, drawn on score
// fragments by the `keep_frag` they all call, so that a check can hold the
// kernels' mask against `dropout_keep_reference` bit for bit. It is bound by
// the Philox integer operations (~18 an element), not by the one byte written.

#include <cuda_runtime.h>

#include "tc_mma.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;

// Warp w draws rows 16 (w % 4).. of the 64 x 64 tile and its 8-column slabs
// from 32 (w / 4), as the tensor-core kernels draw their score fragments.
__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(const long long* __restrict__ seed, unsigned char* __restrict__ out,
                 int H, int TQ, int TK, float rate) {
  __shared__ float tile[kTile * (kTile + 1)];
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const unsigned long long sd = (unsigned long long)*seed;
  const int w = threadIdx.x / 32, g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  const int r0 = 16 * (w % 4);
  for (int c0 = 32 * (w / 4); c0 < 32 * (w / 4) + 32; c0 += 8) {
    float kf[4];
    tc::keep_frag(sd, b, h, q0 + r0 + g, k0 + c0, q, rate, 1.f, kf);
    for (int e = 0; e < 4; ++e)
      tile[(r0 + g + 8 * (e >> 1)) * (kTile + 1) + c0 + 2 * q + (e & 1)] = kf[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    if (q0 + r >= TQ || k0 + c >= TK) continue;
    out[((size_t)bh * TQ + q0 + r) * TK + k0 + c] = tile[r * (kTile + 1) + c] > 0.f ? 1 : 0;
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
