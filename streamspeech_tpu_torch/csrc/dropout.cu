// Writes the attention kernels' dropout keep mask out, for Hopper (sm_90a).
//
// The six attention kernels regenerate the mask of dropout.cuh inside their
// tile loops and never store it. This entry point stores it, drawn by the
// device functions they all call (dropout::row_state for a row, then
// dropout::keep4 for each group of 4 columns), so that a check can hold the
// kernels' mask against `dropout_keep_reference` bit for bit.
//
// What bounds it: the Philox integer operations (~45 a group of 4 columns,
// read from the SASS), not the one byte written an element. A warp takes one
// row, lane l its column groups l, l + 32, ...: a lane's 4 columns leave as
// one 32-bit store and a warp's as 128 contiguous bytes.

#include <cuda_runtime.h>

#include "dropout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // rows a block, a warp each

__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(const long long* __restrict__ seed, unsigned char* __restrict__ out, int H,
                 int TQ, int TK, long long rows, uint32_t thr) {
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int bh = (int)(row / TQ), r = (int)(row % TQ);
  const dropout::Row st =
      dropout::row_state((unsigned long long)*seed, bh / H, bh % H, r);
  unsigned char* dst = out + row * TK;
  const bool words = TK % 4 == 0;  // rows start 4-byte aligned
  const int groups = (TK + 3) / 4;
  for (int cg = lane; cg < groups; cg += 32) {
    const uint32_t keep = dropout::keep4(st, (uint32_t)cg, thr);
    // bit e -> byte e (0 or 1)
    const uint32_t bytes = (keep & 1u) | (keep & 2u) << 7 | (keep & 4u) << 14 | (keep & 8u) << 21;
    if (words) {
      *reinterpret_cast<uint32_t*>(dst + 4 * cg) = bytes;
    } else {
      for (int e = 0; e < 4 && 4 * cg + e < TK; ++e) dst[4 * cg + e] = (bytes >> (8 * e)) & 1u;
    }
  }
}

}  // namespace

// out: [B, H, TQ, TK] bytes, 1 where the element is kept, 4-byte aligned;
// seed: one int64 on the device. Launches on `stream` without synchronising;
// returns the cudaError_t code.
extern "C" int dropout_keep_u8(const long long* seed, unsigned char* out, int B, int H,
                               int TQ, int TK, float rate, void* stream) {
  if (B <= 0 || H <= 0 || TQ <= 0 || TK <= 0 || !(rate >= 0.f && rate < 1.f) ||
      (uintptr_t)out % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * TQ;
  const long long blocks = (rows + kRows - 1) / kRows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  keep_mask_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, out, H, TQ, TK, rows, dropout::threshold(rate));
  return (int)cudaGetLastError();
}
