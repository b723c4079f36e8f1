"""Latency and issue rate of TF32 ``mma.sync.m16n8k8`` on one CUDA card.

    python3 tools/bench_mma_tf32.py

The attention kernels run every product as three of these (3xTF32,
``csrc/tc_mma.cuh``). The tool builds a small CUDA program with nvcc (into
``build/bench_mma_tf32/``) whose kernel issues, per warp, ``chains``
independent accumulator chains of 4096 dependent products each, and reports
per launch shape: cycles a product per warp (``clock64``; one chain gives
the latency), and the card's TF32 rate from CUDA-event time. One JSON line a
shape, then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from streamspeech_tpu_torch.kernels import build  # noqa: E402

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int N>
__global__ void chains(float* out, long long* cycles, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x * 2e-3f + i);
  float c[N][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(c[j], a, b);
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < N; ++j)
    for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x % 32 == 0) cycles[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = t1 - t0;
}

template <int N>
void run(int blocks, int threads) {
  const int iters = 4096;
  float* out;
  long long* cycles;
  cudaMalloc(&out, blocks * threads * sizeof(float));
  cudaMalloc(&cycles, blocks * threads / 32 * sizeof(long long));
  chains<N><<<blocks, threads>>>(out, cycles, iters);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<N><<<blocks, threads>>>(out, cycles, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c0 = 0;
  cudaMemcpy(&c0, cycles, sizeof(c0), cudaMemcpyDeviceToHost);
  const double products = (double)blocks * threads / 32 * N * iters;
  printf("{\"chains\": %d, \"blocks\": %d, \"warps_a_block\": %d, "
         "\"cycles_a_product_per_warp\": %.3f, \"ms\": %.4f, \"tf32_tflops\": %.1f}\n",
         N, blocks, threads / 32, (double)c0 / ((double)N * iters), ms,
         products * 16 * 8 * 8 * 2 / (ms * 1e-3) / 1e12);
  cudaFree(out);
  cudaFree(cycles);
}

int main() {
  run<1>(1, 32);      // one chain: the latency
  run<4>(1, 32);      // one warp, four chains
  run<8>(1, 32);
  run<8>(1, 128);     // one warp a sub-partition
  run<8>(1, 256);     // two
  run<8>(132, 128);   // every SM, one warp a sub-partition
  run<8>(132, 256);   // every SM, two
  run<16>(132, 256);
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
"""


def main():
    out = ROOT / "build" / "bench_mma_tf32"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bench.cu").write_text(SOURCE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(out / "bench"), str(out / "bench.cu")], check=True, timeout=300)
    result = subprocess.run([str(out / "bench")], capture_output=True, text=True, check=True,
                            timeout=120)
    for line in result.stdout.splitlines():
        print(json.dumps(json.loads(line)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
