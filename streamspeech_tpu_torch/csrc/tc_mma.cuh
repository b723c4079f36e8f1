// The tensor-core and copy helpers the attention kernels share, for Hopper
// (sm_90a): fp32-faithful products on TF32 `mma.sync` (3xTF32), 16-byte
// `cp.async` tile loads, dropout keep bits drawn on accumulator fragments,
// the dynamic shared-memory limit and the device's SM count. Included by
// attention_bwd.cuh (B4, B6), masked_attention.cu (B3), relpos_attention.cu
// (B1), relpos_attention_bwd.cu (B2), bias_attention.cu (B5) and not_blank.cu
// (B7, for the SM count).
//
// Fragments of `mma.sync.m16n8k8` with TF32 inputs; lane = 4 g + q, g the
// group (0..7), q the thread in it (0..3):
//   A (16 x 8, row):  a0 (g, q)   a1 (g + 8, q)   a2 (g, q + 4)   a3 (g + 8, q + 4)
//   B (8 x 8, col):   b0 (q, g)   b1 (q + 4, g)
//   C (16 x 8):       c0 (g, 2q)  c1 (g, 2q + 1)  c2 (g + 8, 2q)  c3 (g + 8, 2q + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout.cuh"

namespace tc {

constexpr int kMaxDevices = 64;
// Head dims up to this take a second copy of the score stage of B2, B3 and
// B4 for dropout, in which whether to draw is known at compile time (one copy
// that tests the rate at run time read 3-12 % slower at rate 0 at D = 64);
// wider ones keep the single copy, which holds the build's time. B1, B5 and
// B6 keep one copy at every D: they are short, and a launch of the host-bound
// paths starts with its code and data cold, where their second copy read
// 0.002-0.005 ms slower (tools/sweep_dropout.py, step_like_ms). The define is
// for that sweep alone: ATTN_DROPOUT_COPY_MAX_D=0 builds no copy anywhere.
#ifndef ATTN_DROPOUT_COPY_MAX_D
#define ATTN_DROPOUT_COPY_MAX_D 64
#endif
constexpr int kDropoutCopyMaxD = ATTN_DROPOUT_COPY_MAX_D;

// A compile-time flag as a value.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// f(Flag<true>{}) where head dim D has a copy for dropout and `drop`; else
// f(Flag<false>{}).
template <int D, class Fn>
__device__ __forceinline__ void with_draws(bool drop, Fn&& f) {
  if constexpr (D <= kDropoutCopyMaxD) {
    if (drop) {
      f(Flag<true>{});
      return;
    }
  }
  f(Flag<false>{});
}
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared-memory limit

// Raise a kernel's dynamic shared-memory limit once per device.
template <class Kernel>
int raise_smem(Kernel kernel, size_t smem, bool* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  return 0;
}

// The multiprocessors of the current device, asked once per device.
inline int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && count[dev] > 0) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) count[dev] = n;
  return n;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a [n, D] matrix into a [ROWS][LD] tile by 16-byte
// cp.async from `nthreads` threads, zeros for rows outside [0, n).
template <int ROWS, int D, int LD>
__device__ __forceinline__ void async_load(float* tile, const float* __restrict__ src, int r0,
                                           int n, int tid, int nthreads) {
  constexpr int CH = D / 4;
  for (int i = tid; i < ROWS * CH; i += nthreads) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool in = r0 + r >= 0 && r0 + r < n;
    cp_async16(tile + r * LD + c, in ? src + (size_t)(r0 + r) * D + c : src, in);
  }
}

// fp32 -> tf32 rounded to nearest, ties away from zero; the low 13 bits are 0
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, hi tf32; lo = x - hi (exact in fp32) is handed over as it
// is: the tensor core reads a .tf32 operand's top 19 bits and ignores the
// low 13, so lo enters truncated, 2^-10 of |lo| <= 2^-21 |x| off, and the
// cvt a rounded lo would cost is saved (one instruction of three a split)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b on the tensor cores, m16n8k8, tf32 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: c += a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first; the
// dropped a_lo b_lo is 2^-22 of the product. The three go into a zeroed
// accumulator and the running sum c takes them by an fp32 add: the tensor
// core's own accumulation does not round as an fp32 add does, so carrying c
// through it over a 64-deep contraction would add its error at every k-step
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     const uint32_t bh[2], const uint32_t bl[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, al, bh);
  mma(t, ah, bl);
  mma(t, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// A fragment (rows m0.., depth k0..) of a matrix stored as its tile's rows
// (A[m][k] = T[m][k]), or as its tile's columns (A[m][k] = T[k][m]), split.
template <bool kTransposed>
__device__ __forceinline__ void load_a(const float* t, int ld, int m0, int k0, int g, int q,
                                       uint32_t hi[4], uint32_t lo[4]) {
  float x[4];
  if (kTransposed) {
    x[0] = t[(k0 + q) * ld + m0 + g];
    x[1] = t[(k0 + q) * ld + m0 + g + 8];
    x[2] = t[(k0 + q + 4) * ld + m0 + g];
    x[3] = t[(k0 + q + 4) * ld + m0 + g + 8];
  } else {
    x[0] = t[(m0 + g) * ld + k0 + q];
    x[1] = t[(m0 + g + 8) * ld + k0 + q];
    x[2] = t[(m0 + g) * ld + k0 + q + 4];
    x[3] = t[(m0 + g + 8) * ld + k0 + q + 4];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// B fragment (depth k0.., columns n0..) of B[k][n] = T[n][k] (kByRows: the
// tile's rows are B's columns, as K in q Kᵀ) or B[k][n] = T[k][n], split.
template <bool kByRows>
__device__ __forceinline__ void load_b(const float* t, int ld, int k0, int n0, int g, int q,
                                       uint32_t hi[2], uint32_t lo[2]) {
  float x[2];
  if (kByRows) {
    x[0] = t[(n0 + g) * ld + k0 + q];
    x[1] = t[(n0 + g) * ld + k0 + q + 4];
  } else {
    x[0] = t[(k0 + q) * ld + n0 + g];
    x[1] = t[(k0 + q + 4) * ld + n0 + g];
  }
  split(x[0], hi[0], lo[0]);
  split(x[1], hi[1], lo[1]);
}

// Dropout on score fragments. A warp's lane (g, q) holds the accumulator
// elements (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1) of
// each 8-column slab, row = r0 + g, col = slab + 2 q. Lanes q and q ^ 1 share
// one Philox group of 4 columns: the even lane draws it for row `row`, the odd
// one for row + 8 (keep_lane gives the lane its row's state), and a shuffle
// hands each the two bits it needs from the other (keep_slab). A kernel draws
// each slab's bits in the loop that applies them, beside its exponentials:
// tools/sweep_dropout.py timed that against a tile's slabs drawn side by side
// after the score product and against draws between the product's mma.sync
// issues, and it was the fastest of the three (B6's fused pass forms the row
// for each slab instead: attention_bwd.cuh probs_fused).

__device__ __forceinline__ dropout::Row keep_lane(unsigned long long seed, int b, int h,
                                                  int row, int q) {
  return dropout::row_state(seed, b, h, (q & 1) ? row + 8 : row);
}

// The keep bits of the lane's four accumulator elements of the slab at column
// `col` (a multiple of 8), bit e for element e: the lane's draw of columns
// 4 (col / 4 + q / 2) .. + 3 and, by one shuffle, its pair's. All 32 lanes call.
__device__ __forceinline__ uint32_t keep_slab(const dropout::Row& r, int col, int q,
                                              uint32_t thr) {
  const uint32_t own = dropout::keep4(r, (uint32_t)((col >> 2) + (q >> 1)), thr);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
  return (q & 1) ? ((other >> 2) & 3u) | (own & 12u) : (own & 3u) | ((other & 3u) << 2);
}

// x times the keep factor of bit e: x / (1 - rate) kept, 0 dropped.
__device__ __forceinline__ float keep_apply(uint32_t bits, int e, float x, float inv_keep) {
  return (bits >> e) & 1u ? x * inv_keep : 0.f;
}

// acc[j] += A B over depth K for the warp's 16 rows m0.. of a [*, 8 NSLAB]
// output and its column slabs wc + WCOLS j (j < NJ, slab < NSLAB): A a shared
// tile read by its rows, or by its columns (kTransA); B a [K][ldb] shared
// tile read by its rows (B[k][n] = T[k][n]).
template <int K, int NJ, int WCOLS, int NSLAB, bool kTransA>
__device__ __forceinline__ void product(float acc[][4], const float* a, int lda, int m0,
                                        const float* b, int ldb, int wc, int g, int q) {
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 8) {
    uint32_t ah[4], al[4];
    load_a<kTransA>(a, lda, m0, kk, g, q, ah, al);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int slab = wc + WCOLS * j;
      if (NSLAB % WCOLS != 0 && slab >= NSLAB) break;
      uint32_t bh[2], bl[2];
      load_b<false>(b, ldb, kk, 8 * slab, g, q, bh, bl);
      mma3(acc[j], ah, al, bh, bl);
    }
  }
}

// Rows r0 + g and r0 + g + 8 of the warp's fragments acc[j] (column slabs
// wc + WCOLS j) to dst [*, D]; rows from n on are not written.
template <int D, int NJ, int WCOLS>
__device__ __forceinline__ void store_frags(float* __restrict__ dst, const float acc[][4], int r0,
                                            int n, int wc, int g, int q) {
  constexpr int ND = D / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int slab = wc + WCOLS * j;
    if (ND % WCOLS != 0 && slab >= ND) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < n)
        *reinterpret_cast<float2*>(dst + (size_t)row * D + 8 * slab + 2 * q) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float acc[][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

}  // namespace tc

// `switch (D)` over every head dim the attention kernels take.
#define ATTN_FOR_EACH_HEAD_DIM(CASE)                                                  \
  CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64) CASE(72)     \
  CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120) CASE(128) CASE(136)        \
  CASE(144) CASE(152) CASE(160) CASE(168) CASE(176) CASE(184) CASE(192) CASE(200)     \
  CASE(208) CASE(216) CASE(224) CASE(232) CASE(240) CASE(248) CASE(256)
