// The tensor-core and copy helpers the attention kernels share, for Hopper
// (sm_90a): fp32-faithful products on TF32 `mma.sync` (3xTF32), 16-byte
// `cp.async` tile loads, dropout keep factors drawn on an accumulator
// fragment, and the dynamic shared-memory limit. Included by
// attention_bwd.cuh (B4, B6), masked_attention.cu (B3), relpos_attention.cu
// (B1), relpos_attention_bwd.cu (B2), bias_attention.cu (B5) and dropout.cu.
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

// The keep factors of a score fragment: rows (row, row + 8), columns (col,
// col + 1), col = 8-column slab + 2 * (lane % 4), as kf[0..3] in the order of
// the accumulator. Lanes q and q ^ 1 share one Philox group of 4 columns:
// the even lane draws it for row `row`, the odd one for row + 8, and each
// hands the other the two factors it needs. One draw per 4 elements, with no
// shared-memory tile; all 32 lanes must call.
__device__ __forceinline__ void keep_frag(unsigned long long seed, int b, int h, int row,
                                          int slab, int q, float rate, float inv_keep,
                                          float kf[4]) {
  const bool odd = q & 1;
  uint32_t bits[4];
  dropout::draw4(seed, b, h, odd ? row + 8 : row, (slab >> 2) + (q >> 1), bits);
  float k[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) k[e] = dropout::keeps(bits[e], rate) ? inv_keep : 0.f;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? k[0] : k[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? k[1] : k[3], 1);
  kf[0] = odd ? r0 : k[0];
  kf[1] = odd ? r1 : k[1];
  kf[2] = odd ? k[2] : r0;
  kf[3] = odd ? k[3] : r1;
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
