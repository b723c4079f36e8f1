// Hopper (sm_90a) building blocks shared by the bf16 attention kernels: the
// forwards (attention_bf16.cuh) and the backwards (attention_bwd_bf16.cuh).
//
//  - mbarriers and TMA (`cp.async.bulk.tensor`, 3-D tensor maps [outer, T, D]
//    of bf16 with 64-column boxes and the 128-byte swizzle, zero-filled past D
//    and T; `cp.async.bulk` for a contiguous run of bytes), completing their
//    bytes on an mbarrier;
//  - `wgmma.mma_async` m64nNk16 in bf16 with fp32 accumulators, a warpgroup (4
//    warps) on 64 rows: A and B from shared memory (descriptors of 128-byte
//    swizzled tiles, K-major or MN-major), or A from registers (mma.sync's A
//    fragment layout);
//  - thread-block clusters: rank, size, barrier, loads from a peer's shared
//    memory;
//  - on the host, the tensor maps, encoded at every call through the CUDA
//    runtime's driver entry point (nothing links libcuda): the forwards' three
//    maps a call add less than the host's spread to an eager call's 25-60 µs
//    (PERF.md §6), so nothing caches them.
//
// One swizzled tile serves as either operand: the 8 rows of a 1024-byte group
// hold a row's 16-byte chunk i at chunk i ^ (row % 8) (TMA's SWIZZLE_128B,
// wgmma's B128 layout); k-steps move a K-major descriptor 32 bytes and an
// MN-major one 2048 (16 rows).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace wg {

__host__ __device__ constexpr int panels(int d) { return (d + 63) / 64; }
// a [rows][d] bf16 tile: 64-column panels of rows x 128 bytes
__host__ __device__ constexpr uint32_t tile_bytes(int rows, int d) {
  return (uint32_t)rows * 128 * panels(d);
}
__host__ __device__ constexpr uint32_t round1k(size_t x) {
  return (uint32_t)((x + 1023) / 1024 * 1024);
}

// ---- PTX: shared-memory addresses, mbarriers, TMA, wgmma, cluster ----------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle's period)
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive on a barrier and add `bytes` to the transfer its phase waits for
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// copy that never lands (a fault, not a slow load) traps after ~2^28 polls
// instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// the box of a 3-D tensor map at (c0, c1, c2) into shared memory at dst; the
// copy completes its bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned)
// into shared memory at dst; the copy completes its bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// this thread's shared-memory writes, made visible to the tensor cores (the
// async proxy), before a barrier and the wgmma that reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// pin accumulator registers after wg_wait: no read of them moves above it
template <int N>
__device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// The shared-memory matrix descriptor of a 128-byte swizzled operand at byte
// address `addr`: 8-row groups 1024 bytes apart (SBO), `lbo` between 64-column
// groups of an MN-major operand (unused by K-major ones and by N <= 64).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

// d (m64n64, fp32) = A B (+ d where `acc`): A and B bf16 in shared memory
// (descriptors), K-major (0) or MN-major (1) by TA, TB.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d (m64n32, fp32) = A B (+ d where `acc`), as wgmma_ss64
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d (m64n64, fp32) = A B (+ d where `acc`): A bf16 fragments in registers
// (mma.sync's A layout, warp w on rows 16 w ..), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t a[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// two floats at shared address `addr` of block `rank` of the cluster
__device__ __forceinline__ float2 ld_cluster2(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- tiles and products ----------------------------------------------------

// The byte offset of (row r, column c) in a [rows][..] bf16 tile of 64-column
// panels with the 128-byte swizzle (TMA's SWIZZLE_128B; wgmma's B128): a
// row's 16-byte chunk i sits at chunk i ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 + ((((c >> 3) ^ r) & 7) << 4) +
                    ((c & 7) << 1));
}

// acc = A Bᵀ over D: A and B [64 rows][D] K-major tiles at shared addresses
// a and b (panels pa, pb bytes apart), the k-steps to D rounded up to 16 on the
// zero-filled columns; accumulating onto acc where `accumulate`. Issued, not
// waited.
template <int D>
__device__ __forceinline__ void rows_product(float* acc, uint32_t a, uint32_t pa, uint32_t b,
                                             uint32_t pb, int accumulate) {
#pragma unroll
  for (int k = 0; k < (D + 15) / 16; ++k) {
    const uint32_t p = k >> 2, o = (k & 3) * 32;
    wgmma_ss64<0, 0>(acc, desc(a + p * pa + o, 16), desc(b + p * pb + o, 16),
                     k > 0 || accumulate);
  }
}

// acc (+)= A B over 64 rows of k: A the fragments a[kk] (k-step kk: rows
// 16 kk ..), B a [64 k][64] MN-major panel at shared address b. Issued, not
// waited.
__device__ __forceinline__ void cols_product(float* acc, uint32_t a[4][4], uint32_t b,
                                             int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs64(acc, a[kk], desc(b + kk * 2048, 8192), kk > 0 || accumulate);
}

// 2^x, flushing a subnormal result to 0 (one MUFU.EX2; exp2f adds range
// scaling for subnormals, which a probability that small does not need)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime once, so that
// nothing links libcuda
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a [outer, T, D] bf16 tensor at base: boxes of 64 columns
// by `rows` rows of one outer index, the 128-byte swizzle, zeros outside.
// Returns 0 or an error code.
inline int bf16_map(CUtensorMap* map, const void* base, int D, int T, int outer, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline bool misaligned(std::initializer_list<const void*> p16, std::initializer_list<const void*> p8) {
  for (const void* p : p16)
    if ((uintptr_t)p % 16 != 0) return true;
  for (const void* p : p8)
    if ((uintptr_t)p % 8 != 0) return true;
  return false;
}

}  // namespace wg
