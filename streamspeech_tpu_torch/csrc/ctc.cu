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
// accurate ones (no fast-math). No atomics: two calls give the same bits.
//
// What bounds it on this card: neither bytes nor operations but the chain of
// T dependent steps. The unit CTC of the train step (B=8, T=1200, S=513) moves
// ~39 MB (12 us at 3.35 TB/s) and does ~60 MFLOP; a step of the chain is one
// lse3 (3 expf, 1 logf) of the previous frame's values plus the hand-over of
// two neighbour states. The TPU runs the time blocks in order on one core and
// carries alpha [B, S] in VMEM; here the time loop lives inside the kernel.
// The first version ran one block a row with a __syncthreads() a frame.
//
// The design: one thread-block cluster per batch row. The row's states are cut
// into slices of 32 * L consecutive states, one slice per warp; a lane holds L
// consecutive states in registers, and the cluster's C blocks hold NW warps
// each, C = ceil(S / (32 * L * NW)). Within a warp the two neighbours come by
// shuffles (up for alpha, down for beta). Across a warp boundary they go
// through the boundary ring below, in the consumer's shared memory, written
// with distributed-shared-memory bulk copies and signalled by mbarriers. No
// block-wide or cluster-wide barrier runs per frame: warp g runs a frame as
// soon as warp g - 1 (alpha) or g + 1 (beta) has handed its batch over, so the
// slices run as a wavefront, a batch of K frames apart, and only the
// pipeline's fill is paid. One cluster barrier after the barriers' init
// (before the first remote write) and one before exit (a block's shared
// memory must outlive its neighbours' remote writes and arrivals).
//
// What the measurements taught (tools/sweep_ctc.py, PERF.md): every wait on
// the ring is executed by the whole warp. A wait that one lane spins in alone,
// in a branch, tripled the frame time whatever the hand-over (per frame or
// batched, mbarrier or tagged slots), though the waits themselves were short.
// One lse3 a lane (L = 1) with NW = 4, R = 4 and K = 8 is kept: with 2 or 4
// states a lane one warp's issue of their lse3s bounds the frame, a batch of
// 16 is slower, and R = 8 slots, K = 4 or NW = 2 time within a few per cent
// of it (NW = 2 needs a cluster of 9, past the portable 8). The alpha kernel
// loads a frame's inputs (stage and boundary pair) while the frame before
// computes; the same in the beta kernel timed slower, so beta loads them in
// the step.
//
// lp (and alpha, for B9) and the frame's validity are fetched K - 1 frames
// ahead with 4-byte cp.async into a ring of K stages in shared memory, each
// lane its own L values (stage [w][k][lane], no bank conflicts). A frame's row
// is S * 4 bytes, 2052 at S = 513: rows are not 16-byte aligned and a warp's
// slice starts anywhere in a row, so TMA bulk copies of global memory do not
// apply as they are; 4-byte copies keep any S, and a warp's 32 * L
// consecutive floats keep them coalesced. B9's gradient for frame t is
// computed after frame t's pair has been handed over and the new beta issued,
// off the chain.
//
// Limits: S <= 4096, any B and T >= 1. L starts at CTC_LANE_STATES and doubles
// while C would pass 16 (the largest, non-portable, cluster size; past 8 the
// kernel is allowed it with cudaFuncAttributeNonPortableClusterSizeAllowed), so
// where the cluster limit would be passed the blocks take more states each.
// CTC_LANE_STATES (L), CTC_WARPS (NW), CTC_RING (R) and CTC_BATCH (K) are
// compile-time defines; tools/sweep_ctc.py times other values.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef CTC_LANE_STATES
#define CTC_LANE_STATES 1
#endif
#ifndef CTC_WARPS
#define CTC_WARPS 4
#endif
#ifndef CTC_RING
#define CTC_RING 4
#endif
#ifndef CTC_BATCH
#define CTC_BATCH 8
#endif

namespace {

constexpr float kNneg = -1e30f;   // the TPU kernel's NNEG
constexpr int kMaxStates = 4096;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kWarps = CTC_WARPS;
constexpr int kRing = CTC_RING;
constexpr int kLaneStates = CTC_LANE_STATES;
constexpr int kBatch = CTC_BATCH;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRing >= 2 && (kRing & (kRing - 1)) == 0, "CTC_RING: a power of two >= 2");
static_assert(kLaneStates >= 1, "CTC_LANE_STATES: at least 1");
static_assert(kWarps >= 1 && kWarps <= 32, "CTC_WARPS: 1 to 32");
static_assert(kBatch >= 2 && kBatch % 2 == 0, "CTC_BATCH: an even number of frames");

__device__ __forceinline__ float lse3(float a0, float a1, float a2) {
  const float m = fmaxf(fmaxf(a0, a1), a2);
  const float out = m + logf(expf(a0 - m) + expf(a1 - m) + expf(a2 - m));
  return m <= kNneg / 2 ? kNneg : out;
}

// ---- PTX: shared-memory addresses, mbarriers, cluster, cp.async ------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::
                   : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of the local barrier at `bar` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// arrive on a local barrier and add `bytes` to the transfer its phase waits for
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// arrive on a barrier of any block of the cluster
__device__ __forceinline__ void bar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void st_shared2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

// copy `bytes` (a multiple of 16) of this block's shared memory at `src` to
// shared memory of any block of the cluster at `dst`; the copy completes its
// bytes of the transfer of the barrier `bar` in that block. The fence makes
// this thread's earlier shared-memory stores visible to the copy.
__device__ __forceinline__ void copy_to_cluster(uint32_t dst, uint32_t src, uint32_t bytes,
                                                uint32_t bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n\t"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr)
               : "memory");
  return v;
}

// 4 bytes from global to shared; zero-filled when !pred (src then unread)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- the boundary ring -------------------------------------------------------
//
// The pairs of n frames (or steps) go over in batches of K frames: frame f is
// pair f % K of batch j = f / K, which goes through slot j % R in round j / R.
// Per block and warp: R `full` barriers and R slots of K pairs (the warp as a
// consumer), R `empty` barriers and R staging slots of K pairs (the warp as a
// producer). The producer lane stores a frame's pair into its staging slot,
// and after the batch's last pair copies the slot into the consumer's with
// one bulk copy (cp.async.bulk shared::cta -> shared::cluster) that completes
// the batch's bytes of the transfer of the consumer's full[slot]. The
// consumer has armed that phase with one arrival expecting those bytes (round
// 0 at init, round r + 1 once it has read round r), waits for it (parity
// round & 1) at the batch's first frame, reads a pair a frame, and after the
// batch's last pair arrives on the producer's empty[slot]; the producer waits
// for phase r - 1 of empty[slot] before the first pair of round r >= 1 (the
// copy out of its staging slot is then complete too). So one remote transfer,
// one wait and one arrival go with K frames, the signals are the copy's own
// completion and plain arrivals (no fence orders this thread's global
// stores), and a consumer runs K frames behind its producer.
struct Ring {
  uint64_t full[kWarps][kRing];
  uint64_t empty[kWarps][kRing];
  alignas(16) float2 slot[kWarps][kRing][kBatch];
  alignas(16) float2 staging[kWarps][kRing][kBatch];
};

// the bytes batch j of n frames copies (its pairs, rounded up to 16 bytes), 0 past the last
__device__ __forceinline__ uint32_t batch_bytes(int j, int n) {
  const int left = n - j * kBatch;
  return left <= 0 ? 0 : 16 * (((left < kBatch ? left : kBatch) + 1) / 2);
}

__device__ __forceinline__ void ring_init(Ring& ring, int n) {
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w)
      for (int i = 0; i < kRing; ++i) {
        bar_init(&ring.full[w][i]);
        bar_init(&ring.empty[w][i]);
        if (batch_bytes(i, n) > 0) bar_expect(smem_u32(&ring.full[w][i]), batch_bytes(i, n));
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every barrier of the cluster is initialised before any remote use
}

// The producer lane's end of one ring: the consumer warp `g_to` of the row; n frames.
struct RingOut {
  uint32_t slot, full, empty, staging;   // the consumer's (cluster), then own
  int n;
  __device__ RingOut(Ring& ring, int w, int g_to, int n_frames) : n(n_frames) {
    const uint32_t rank = g_to / kWarps, wc = g_to % kWarps;
    slot = map_rank(smem_u32(&ring.slot[wc][0][0]), rank);
    full = map_rank(smem_u32(&ring.full[wc][0]), rank);
    empty = smem_u32(&ring.empty[w][0]);
    staging = smem_u32(&ring.staging[w][0][0]);
  }
  // pair `pos` of batch j, called by the whole warp (the wait is warp-uniform:
  // no lane spins alone in a branch); the pair of the lane `leader` goes over
  __device__ __forceinline__ void send(int j, int pos, float a, float b, bool leader) const {
    const uint32_t i = j & (kRing - 1);
    if (pos == 0 && j >= kRing) bar_wait(empty + 8 * i, (j / kRing - 1) & 1);
    if (leader) {
      st_shared2(staging + 8 * (i * kBatch + pos), a, b);
      if (pos == kBatch - 1 || j * kBatch + pos == n - 1)
        copy_to_cluster(slot + 8 * i * kBatch, staging + 8 * i * kBatch, batch_bytes(j, n),
                        full + 8 * i);
    }
  }
};

// The consumer lane's end: its own slots and full bars, the producer warp
// `g_from`'s empty bars; n frames.
struct RingIn {
  uint32_t slot, full, empty;
  int n;
  __device__ RingIn(Ring& ring, int w, int g_from, int n_frames) : n(n_frames) {
    slot = smem_u32(&ring.slot[w][0][0]);
    full = smem_u32(&ring.full[w][0]);
    empty = map_rank(smem_u32(&ring.empty[g_from % kWarps][0]), g_from / kWarps);
  }
  // pair `pos` of batch j, called by the whole warp: every lane waits
  // (warp-uniform) and reads the pair; the lane `leader` arms and releases
  __device__ __forceinline__ float2 receive(int j, int pos, bool leader) const {
    const uint32_t i = j & (kRing - 1);
    if (pos == 0) bar_wait(full + 8 * i, (j / kRing) & 1);
    const float2 v = ld_shared2(slot + 8 * (i * kBatch + pos));
    if (leader && (pos == kBatch - 1 || j * kBatch + pos == n - 1)) {
      const uint32_t next = batch_bytes(j + kRing, n);
      if (next > 0) bar_expect(full + 8 * i, next);   // arm round j / R + 1
      bar_arrive_cluster(empty + 8 * i);               // the slot may be written again
    }
    return v;
  }
};

// ---- the kernels ---------------------------------------------------------------
//
// grid: C * B blocks in clusters of C (block rank = cluster rank, batch row =
// blockIdx.x / C), 32 * NW threads; warp g = rank * NW + w of the row holds
// states [32 L g, 32 L (g + 1)), lane l the L states from (32 g + l) L. Warps
// whose slice starts at or past S only take part in the cluster barriers.
// The time loop runs in batches of K frames, unrolled, so that a frame's
// place in its batch (and so in the boundary ring and the prefetch ring) is a
// constant and a frame's code has no branch that depends on it; a last,
// shorter batch takes a plain loop. Dynamic shared memory: the prefetch ring,
// K stages (frame t in stage t % K, fetched K - 1 frames ahead) of
// [NW][L][32] floats per fetched tensor, then K stages of [NW][32] validity
// floats (every lane fetches the frame's validity for itself).

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

template <int L>
__global__ void __launch_bounds__(32 * kWarps)
ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ initmask,
                 const float* __restrict__ skipmask, const float* __restrict__ valid,
                 float* __restrict__ alpha, int T, int S) {
  constexpr int K = kBatch, kStage = kWarps * L * 32;
  __shared__ Ring ring;
  extern __shared__ float stages[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = static_cast<int>(cluster_rank()) * kWarps + w;
  const int b = blockIdx.x / cluster_size();
  const int n_warps = (S + 32 * L - 1) / (32 * L);
  ring_init(ring, T - 1);   // frames 0 .. T - 2 are handed over
  if (g < n_warps) {
    const int s0 = (g * 32 + lane) * L;
    const float* lp_b = lp + (size_t)b * T * S;
    const float* valid_b = valid + (size_t)b * T;
    float* alpha_b = alpha + (size_t)b * T * S;
    const float* lp_s = stages + w * L * 32 + lane;   // this lane's word of stage 0
    const float* v_s = stages + K * kStage + w * 32 + lane;
    const uint32_t lp_at = smem_u32(lp_s), v_at = smem_u32(v_s);
    auto fetch = [&](int t, int st) {
      const bool in = t < T;
      const float* row = lp_b + (size_t)(in ? t : 0) * S;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int s = s0 + k;
        cp_async4(lp_at + 4 * (st * kStage + k * 32), row + (s < S ? s : 0), in && s < S);
      }
      cp_async4(v_at + 4 * st * kWarps * 32, valid_b + (in ? t : 0), in);
      cp_async_commit();
    };
#pragma unroll 1
    for (int t = 1; t < K; ++t) fetch(t, t);

    float skip[L], cur[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int s = s0 + k;
      skip[k] = s < S ? skipmask[(size_t)b * S + s] : kNneg;
      cur[k] = s < S ? initmask[(size_t)b * S + s] + lp_b[s] : kNneg;
      if (s < S) alpha_b[s] = cur[k];
    }
    const bool has_prev = g > 0, has_next = g + 1 < n_warps;
    const RingOut out(ring, w, has_next ? g + 1 : g, T - 1);
    const RingIn in(ring, w, has_prev ? g - 1 : g, T - 1);

    // The inputs of frame u: lp and validity from its stage (u % K), and the
    // pair of frame u - 1 from the warp below, (j, pos) in its batches. They
    // are loaded while frame u - 1 computes, so that only the shuffles and the
    // lse3 of a frame lie on the chain.
    float lp_u[L], v_u;
    float2 x_u;
    auto load = [&](int u, int st, int j, int pos) {
      cp_async_wait<K - 2>();                      // frame u has landed
#pragma unroll
      for (int k = 0; k < L; ++k) lp_u[k] = lp_s[st * kStage + k * 32];
      v_u = v_s[st * kWarps * 32];
      fetch(u + K - 1, st == 0 ? K - 1 : st - 1);  // into the stage frame u - 1 used
      x_u = has_prev ? in.receive(j, pos, lane == 0) : make_float2(kNneg, kNneg);
    };
    if (T > 1) load(1, 1, 0, 0);

    // frame t = j K + pos + 1: hands frame t - 1 over (pair pos of batch j)
    auto frame = [&](int t, int j, int pos) {
      float lp_t[L];
#pragma unroll
      for (int k = 0; k < L; ++k) lp_t[k] = lp_u[k];
      const float v = v_u;
      const float2 x = x_u;
      // alpha[t-1] at s - 1 and s - 2 of this lane's first state
      float p1 = __shfl_up_sync(kFull, cur[L - 1], 1);
      float p2 = L >= 2 ? __shfl_up_sync(kFull, cur[L >= 2 ? L - 2 : 0], 1)
                        : __shfl_up_sync(kFull, cur[0], 2);
      // the warp's last two states of frame t - 1: lane 31's last two, or
      // lanes 30 (its p1) and 31 at L = 1
      if (has_next) out.send(j, pos, cur[L - 1], L >= 2 ? cur[L >= 2 ? L - 2 : 0] : p1, lane == 31);
      if (lane == 0) {
        p1 = x.x;
        p2 = x.y;
      } else if (L == 1 && lane == 1) {
        p2 = x.x;
      }
      float nxt[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float a1 = k == 0 ? p1 : cur[k == 0 ? 0 : k - 1];
        const float a2 = k == 0 ? p2 : (k == 1 ? p1 : cur[k < 2 ? 0 : k - 2]);
        const float a = lse3(cur[k], a1, a2 + skip[k]) + lp_t[k];
        nxt[k] = v > 0.f ? a : cur[k];
      }
#pragma unroll
      for (int k = 0; k < L; ++k) cur[k] = nxt[k];
      if (t + 1 < T)
        load(t + 1, (pos + 2) % K, pos + 1 == K ? j + 1 : j, pos + 1 == K ? 0 : pos + 1);
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (s0 + k < S) alpha_b[(size_t)t * S + s0 + k] = cur[k];
    };
#pragma unroll 1
    for (int j = 0; 1 + j * K < T; ++j) {
      const int t0 = 1 + j * K;
      if (t0 + K <= T) {
#pragma unroll
        for (int pos = 0; pos < K; ++pos) frame(t0 + pos, j, pos);
      } else {
#pragma unroll 1
        for (int pos = 0; t0 + pos < T; ++pos) frame(t0 + pos, j, pos);
      }
    }
    cp_async_wait<0>();
  }
  cluster_sync();   // no block leaves while a neighbour may still write into it
}

template <int L>
__global__ void __launch_bounds__(32 * kWarps)
ctc_beta_grad_kernel(const float* __restrict__ lp, const float* __restrict__ endmask,
                     const float* __restrict__ skipmask, const float* __restrict__ zbias,
                     const float* __restrict__ valid, const float* __restrict__ alpha,
                     float* __restrict__ grad, int T, int S) {
  constexpr int K = kBatch, kStage = kWarps * L * 32;
  __shared__ Ring ring;
  extern __shared__ float stages[];   // lp stages, alpha stages, validity stages
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = static_cast<int>(cluster_rank()) * kWarps + w;
  const int b = blockIdx.x / cluster_size();
  const int n_warps = (S + 32 * L - 1) / (32 * L);
  ring_init(ring, T);   // every step hands over
  if (g < n_warps) {
    const int s0 = (g * 32 + lane) * L;
    const size_t base = (size_t)b * T * S;
    const float* lp_b = lp + base;
    const float* alpha_b = alpha + base;
    const float* valid_b = valid + (size_t)b * T;
    float* grad_b = grad + base;
    const float* lp_s = stages + w * L * 32 + lane;   // then alpha, K stages on
    const float* v_s = stages + 2 * K * kStage + w * 32 + lane;
    const uint32_t lp_at = smem_u32(lp_s), a_at = lp_at + 4 * K * kStage, v_at = smem_u32(v_s);
    // step i walks frame T - 1 - i
    auto fetch = [&](int i, int st) {
      const bool in = i < T;
      const size_t off = (size_t)(in ? T - 1 - i : 0) * S;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int s = s0 + k;
        const size_t at = off + (s < S ? s : 0);
        cp_async4(lp_at + 4 * (st * kStage + k * 32), lp_b + at, in && s < S);
        cp_async4(a_at + 4 * (st * kStage + k * 32), alpha_b + at, in && s < S);
      }
      cp_async4(v_at + 4 * st * kWarps * 32, valid_b + (in ? T - 1 - i : 0), in);
      cp_async_commit();
    };
#pragma unroll 1
    for (int i = 0; i < K - 1; ++i) fetch(i, i);

    float skip[L + 2], beta[L];   // skip of this lane's states and the next two
#pragma unroll
    for (int k = 0; k < L + 2; ++k) {
      const int s = s0 + k;
      skip[k] = s < S ? skipmask[(size_t)b * S + s] : kNneg;
    }
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int s = s0 + k;
      beta[k] = s < S ? endmask[(size_t)b * S + s] : kNneg;
    }
    const float zb = zbias[b];
    const bool has_prev = g + 1 < n_warps, has_next = g > 0;   // beta flows down the states
    const RingOut out(ring, w, has_next ? g - 1 : g, T);
    const RingIn in(ring, w, has_prev ? g + 1 : g, T);

    // step i = j K + pos (frame t = T - 1 - i), stage pos; its pair is pair pos of batch j
    auto step = [&](int i, int j, int pos) {
      const int t = T - 1 - i;
      cp_async_wait<K - 2>();
      float lp_t[L], a_t[L], q[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        lp_t[k] = lp_s[pos * kStage + k * 32];
        a_t[k] = lp_s[(K + pos) * kStage + k * 32];
      }
      const float v = v_s[pos * kWarps * 32];
      fetch(i + K - 1, pos == 0 ? K - 1 : pos - 1);   // into the stage step i - 1 used
#pragma unroll
      for (int k = 0; k < L; ++k) q[k] = beta[k] + lp_t[k];
      // q at s + 1 and s + 2 of this lane's last state
      float n1 = __shfl_down_sync(kFull, q[0], 1);
      float n2 = L >= 2 ? __shfl_down_sync(kFull, q[L >= 2 ? 1 : 0], 1)
                        : __shfl_down_sync(kFull, q[0], 2);
      // the warp's first two states: lane 0's first two, or lanes 0 and 1 at L = 1
      if (has_next) out.send(j, pos, q[0], L >= 2 ? q[L >= 2 ? 1 : 0] : n1, lane == 0);
      const float2 x = has_prev ? in.receive(j, pos, lane == 31) : make_float2(kNneg, kNneg);
      if (lane == 31) {
        n1 = x.x;
        n2 = x.y;
      } else if (L == 1 && lane == 30) {
        n2 = x.x;
      }
      float nb[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float q1 = k + 1 < L ? q[k + 1 < L ? k + 1 : 0] : n1;
        const float q2 = k + 2 < L ? q[k + 2 < L ? k + 2 : 0] : (k + 2 == L ? n1 : n2);
        nb[k] = lse3(q[k], q1, q2 + skip[k + 2]);
      }
      // the occupancy gradient of frame t, off the chain
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (s0 + k < S) {
          const float gamma = expf(fminf(a_t[k] + beta[k] + zb, 0.f));
          grad_b[(size_t)t * S + s0 + k] = v > 0.f ? -gamma : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < L; ++k) beta[k] = v > 0.f ? nb[k] : beta[k];
    };
#pragma unroll 1
    for (int j = 0; j * K < T; ++j) {
      const int i0 = j * K;
      if (i0 + K <= T) {
#pragma unroll
        for (int pos = 0; pos < K; ++pos) step(i0 + pos, j, pos);
      } else {
#pragma unroll 1
        for (int pos = 0; i0 + pos < T; ++pos) step(i0 + pos, j, pos);
      }
    }
    cp_async_wait<0>();
  }
  cluster_sync();
}

// ---- host side -------------------------------------------------------------------

struct Plan {
  int lane_states, warps, blocks;   // L, warps holding states, cluster size C
};

// L from CTC_LANE_STATES, doubled while C would pass the largest cluster
inline Plan plan(int S) {
  Plan p{kLaneStates, 0, 0};
  for (;;) {
    p.warps = (S + 32 * p.lane_states - 1) / (32 * p.lane_states);
    p.blocks = (p.warps + kWarps - 1) / kWarps;
    if (p.blocks <= kMaxCluster || p.lane_states >= 8 * kLaneStates) return p;
    p.lane_states *= 2;
  }
}

// bytes of the prefetch ring: K stages of `tensors` fetched tensors plus the validity
inline size_t stage_bytes(int lane_states, int tensors) {
  return (size_t)kBatch * kWarps * 32 * (tensors * lane_states + 1) * sizeof(float);
}

template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int blocks, int B, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err;
  if (blocks > kPortableCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks * (unsigned)B);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, L>{}) for the instance of L states a lane
template <typename F>
int with_lane_states(int lane_states, F f) {
  switch (lane_states / kLaneStates) {
    case 1: return f(std::integral_constant<int, kLaneStates>{});
    case 2: return f(std::integral_constant<int, 2 * kLaneStates>{});
    case 4: return f(std::integral_constant<int, 4 * kLaneStates>{});
    default: return f(std::integral_constant<int, 8 * kLaneStates>{});
  }
}

}  // namespace

// lp, alpha: [B, T, S]; initmask, skipmask: [B, S]; valid: [B, T]; all
// contiguous fp32; 1 <= S <= 4096, T >= 1. Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int ctc_alpha_f32(const float* lp, const float* initmask, const float* skipmask,
                             const float* valid, float* alpha, int B, int T, int S,
                             void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > kMaxStates) return (int)cudaErrorInvalidValue;
  const Plan p = plan(S);
  return with_lane_states(p.lane_states, [&](auto lane) {
    constexpr int L = decltype(lane)::value;
    return launch_cluster(ctc_alpha_kernel<L>, p.blocks, B, stage_bytes(L, 1),
                          static_cast<cudaStream_t>(stream), lp, initmask, skipmask, valid,
                          alpha, T, S);
  });
}

// lp, alpha, grad: [B, T, S]; endmask, skipmask: [B, S]; zbias: [B];
// valid: [B, T]; all contiguous fp32; the same limits as ctc_alpha_f32.
extern "C" int ctc_beta_grad_f32(const float* lp, const float* endmask,
                                 const float* skipmask, const float* zbias,
                                 const float* valid, const float* alpha, float* grad,
                                 int B, int T, int S, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > kMaxStates) return (int)cudaErrorInvalidValue;
  const Plan p = plan(S);
  return with_lane_states(p.lane_states, [&](auto lane) {
    constexpr int L = decltype(lane)::value;
    return launch_cluster(ctc_beta_grad_kernel<L>, p.blocks, B, stage_bytes(L, 2),
                          static_cast<cudaStream_t>(stream), lp, endmask, skipmask, zbias,
                          valid, alpha, grad, T, S);
  });
}

// The cut of S states that both kernels launch, into out[7]: cluster size C,
// states a block (32 L NW), states a lane L, warps a block NW, ring slots R,
// frames fetched ahead (K - 1), frames a hand-over K. Returns 0, or
// cudaErrorInvalidValue for S out of range.
extern "C" int ctc_cluster_plan(int S, int* out) {
  if (S <= 0 || S > kMaxStates) return (int)cudaErrorInvalidValue;
  const Plan p = plan(S);
  out[0] = p.blocks;
  out[1] = 32 * p.lane_states * kWarps;
  out[2] = p.lane_states;
  out[3] = kWarps;
  out[4] = kRing;
  out[5] = kBatch - 1;
  out[6] = kBatch;
  return 0;
}
