// Whole-solve dopri5 scaffold for (B, D) latent NODE fields with ONE step
// size for the whole batch, as device code for a cooperative grid.
//
// Counterpart of fetode_tpu/ops/pallas_node_common.py: the forward solve
// over t in [0, 1] that records every attempt (adaptive_solve_final :91)
// and the reverse replay of those records, the discrete adjoint on the
// frozen step mesh (adjoint_replay :189); and their trajectory twins for
// a non-autonomous field over [ts[0], ts[T-1]] with CONTD5 dense output
// at every requested time (adaptive_solve_traj :229) and the replay that
// injects the dense-output cotangents (adjoint_replay_traj :355).  A
// field plugs in as a struct with two device methods, the same contract
// as the Python one (:13-15):
//
//   void eval(const float* u, float* out) const;       // out = f(u)
//   void vjp(const float* u, const float* w, float* ubar) const;
//       // ubar = w^T df/du(u), parameter gradients accumulated into the
//       // field's own buffers
//
// and, for the trajectory pair, the same two with the stage time:
//
//   void eval(const float* u, float t, float* out) const;
//   void vjp(const float* u, float t, const float* w, float* ubar) const;
//
// Both run on the whole grid and may call grid.sync() inside (every
// thread calls them, with the same arguments).  The scaffold syncs the
// grid before each call (u, w complete) and after it (out, ubar
// complete).  u, w, out and ubar are (B, D) row-major, N = B*D floats;
// u and w are written by other blocks, so a field reads them with ld().
//
// That is the grid policy (GridSync), B.6's; B.4 runs the member form of
// its fused solve and replay (the "members" section below: P independent
// solves in one cooperative launch, P = 1 the single solve).  The cluster policy (ClusterSync, B.3's csrc/kanfet_wide.cu)
// runs the same solve in each CTA of one thread-block cluster: every CTA
// keeps its own copy of
// the state, stages and scratch in shared memory and runs every
// elementwise pass and error norm over all N elements itself, in one
// fixed order on identical data, so all CTAs hold the same t, dt and
// accept decisions with no exchange.  Its barrier is the CTA's; the field
// spreads its layers over the cluster with its own cluster barriers and
// leaves out, ubar complete in every CTA.  CTA 0 alone writes the outputs
// and records.
//
// The row policy (RowSync, B.5's csrc/logistic_node.cu, B.7's
// csrc/ode_dyn.cu and B.8's csrc/node_enc.cu) is for fields that never mix
// rows: one cluster of C <= 16 CTAs, CTA c owning the contiguous batch
// rows [c R, min(B, (c + 1) R)).  Each CTA runs every elementwise pass
// over its own elements only, with its state, stages and scratch in its
// own memory (local index i, global element base + i); the field's eval /
// vjp take the CTA's rows and synchronise only the CTA.  The one exchange
// is the error norm's sum: each CTA sums its elements in a fixed tree,
// puts the partial in its shared memory, and after one cluster barrier
// every CTA adds the C partials in rank order (map_shared_rank), so t, dt,
// accept and stop agree bit for bit with no vote.  Each CTA writes its own
// rows of the outputs and records; rank 0 the scalars.
//
// Why a cooperative grid: the step control is batch-shared, so every
// attempt's accept test needs one RMS over all B*D elements, and every
// thread must agree on dt, accept and stop.  The kernels are launched
// with cudaLaunchCooperativeKernel on kBlocksPerSM blocks per SM, the
// field spreads its work over every SM, and the error norm is a
// deterministic grid reduction (per-block sums in a fixed tree, then
// every block adds the same partials in the same order), so every thread
// holds bit-identical t, dt and accept decisions and the loop bounds are
// uniform, as grid.sync() requires.  The state, stage and record arrays
// live in device memory; element e of the state is owned by grid thread
// e mod (grid size) in every elementwise pass, so those passes need no
// barrier of their own.  Arrays written by other blocks during the
// kernel are read with __ldcg (L2, never a stale L1 line).
//
// Solver arithmetic is the JAX scaffold's: Hairer's initial step
// (:106-122), the PI controller (:154-159), FSAL, the RMS error over all
// B*D elements (:149-151) with tiny = 1e-12, the DOPRI5 table rounded
// once to float (tableau_table :72-88), and the record layout tda (M, 4)
// rows [dt, accepted, t, 0], yrec (M, B, D), krec (M, 7, B, D), misc (4,)
// [attempts, t_end, 0, 0] (:96-99).  powf replaces the TPU's
// exp(p*log(x)) workaround.  No --use_fast_math.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

namespace node_common {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;      // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;    // cooperative grid: SMs x this, at most
constexpr int kMaxBlocks = 1024;   // partial-sum slots per reduced value
constexpr int kMaxSums = 2;        // values reduced together

// Scratch floats the scaffold takes for its grid reductions.
constexpr int kPartFloats = 2 * kMaxSums * kMaxBlocks;
constexpr int kMaxClusterWarps = 32;  // warps a CTA of the cluster policy

// DOPRI5: stage weights a[j][l] (l < j), solution weights b, embedded
// error weights b - b_low, each rounded once from its double value.
__constant__ float kA[7][6] = {
    {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {(float)(1.0 / 5.0), 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {(float)(3.0 / 40.0), (float)(9.0 / 40.0), 0.0f, 0.0f, 0.0f, 0.0f},
    {(float)(44.0 / 45.0), (float)(-56.0 / 15.0), (float)(32.0 / 9.0), 0.0f,
     0.0f, 0.0f},
    {(float)(19372.0 / 6561.0), (float)(-25360.0 / 2187.0),
     (float)(64448.0 / 6561.0), (float)(-212.0 / 729.0), 0.0f, 0.0f},
    {(float)(9017.0 / 3168.0), (float)(-355.0 / 33.0),
     (float)(46732.0 / 5247.0), (float)(49.0 / 176.0),
     (float)(-5103.0 / 18656.0), 0.0f},
    {(float)(35.0 / 384.0), 0.0f, (float)(500.0 / 1113.0),
     (float)(125.0 / 192.0), (float)(-2187.0 / 6784.0), (float)(11.0 / 84.0)},
};
__constant__ float kB[7] = {
    (float)(35.0 / 384.0), 0.0f, (float)(500.0 / 1113.0),
    (float)(125.0 / 192.0), (float)(-2187.0 / 6784.0), (float)(11.0 / 84.0),
    0.0f};
__constant__ float kE[7] = {
    (float)(35.0 / 384.0 - 5179.0 / 57600.0), 0.0f,
    (float)(500.0 / 1113.0 - 7571.0 / 16695.0),
    (float)(125.0 / 192.0 - 393.0 / 640.0),
    (float)(-2187.0 / 6784.0 - -92097.0 / 339200.0),
    (float)(11.0 / 84.0 - 187.0 / 2100.0), (float)(0.0 - 1.0 / 40.0)};
// Stage times c and Hairer's CONTD5 dense-output weights d (the JAX
// table's columns 6 and 9).
__constant__ float kC[7] = {0.0f, (float)(1.0 / 5.0), (float)(3.0 / 10.0),
                            (float)(4.0 / 5.0), (float)(8.0 / 9.0), 1.0f,
                            1.0f};
__constant__ float kD[7] = {
    (float)(-12715105075.0 / 11282082432.0), 0.0f,
    (float)(87487479700.0 / 32700410799.0),
    (float)(-10690763975.0 / 1880347072.0),
    (float)(701980252875.0 / 199316789632.0),
    (float)(-1453857185.0 / 822651844.0), (float)(69997945.0 / 29380423.0)};

// PI controller (Hairer's DOPRI5 defaults, pallas_node_common.py:51-56).
constexpr float kSafety = 0.9f, kIFactor = 10.0f, kDFactor = 0.2f;
constexpr float kBeta = (float)0.04;
constexpr float kAlpha = (float)(1.0 / 5.0 - 0.75 * 0.04);
constexpr float kRejExp = (float)(-1.0 / 5.0);
constexpr float kInitExp = (float)(1.0 / 6.0);

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// Load of an array that other blocks write during the kernel.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

__device__ __forceinline__ int grid_tid() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int grid_threads() {
  return gridDim.x * blockDim.x;
}
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int grid_warp() { return grid_tid() >> 5; }
__device__ __forceinline__ int grid_warps() { return grid_threads() >> 5; }

// Sum over the 32 lanes in a fixed tree; every lane gets lane 0's total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// p[0] + p[stride] + ... + p[(n-1) stride] in that order, the loads kBatch
// at a time (a consumer of the parameter-stationary fields' partials:
// B.4, B.6).
constexpr int kSumBatch = 16;
template <int kBatch = kSumBatch>
__device__ __forceinline__ float ordered_sum(const float* p, int n,
                                             size_t stride = 1) {
  float s = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      v[k] = k0 + k < n ? ld(p + (k0 + k) * stride) : 0.0f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k0 + k < n) s += v[k];
  }
  return s;
}

// Sums each v[n] over every thread of the grid.  Deterministic: blocks
// reduce in a fixed tree, then every block adds all blocks' partials in
// the same order, so every thread gets the same bits.  part holds
// kPartFloats; slot alternates so consecutive calls use separate halves.
template <int N>
__device__ void grid_sum(float (&v)[N], float* part, int& slot) {
  static_assert(N <= kMaxSums, "grid_sum: too many values");
  __shared__ float red[kWarps][kMaxSums];
  __shared__ float total[kMaxSums];
  const int lane = lane_id(), warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float s = warp_sum(v[n]);
    if (lane == 0) red[warp][n] = s;
  }
  __syncthreads();
  float* p = part + slot * kMaxSums * kMaxBlocks;
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    p[threadIdx.x * kMaxBlocks + blockIdx.x] = s;
  }
  cg::this_grid().sync();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = 0.0f;
      for (int i = lane; i < (int)gridDim.x; i += 32)
        s += ld(p + n * kMaxBlocks + i);
      s = warp_sum(s);
      if (lane == 0) total[n] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = total[n];
  __syncthreads();
  slot ^= 1;
}

// Sums each v[n] over the threads of the block (at most
// kMaxClusterWarps warps): each warp's values in a fixed tree, then the
// warps' sums in the same tree by every warp, so every thread, and every
// CTA that holds the same data, gets the same bits.
template <int N>
__device__ void block_sum(float (&v)[N]) {
  static_assert(N <= kMaxSums, "block_sum: too many values");
  __shared__ float red[kMaxClusterWarps][kMaxSums];
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int nw = (int)(blockDim.x >> 5);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float s = warp_sum(v[n]);
    if (lane == 0) red[warp][n] = s;
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(lane < nw ? red[lane][n] : 0.0f);
  __syncthreads();
}

// The barrier and reduction policies of the solves below (see the head of
// this file).  tid / nth: this thread's first element and the stride of
// the elementwise passes; writes: whether this thread's block writes the
// outputs and records; leader: the one thread that writes the scalars.
//
// base / count: the first global element of this CTA's share and how many
// it holds (every element but under RowSync); the scaffold's scratch arrays
// hold the share only, stage j at j * count.
struct GridSync {
  __device__ static int tid() { return grid_tid(); }
  __device__ static int nth() { return grid_threads(); }
  template <class Bufs>
  __device__ static int base(const Bufs&) { return 0; }
  template <class Bufs>
  __device__ static int count(const Bufs& b) { return b.N; }
  __device__ static void finish() {}
  __device__ static bool writes() { return true; }
  __device__ static bool leader() { return grid_tid() == 0; }
  __device__ static void sync() { cg::this_grid().sync(); }
  __device__ static float ld(const float* p) { return node_common::ld(p); }
  template <int N>
  __device__ static void sum(float (&v)[N], float* part, int& slot) {
    grid_sum(v, part, slot);
  }
  __device__ static void check_agree(float, float) {}
};

struct ClusterSync {
  __device__ static int tid() { return threadIdx.x; }
  __device__ static int nth() { return blockDim.x; }
  template <class Bufs>
  __device__ static int base(const Bufs&) { return 0; }
  template <class Bufs>
  __device__ static int count(const Bufs& b) { return b.N; }
  __device__ static void finish() {}
  __device__ static bool writes() {
    return cg::this_cluster().block_rank() == 0;
  }
  __device__ static bool leader() { return threadIdx.x == 0 && writes(); }
  __device__ static void sync() { __syncthreads(); }
  __device__ static float ld(const float* p) { return *p; }
  template <int N>
  __device__ static void sum(float (&v)[N], float*, int&) {
    block_sum(v);
  }
  // With NODE_COMMON_CHECK_AGREE defined (a debugging build), traps unless
  // every CTA ends the solve at the same t and dt, bit for bit.
  __device__ static void check_agree(float t, float dt) {
#ifdef NODE_COMMON_CHECK_AGREE
    __shared__ float seen[2 * 16];
    cg::cluster_group cl = cg::this_cluster();
    const unsigned rank = cl.block_rank();
    if (threadIdx.x == 0) {
      float* s0 = cl.map_shared_rank(seen, 0);
      s0[2 * rank] = t;
      s0[2 * rank + 1] = dt;
    }
    cl.sync();
    if (rank == 0 && threadIdx.x == 0)
      for (unsigned q = 1; q < cl.num_blocks(); ++q)
        if (__float_as_uint(seen[2 * q]) != __float_as_uint(t) ||
            __float_as_uint(seen[2 * q + 1]) != __float_as_uint(dt))
          __trap();
    cl.sync();
#else
    (void)t;
    (void)dt;
#endif
  }
};

// The first row and the rows of CTA `rank` when each CTA owns R of B rows.
__device__ __forceinline__ int tile_first(int rank, int R) { return rank * R; }
__device__ __forceinline__ int tile_rows(int rank, int R, int B) {
  const int r = B - rank * R;
  return r < R ? (r > 0 ? r : 0) : R;
}

struct RowSync {
  __device__ static int tid() { return threadIdx.x; }
  __device__ static int nth() { return blockDim.x; }
  // The CTA's place in the launch: its rank in the one cluster, or its
  // block of the cooperative grid (grid()).
  __device__ static int rank() { return (int)blockIdx.x; }
  // Launched as a cooperative grid of CTAs, each its own cluster (B.5 and
  // B.8 past one cluster's rows), rather than as one cluster.
  __device__ static bool grid() {
    return cg::this_cluster().num_blocks() != gridDim.x;
  }
  template <class Bufs>
  __device__ static int base(const Bufs& b) {
    return tile_first(rank(), b.R) * b.D;
  }
  template <class Bufs>
  __device__ static int count(const Bufs& b) {
    return tile_rows(rank(), b.R, b.N / b.D) * b.D;
  }
  __device__ static bool writes() { return true; }
  __device__ static bool leader() { return threadIdx.x == 0 && rank() == 0; }
  __device__ static void sync() { __syncthreads(); }
  __device__ static float ld(const float* p) { return *p; }
  // The CTA's sums in block_sum's tree, then the C partials in rank order
  // after one cluster barrier: lane r of warp 0 reads CTA r's, lane 0 adds
  // them and the CTA reads the total from its shared memory.  Two slots
  // alternate: a CTA writes slot s again only after the next call's
  // barrier, which every CTA reaches only when it has read this call's
  // partials.  On a grid, the partials meet in `part` as grid_sum's do,
  // behind one grid barrier, every CTA adding them in the same order.
  template <int N>
  __device__ static void sum(float (&v)[N], float* part, int& slot) {
    __shared__ float xpart[2][kMaxSums];
    __shared__ float total[kMaxSums];
    block_sum(v);
    if (grid()) {
      float* p = part + slot * kMaxSums * kMaxBlocks;
      if (threadIdx.x < N) p[threadIdx.x * kMaxBlocks + blockIdx.x] =
          v[threadIdx.x];
      cg::this_grid().sync();
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float s = 0.0f;
          for (int i = lane; i < (int)gridDim.x; i += 32)
            s += ld(p + n * kMaxBlocks + i);
          s = warp_sum(s);
          if (lane == 0) total[n] = s;
        }
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] = total[n];
      __syncthreads();
      slot ^= 1;
      return;
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) xpart[slot][n] = v[n];
    }
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (threadIdx.x < 32) {
      const unsigned C = cl.num_blocks(), lane = threadIdx.x;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float p =
            lane < C ? *cl.map_shared_rank(&xpart[slot][n], lane) : 0.0f;
        float s = 0.0f;
        for (unsigned r = 0; r < C; ++r) s += __shfl_sync(0xffffffffu, p, r);
        if (lane == 0) total[n] = s;
      }
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = total[n];
    __syncthreads();
    slot ^= 1;
  }
  // No CTA leaves while another may still read its shared memory.
  __device__ static void finish() { cg::this_cluster().sync(); }
  __device__ static void check_agree(float t, float dt) {
    ClusterSync::check_agree(t, dt);
  }
};

// The forward solve's arrays.  y, ks, u, part are scratch; the record
// arrays are written when the solve records.
struct SolveBufs {
  const float* h0;  // (N) initial state
  float* out;       // (N) final state; (T, N) for the trajectory solve
  const float* ts;  // (T) output times, trajectory solve only
  float* tda;       // (M, 4)
  float* yrec;      // (M, N)
  float* krec;      // (M, 7, N)
  float* misc;      // (4)
  float* y;         // (N)
  float* ks;        // (7, N) stage derivatives, ks[0] the FSAL one
  float* u;         // (N) stage input, then the step's y1
  float* part;      // (kPartFloats)
  int N, T, max_steps;
  float rtol, atol;
  int D, R;         // RowSync: the row width and the rows a CTA owns
};

// A field evaluation and VJP at stage time t: the trajectory contract
// takes the time, the final-state one does not.
template <bool kTraj, class Field>
__device__ __forceinline__ void field_eval(const Field& f, const float* u,
                                           float t, float* out) {
  if constexpr (kTraj) f.eval(u, t, out); else f.eval(u, out);
}
template <bool kTraj, class Field>
__device__ __forceinline__ void field_vjp(const Field& f, const float* u,
                                          float t, const float* w,
                                          float* ubar) {
  if constexpr (kTraj) f.vjp(u, t, w, ubar); else f.vjp(u, w, ubar);
}

// The fused-stage hook, B.6's (csrc/mlp_node.cu; a field opts in with
// `static constexpr bool kFused = true`) and, in its member form, B.4's.
// The field forms the stage input itself, inside its first phase, and
// leaves its output pending in its own partial sums, so an evaluation
// needs no barrier before it and none of its own after it:
//
//   void stage(const StageIn&) const;     // f(u), pending
//   float take(int e, float* dst) const;  // the pending f at element e,
//                                         // also written to dst[e]
//   void vjp_stage(const VjpIn&) const;   // the VJP of stage j at the
//                                         // recorded u, cotangent w
//   float take_ub(int e, const VjpIn&) const;  // its ubar at element e
//
// StageIn: u = y (j = 0), y + h ks_0 (j = -1, Hairer's second evaluation)
// or y + h sum_{l<j} a_jl ks_l (1 <= j <= 6) in the unfused pass's order;
// stage `pending` (or none, -1) is still the field's pending output, which
// stage() writes into ks as it reads it.
template <class F, class = void>
struct is_fused { static constexpr bool value = false; };
template <class F>
struct is_fused<F, decltype((void)F::kFused)> {
  static constexpr bool value = F::kFused;
};

struct StageIn {
  const float* y;
  float* ks;
  int N, j, pending;
  float h;
};

struct VjpIn {
  const float* y;   // the attempt's recorded state and stages
  const float* ks;
  const float* w;   // the stage's cotangent (N)
  int N, j;
  float dt;
};

// The stage input at element e of a fused field's StageIn, as the unfused
// pass forms it, the pending stage's value from pend(e); every load
// started at once.
template <class Pend>
__device__ __forceinline__ float stage_input(const StageIn& in, int e,
                                             const Pend& pend) {
  const float y = ld(in.y + e);
  if (in.j == 0) return y;
  if (in.j < 0) return y + in.h * ld(in.ks + e);
  float k[6];
#pragma unroll
  for (int l = 0; l < 6; ++l)
    k[l] = (l < in.j && l != in.pending) ? ld(in.ks + (size_t)l * in.N + e)
                                         : 0.0f;
  if (in.pending >= 0) {
    const float pv = pend(e);
#pragma unroll
    for (int l = 0; l < 6; ++l)
      if (l == in.pending) k[l] = pv;
  }
  float incr = kA[in.j][0] * k[0];
#pragma unroll
  for (int l = 1; l < 6; ++l)
    if (l < in.j) incr += kA[in.j][l] * k[l];
  return y + in.h * incr;
}

// The same from the records, for the VJP of stage j.
__device__ __forceinline__ float record_input(const VjpIn& in, int e) {
  float k[6];
#pragma unroll
  for (int l = 0; l < 6; ++l)
    k[l] = l < (in.j > 0 ? in.j : 1) ? in.ks[(size_t)l * in.N + e] : 0.0f;
  float incr = kA[in.j][0] * k[0];
#pragma unroll
  for (int l = 1; l < 6; ++l)
    if (l < in.j) incr += kA[in.j][l] * k[l];
  return in.y[e] + in.dt * incr;
}

// Adaptive dopri5 with batch-shared step control; with kRecord, records
// every attempt.  Sync is the barrier and reduction policy; under
// ClusterSync y, ks, u point into the CTA's shared memory, under RowSync
// into the CTA's own share (local index i, global element base + i).
// kTraj = false: over t in [0, 1], the final state into out
// (adaptive_solve_final).  kTraj = true: over [ts[0], ts[T-1]], out
// (T, N) prefilled with h0, the CONTD5 dense output of each accepted step
// written at the requested times its window (t, t + dt] holds, and the
// times past the one reached holding the last state (adaptive_solve_traj).
template <bool kRecord, bool kTraj, class Field, class Sync = GridSync>
__device__ void adaptive_solve(const Field& field, const SolveBufs& s) {
  constexpr bool kFused = is_fused<Field>::value;
  const int tid = Sync::tid(), nth = Sync::nth(), N = s.N, T = s.T;
  const int base = Sync::base(s), n = Sync::count(s);
  const float rtol = s.rtol, atol = s.atol, inv_n = 1.0f / (float)N;
  const float tiny = 1e-12f;
  const float t0 = kTraj ? s.ts[0] : 0.0f;
  const float t_final = kTraj ? s.ts[T - 1] : 1.0f;
  int slot = 0;
  float* const f0 = s.ks;  // stage 0 holds the FSAL derivative

  for (int i = tid; i < n; i += nth) {
    const int e = base + i;
    const float y = s.h0[e];
    s.y[i] = y;
    if constexpr (kTraj)
      if (Sync::writes())
        for (int tau = 0; tau < T; ++tau) s.out[(size_t)tau * N + e] = y;
  }
  Sync::sync();
  if constexpr (kFused)
    field.stage(StageIn{s.y, s.ks, n, 0, -1, 0.0f});
  else
    field_eval<kTraj>(field, s.y, t0, f0);
  Sync::sync();

  // Hairer's initial step.
  float d[2] = {0.0f, 0.0f};
  for (int i = tid; i < n; i += nth) {
    const float y = s.y[i], sc = atol + rtol * fabsf(y);
    float f;
    if constexpr (kFused) f = field.take(i, f0); else f = Sync::ld(f0 + i);
    const float a = y / sc, b = f / sc;
    d[0] += a * a;
    d[1] += b * b;
  }
  Sync::sum(d, s.part, slot);
  const float d0 = sqrtf(d[0] * inv_n), d1 = sqrtf(d[1] * inv_n);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f)
                       ? 1e-6f
                       : 0.01f * d0 / fmaxf(d1, 1e-30f);
  float* const f1 = s.ks + n;  // stage 1's slot, free until the loop
  if constexpr (kFused) {
    field.stage(StageIn{s.y, s.ks, n, -1, -1, h0});
  } else {
    for (int i = tid; i < n; i += nth)
      s.u[i] = s.y[i] + h0 * Sync::ld(f0 + i);
    Sync::sync();
    field_eval<kTraj>(field, s.u, t0 + h0, f1);
  }
  Sync::sync();
  float d2s[1] = {0.0f};
  for (int i = tid; i < n; i += nth) {
    const float sc = atol + rtol * fabsf(s.y[i]);
    float f;
    if constexpr (kFused) f = field.take(i, f1); else f = Sync::ld(f1 + i);
    const float a = (f - Sync::ld(f0 + i)) / sc;
    d2s[0] += a * a;
  }
  Sync::sum(d2s, s.part, slot);
  const float d2 = sqrtf(d2s[0] * inv_n) / h0;
  const float dmax = fmaxf(d1, d2);
  const float h1 = dmax <= 1e-15f
                       ? fmaxf(1e-6f, h0 * 1e-3f)
                       : powf(0.01f / fmaxf(dmax, 1e-30f), kInitExp);
  float dt = fminf(fminf(100.0f * h0, h1), t_final - t0);

  float t = t0, errp = 1.0f;
  int m = 0;
  bool moved = false;  // the last attempt was accepted
  // Inside the loop t < t_final - tiny, so the JAX body's `finished` is
  // always false: every accepted attempt advances.
  while (m < s.max_steps && t < t_final - tiny) {
    dt = fminf(dt, t_final - t);
    const float dt_safe = dt == 0.0f ? 1.0f : dt;
    for (int j = 1; j < 7; ++j) {
      if constexpr (kFused) {
        // Stage 1 runs while the last accept pass still moves y1 into y
        // and k7 into ks[0]: it reads them where they were before it.
        const bool fresh = j == 1 && moved;
        field.stage(StageIn{fresh ? s.u : s.y, fresh ? s.ks + 6 * n : s.ks,
                            n, j, j >= 2 ? j - 1 : -1, dt});
      } else {
        for (int i = tid; i < n; i += nth) {
          float incr = kA[j][0] * Sync::ld(s.ks + i);
#pragma unroll
          for (int l = 1; l < j; ++l)
            incr += kA[j][l] * Sync::ld(s.ks + l * n + i);
          s.u[i] = s.y[i] + dt * incr;
        }
        Sync::sync();
        field_eval<kTraj>(field, s.u, t + kC[j] * dt, s.ks + j * n);
      }
      Sync::sync();
    }
    float err2[1] = {0.0f};
    for (int i = tid; i < n; i += nth) {
      const float k0 = Sync::ld(s.ks + i), y = s.y[i];
      float y1 = y + (dt * kB[0]) * k0, ye = kE[0] * k0;
#pragma unroll
      for (int j = 1; j < 7; ++j) {
        float kj;
        if constexpr (kFused)
          kj = j == 6 ? field.take(i, s.ks + 6 * n)
                      : Sync::ld(s.ks + j * n + i);
        else
          kj = Sync::ld(s.ks + j * n + i);
        y1 += (dt * kB[j]) * kj;
        ye += kE[j] * kj;
      }
      const float r = dt * ye / (atol + rtol * fmaxf(fabsf(y), fabsf(y1)));
      err2[0] += r * r;
      s.u[i] = y1;
    }
    Sync::sum(err2, s.part, slot);
    const float err = fmaxf(sqrtf(err2[0] * inv_n), 1e-10f);
    const bool accept = err <= 1.0f;
    const float fac_acc = fminf(fmaxf(kSafety * powf(err, -kAlpha) *
                                          powf(errp, kBeta),
                                      kDFactor),
                                kIFactor);
    const float fac_rej =
        fminf(fmaxf(kSafety * powf(err, kRejExp), kDFactor), 1.0f);
    const float dt_next = dt_safe * (accept ? fac_acc : fac_rej);
    if (kRecord) {
      if (Sync::leader()) {
        float* r = s.tda + 4 * m;
        r[0] = dt;
        r[1] = accept ? 1.0f : 0.0f;
        r[2] = t;
        r[3] = 0.0f;
      }
      if (Sync::writes())
        for (int i = tid; i < n; i += nth) {
          const int e = base + i;
          s.yrec[(size_t)m * N + e] = s.y[i];
#pragma unroll
          for (int j = 0; j < 7; ++j)
            s.krec[((size_t)m * 7 + j) * N + e] = Sync::ld(s.ks + j * n + i);
        }
    }
    if (accept) {
      for (int i = tid; i < n; i += nth) {
        const float y = s.y[i], y1 = s.u[i];
        const float k6 = Sync::ld(s.ks + 6 * n + i);
        if (kTraj && Sync::writes()) {
          // Dense output (CONTD5) at the requested times in (t, t + dt].
          const int e = base + i;
          const float k0 = Sync::ld(s.ks + i);
          float r5s = kD[0] * k0;
#pragma unroll
          for (int j = 1; j < 7; ++j)
            r5s += kD[j] * Sync::ld(s.ks + j * n + i);
          const float dy = y1 - y, r3 = dt * k0 - dy;
          const float r4 = dy - dt * k6 - r3, r5 = dt * r5s;
          for (int tau = 0; tau < T; ++tau) {
            const float tsv = s.ts[tau];
            if (!(tsv > t && tsv <= t + dt + tiny)) continue;
            const float theta = fminf(fmaxf((tsv - t) / dt_safe, 0.0f), 1.0f);
            const float th1 = 1.0f - theta;
            s.out[(size_t)tau * N + e] =
                y + theta * (dy + th1 * (r3 + theta * (r4 + th1 * r5)));
          }
        }
        s.y[i] = y1;
        s.ks[i] = k6;  // FSAL
      }
      t += dt;
      errp = err;
    }
    moved = accept;
    dt = dt_next;
    ++m;
  }
  if (Sync::writes())
    for (int i = tid; i < n; i += nth) {
      const int e = base + i;
      if constexpr (kTraj) {
        // Step budget exhausted: unreached outputs hold the last state.
        for (int tau = 0; tau < T; ++tau)
          if (s.ts[tau] > t + tiny) s.out[(size_t)tau * N + e] = s.y[i];
      } else {
        s.out[e] = s.y[i];
      }
    }
  if (kRecord && Sync::leader()) {
    s.misc[0] = (float)m;
    s.misc[1] = t;
    s.misc[2] = 0.0f;
    s.misc[3] = 0.0f;
  }
  Sync::check_agree(t, dt);
  Sync::finish();
}

template <bool kRecord, class Field>
__device__ void adaptive_solve_final(const Field& field, const SolveBufs& s) {
  adaptive_solve<kRecord, false>(field, s);
}

template <bool kRecord, class Sync = GridSync, class Field>
__device__ void adaptive_solve_traj(const Field& field, const SolveBufs& s) {
  adaptive_solve<kRecord, true, Field, Sync>(field, s);
}

// The reverse replay's arrays.  lam, kbar, u, ub are scratch (under
// ClusterSync in the CTA's shared memory, under RowSync the CTA's share).
struct ReplayBufs {
  const float* hbar;  // (N) cotangent of the final state; (T, N) of the
                      // trajectory in the trajectory replay
  const float* ts;    // (T) output times, trajectory replay only
  const float* tda;   // the forward's records
  const float* yrec;
  const float* krec;
  const float* misc;
  float* h0bar;  // (N) cotangent of the initial state
  float* lam;    // (N)
  float* kbar;   // (6, N) stage cotangents (stage 7's is zero); (7, N)
                 // in the trajectory replay
  float* u;      // (N) stage input
  float* ub;     // (N) the field VJP's output
  int N, T;
  int D, R;      // RowSync: the row width and the rows a CTA owns
};

// The discrete adjoint on the recorded mesh: attempts in reverse, each
// accepted one through its stages in reverse.  A rejected attempt has a
// zero cotangent in the JAX replay and is skipped.
//
// kTraj = false (adjoint_replay): the final state's cotangent seeds lam.
// Stage 7 is skipped: b[6] = 0 and no later stage reads it, so its
// cotangent is identically zero (the JAX replay runs its VJP on that
// zero).
//
// kTraj = true (adjoint_replay_traj): the outputs past the time reached
// seed lam (they read the final state); each accepted attempt injects the
// cotangents of the outputs in its window (t, t + dt] through the dense
// output
//   y + P1 dy + P3 (dt k1 - dy) + P4 (2 dy - dt k1 - dt k7) + P5 dt sum_j d_j k_j,
// dy = dt sum_j b_j k_j (:390-420), into y directly and into every stage,
// stage 7 included: its cotangent dt (d_6 s_5 + s_7) is nonzero whenever
// an output falls in the window, so its VJP is skipped only when none
// does.  The outputs at ts <= ts[0] read h0 and add to h0bar last.
//
// A fused field (B.6) forms each stage input from the records inside its
// VJP, so the VJP needs no barrier before it; the pass after it reads the
// field's pending ubar (take_ub).
template <bool kTraj, class Field, class Sync = GridSync>
__device__ void adjoint_replay_impl(const Field& field, const ReplayBufs& r) {
  constexpr bool kFused = is_fused<Field>::value;
  const int tid = Sync::tid(), nth = Sync::nth(), N = r.N, T = r.T;
  const int base = Sync::base(r), n = Sync::count(r);
  const float tiny = 1e-12f;
  const int n_att = (int)r.misc[0];
  for (int i = tid; i < n; i += nth) {
    const int e = base + i;
    if constexpr (kTraj) {
      const float t_end = r.misc[1];
      float lam = 0.0f;
      for (int tau = 0; tau < T; ++tau)
        if (r.ts[tau] > t_end + tiny) lam += r.hbar[(size_t)tau * N + e];
      r.lam[i] = lam;
    } else {
      r.lam[i] = r.hbar[e];
    }
  }
  for (int m = n_att - 1; m >= 0; --m) {
    const float dt = r.tda[4 * m], adv = r.tda[4 * m + 1];
    const float t = r.tda[4 * m + 2];
    if (adv < 0.5f) continue;
    const float dt_safe = dt == 0.0f ? 1.0f : dt;
    const float* y = r.yrec + (size_t)m * N + base;
    const float* ks = r.krec + (size_t)m * 7 * N + base;
    bool any_out = false;
    if constexpr (kTraj)
      for (int tau = 0; tau < T; ++tau)
        any_out |= r.ts[tau] > t && r.ts[tau] <= t + dt + tiny;
    for (int i = tid; i < n; i += nth) {
      const float lam = r.lam[i];
      if constexpr (kTraj) {
        const int e = base + i;
        float s_w = 0.0f, s_dy = 0.0f, s_1 = 0.0f, s_7 = 0.0f, s_5 = 0.0f;
        for (int tau = 0; tau < T; ++tau) {
          const float tsv = r.ts[tau];
          if (!(tsv > t && tsv <= t + dt + tiny)) continue;
          const float theta = fminf(fmaxf((tsv - t) / dt_safe, 0.0f), 1.0f);
          const float th1 = 1.0f - theta;
          const float P1 = theta, P3 = theta * th1;
          const float P4 = theta * theta * th1, P5 = P4 * th1;
          const float yb = r.hbar[(size_t)tau * N + e];
          s_w += yb;
          s_dy += (P1 - P3 + 2.0f * P4) * yb;
          s_1 += (P3 - P4) * yb;
          s_7 -= P4 * yb;
          s_5 += P5 * yb;
        }
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          float kb = dt * (kB[j] * (lam + s_dy) + kD[j] * s_5);
          if (j == 0) kb += dt * s_1;
          if (j == 6) kb += dt * s_7;
          r.kbar[j * n + i] = kb;
        }
        r.lam[i] = lam + s_w;
      } else {
#pragma unroll
        for (int j = 0; j < 6; ++j) r.kbar[j * n + i] = (dt * kB[j]) * lam;
      }
    }
    for (int j = any_out ? 6 : 5; j >= 0; --j) {
      const VjpIn in{y - base, ks - base, r.kbar + j * n, N, j, dt};
      if constexpr (kFused) {
        field.vjp_stage(in);
      } else {
        for (int i = tid; i < n; i += nth) {
          float incr = kA[j][0] * ks[i];
#pragma unroll
          for (int l = 1; l < j; ++l) incr += kA[j][l] * ks[l * N + i];
          r.u[i] = y[i] + dt * incr;
        }
        Sync::sync();
        field_vjp<kTraj>(field, r.u, t + kC[j] * dt, r.kbar + j * n, r.ub);
      }
      Sync::sync();
      for (int i = tid; i < n; i += nth) {
        float ub;
        if constexpr (kFused) ub = field.take_ub(i, in);
        else ub = Sync::ld(r.ub + i);
#pragma unroll
        for (int l = 0; l < j; ++l) r.kbar[l * n + i] += (dt * kA[j][l]) * ub;
        r.lam[i] += ub;
      }
    }
  }
  if (Sync::writes())
    for (int i = tid; i < n; i += nth) {
      const int e = base + i;
      float lam = r.lam[i];
      if constexpr (kTraj) {
        const float t0 = r.ts[0];
        for (int tau = 0; tau < T; ++tau)
          if (r.ts[tau] <= t0 + tiny) lam += r.hbar[(size_t)tau * N + e];
      }
      r.h0bar[e] = lam;
    }
}

template <class Field>
__device__ void adjoint_replay(const Field& field, const ReplayBufs& r) {
  adjoint_replay_impl<false>(field, r);
}

template <class Sync = GridSync, class Field>
__device__ void adjoint_replay_traj(const Field& field, const ReplayBufs& r) {
  adjoint_replay_impl<true, Field, Sync>(field, r);
}

// ------------------------------------------------------------ members
//
// The member form (B.4's csrc/ferro_node.cu, ROADMAP A.12): P independent
// final-state solves of one fused field in one cooperative launch, member
// m with its own parameters, state, t, dt, attempt count, accept flag and
// error norm, as a vmap of the JAX kernel gives each program instance its
// own.  Within a member the step control stays shared over its B rows.
//
// Lockstep: every grid phase runs the current stage for each member still
// stepping (its "on" flag); a member that has finished skips its work but
// its blocks keep passing the grid barriers, and the loop ends when no
// member steps.  The replay takes each member's accepted attempts from its
// own last one down, one a round.  Each block keeps every member's scalars
// in shared memory (MemberCtl), computed by thread m from totals that
// every block reads in the same order, so all blocks agree with no vote;
// a member never reads another's dt, accept flag or norm.
//
// A member's bits do not depend on P, on the grid or on where its work
// lands.  Element e of a member belongs to the virtual thread e mod Gv
// kThreads of a virtual grid of Gv = ceil(N / kThreads) blocks (at most
// kMaxBlocks), a function of N alone; virtual block (m, vb) runs on real
// block (m Gv + vb) mod G with the same thread index.  An error norm sums
// each virtual thread's elements in order, each warp in warp_sum's tree,
// each virtual block's 8 warps in order, then each lane the virtual
// blocks lane, lane + 32, ... in order and warp_sum over the lanes: the
// same sum at P = 1 as at any P.  (Where a thread of the single-solve
// GridSync grid owns one element, the sum is grid_sum's too.)  The field
// spreads its own work over the members' tiles with sums in fixed orders.

constexpr int kMaxMembers = 32;

// Every member's scalars, in each block's shared memory.  Thread m < P
// writes member m's between two __syncthreads; every thread reads them.
struct MemberCtl {
  float t[kMaxMembers], dt[kMaxMembers], errp[kMaxMembers], h[kMaxMembers];
  float tot[kMaxMembers][kMaxSums];  // the last member_sum's totals
  int att[kMaxMembers];  // forward: attempts made; replay: attempt replayed
  int rec[kMaxMembers];  // forward: the attempt being recorded
  unsigned char on[kMaxMembers];     // stepping / replaying this round
  unsigned char fresh[kMaxMembers];  // forward: the last attempt accepted
};

// The virtual grid of one member: N elements on Gv virtual blocks.
__host__ __device__ inline int member_vblocks(int N) {
  const int g = (N + kThreads - 1) / kThreads;
  return g < kMaxBlocks ? g : kMaxBlocks;
}

// f(m, e) for each element e of each member m that is on, by the owner of
// (m, e) (the same thread in every pass: passes need no barrier between
// them).
template <class F>
__device__ __forceinline__ void member_for_each(const MemberCtl& c, int P,
                                                int N, const F& f) {
  const int Gv = member_vblocks(N);
  for (int vbg = blockIdx.x; vbg < P * Gv; vbg += gridDim.x) {
    const int m = vbg / Gv, vb = vbg - m * Gv;
    if (!c.on[m]) continue;
    for (int e = vb * kThreads + threadIdx.x; e < N; e += Gv * kThreads)
      f(m, e);
  }
}

// Each member's sums of NV values f(m, e, v) adds over its elements, into
// c.tot[m] in every block (see the head of this section for the order).
// part holds 2 * kMaxSums * P * Gv floats; slot alternates halves as in
// grid_sum.  Ends with every block's c.tot complete.
template <int NV, class F>
__device__ void member_sum(MemberCtl& c, int P, int N, float* part, int& slot,
                           const F& f) {
  static_assert(NV <= kMaxSums, "member_sum: too many values");
  __shared__ float red[kWarps][kMaxSums];
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int Gv = member_vblocks(N);
  float* p = part + (size_t)slot * kMaxSums * P * Gv;
  for (int vbg = blockIdx.x; vbg < P * Gv; vbg += gridDim.x) {
    const int m = vbg / Gv, vb = vbg - m * Gv;
    if (!c.on[m]) continue;
    float v[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) v[n] = 0.0f;
    for (int e = vb * kThreads + threadIdx.x; e < N; e += Gv * kThreads)
      f(m, e, v);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const float s = warp_sum(v[n]);
      if (lane == 0) red[warp][n] = s;
    }
    __syncthreads();
    if (threadIdx.x < NV) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
      p[((size_t)threadIdx.x * P + m) * Gv + vb] = s;
    }
    __syncthreads();
  }
  cg::this_grid().sync();
  for (int q = warp; q < P * NV; q += kWarps) {
    const int m = q / NV, n = q - m * NV;
    if (!c.on[m]) continue;
    const float* pm = p + ((size_t)n * P + m) * Gv;
    float s = 0.0f;
    for (int i = lane; i < Gv; i += 32) s += ld(pm + i);
    s = warp_sum(s);
    if (lane == 0) c.tot[m][n] = s;
  }
  __syncthreads();
  slot ^= 1;
}

__device__ __forceinline__ bool any_on(const MemberCtl& c, int P) {
  bool any = false;
  for (int m = 0; m < P; ++m) any |= c.on[m] != 0;
  return any;
}

// Sets every member on (after the loops, for the final writes).
__device__ __forceinline__ void all_on(MemberCtl& c, int P) {
  __syncthreads();
  if ((int)threadIdx.x < P) c.on[threadIdx.x] = 1;
  __syncthreads();
}

// The member form's arrays: member m's h0, out, y, u at m N, its ks at
// m 7 N, tda at m 4 M, yrec at m M N, krec at m 7 M N, misc at 4 m.
struct MemberSolveBufs {
  const float* h0;
  float* out;
  float* tda;
  float* yrec;
  float* krec;
  float* misc;
  float* y;
  float* ks;
  float* u;
  float* part;  // 2 * kMaxSums * P * member_vblocks(N)
  int P, N, max_steps;
  float rtol, atol;
};

// A fused field's stage input for every member (the StageIn of member(m)):
// member m's stage j at step c->h[m]; at j = 1 after an accepted attempt
// (c->fresh[m]) y1 and k7 where the error pass left them.
struct MemberStageIn {
  const float* y;
  const float* u;
  float* ks;
  int N, j, pending;
  const MemberCtl* c;
  __device__ __forceinline__ StageIn member(int m) const {
    const bool f = j == 1 && c->fresh[m];
    const size_t at = (size_t)m * N;
    return StageIn{(f ? u : y) + at, ks + 7 * at + (f ? 6 * (size_t)N : 0), N,
                   j, pending, c->h[m]};
  }
  __device__ __forceinline__ float* pending_stage(int m) const {
    return ks + ((size_t)m * 7 + pending) * N;
  }
};

// The records of the stage each member replays this round (c->att[m]).
struct MemberVjpIn {
  const float* yrec;
  const float* krec;
  const float* kbar;
  int N, M, j;
  const MemberCtl* c;
  __device__ __forceinline__ VjpIn member(int m) const {
    const size_t a = (size_t)m * M + c->att[m];
    return VjpIn{yrec + a * N, krec + a * 7 * N,
                 kbar + ((size_t)m * 6 + j) * N, N, j, c->dt[m]};
  }
};

// adaptive_solve's fused final-state solve for P members in lockstep (see
// the head of this section): each member's arithmetic is adaptive_solve's.
// The field takes MemberStageIn in stage() and (m, e, dst) in take(); it
// skips the members that are not on.
template <bool kRecord, class Field>
__device__ void adaptive_solve_members(const Field& field,
                                       const MemberSolveBufs& s,
                                       MemberCtl& c) {
  const int P = s.P, N = s.N, M = s.max_steps;
  const float rtol = s.rtol, atol = s.atol, inv_n = 1.0f / (float)N;
  const float tiny = 1e-12f, t_final = 1.0f;
  const size_t N7 = 7 * (size_t)N;
  int slot = 0;
  cg::grid_group grid = cg::this_grid();
  auto stage = [&](int j, int pending) {
    field.stage(MemberStageIn{s.y, s.u, s.ks, N, j, pending, &c});
  };

  if ((int)threadIdx.x < P) {
    const int m = threadIdx.x;
    c.on[m] = 1;
    c.fresh[m] = 0;
    c.att[m] = 0;
    c.t[m] = 0.0f;
    c.errp[m] = 1.0f;
    c.h[m] = 0.0f;
  }
  __syncthreads();
  member_for_each(c, P, N, [&](int m, int e) {
    s.y[(size_t)m * N + e] = s.h0[(size_t)m * N + e];
  });
  grid.sync();
  stage(0, -1);
  grid.sync();

  // Hairer's initial step, each member's own.
  member_sum<2>(c, P, N, s.part, slot, [&](int m, int e, float* v) {
    const float y = s.y[(size_t)m * N + e], sc = atol + rtol * fabsf(y);
    const float f = field.take(m, e, s.ks + m * N7);
    const float a = y / sc, b = f / sc;
    v[0] += a * a;
    v[1] += b * b;
  });
  if ((int)threadIdx.x < P) {
    const int m = threadIdx.x;
    const float d0 = sqrtf(c.tot[m][0] * inv_n);
    const float d1 = sqrtf(c.tot[m][1] * inv_n);
    c.h[m] = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f
                                         : 0.01f * d0 / fmaxf(d1, 1e-30f);
    c.dt[m] = d1;
  }
  __syncthreads();
  stage(-1, -1);
  grid.sync();
  member_sum<1>(c, P, N, s.part, slot, [&](int m, int e, float* v) {
    float* ks = s.ks + m * N7;
    const float sc = atol + rtol * fabsf(s.y[(size_t)m * N + e]);
    const float f = field.take(m, e, ks + N);
    const float a = (f - ld(ks + e)) / sc;
    v[0] += a * a;
  });
  if ((int)threadIdx.x < P) {
    const int m = threadIdx.x;
    const float h0 = c.h[m];
    const float d2 = sqrtf(c.tot[m][0] * inv_n) / h0;
    const float dmax = fmaxf(c.dt[m], d2);
    const float h1 = dmax <= 1e-15f
                         ? fmaxf(1e-6f, h0 * 1e-3f)
                         : powf(0.01f / fmaxf(dmax, 1e-30f), kInitExp);
    c.dt[m] = fminf(fminf(100.0f * h0, h1), t_final);
  }

  for (;;) {
    __syncthreads();
    if ((int)threadIdx.x < P) {
      const int m = threadIdx.x;
      const bool on = c.att[m] < M && c.t[m] < t_final - tiny;
      c.on[m] = on;
      if (on) c.h[m] = c.dt[m] = fminf(c.dt[m], t_final - c.t[m]);
    }
    __syncthreads();
    if (!any_on(c, P)) break;
    for (int j = 1; j < 7; ++j) {
      stage(j, j >= 2 ? j - 1 : -1);
      grid.sync();
    }
    member_sum<1>(c, P, N, s.part, slot, [&](int m, int e, float* v) {
      const float dt = c.dt[m];
      const float* ks = s.ks + m * N7;
      const float k0 = ld(ks + e), y = s.y[(size_t)m * N + e];
      float y1 = y + (dt * kB[0]) * k0, ye = kE[0] * k0;
#pragma unroll
      for (int j = 1; j < 7; ++j) {
        const float kj = j == 6 ? field.take(m, e, s.ks + m * N7 + 6 * N)
                                : ld(ks + j * N + e);
        y1 += (dt * kB[j]) * kj;
        ye += kE[j] * kj;
      }
      const float r = dt * ye / (atol + rtol * fmaxf(fabsf(y), fabsf(y1)));
      v[0] += r * r;
      s.u[(size_t)m * N + e] = y1;
    });
    if ((int)threadIdx.x < P && c.on[threadIdx.x]) {
      const int m = threadIdx.x;
      const float dt = c.dt[m], dt_safe = dt == 0.0f ? 1.0f : dt;
      const float err = fmaxf(sqrtf(c.tot[m][0] * inv_n), 1e-10f);
      const bool accept = err <= 1.0f;
      const float fac_acc = fminf(fmaxf(kSafety * powf(err, -kAlpha) *
                                            powf(c.errp[m], kBeta),
                                        kDFactor),
                                  kIFactor);
      const float fac_rej =
          fminf(fmaxf(kSafety * powf(err, kRejExp), kDFactor), 1.0f);
      if (kRecord && blockIdx.x == 0) {
        float* r = s.tda + ((size_t)m * M + c.att[m]) * 4;
        r[0] = dt;
        r[1] = accept ? 1.0f : 0.0f;
        r[2] = c.t[m];
        r[3] = 0.0f;
      }
      c.rec[m] = c.att[m]++;
      c.fresh[m] = accept;
      if (accept) {
        c.t[m] += dt;
        c.errp[m] = err;
      }
      c.dt[m] = dt_safe * (accept ? fac_acc : fac_rej);
    }
    __syncthreads();
    if (kRecord)
      member_for_each(c, P, N, [&](int m, int e) {
        const size_t a = (size_t)m * M + c.rec[m];
        s.yrec[a * N + e] = s.y[(size_t)m * N + e];
#pragma unroll
        for (int j = 0; j < 7; ++j)
          s.krec[(a * 7 + j) * N + e] = ld(s.ks + m * N7 + j * N + e);
      });
    member_for_each(c, P, N, [&](int m, int e) {
      if (!c.fresh[m]) return;
      const size_t at = (size_t)m * N + e;
      const float k6 = ld(s.ks + m * N7 + 6 * N + e);
      s.y[at] = s.u[at];
      s.ks[m * N7 + e] = k6;  // FSAL
    });
  }
  all_on(c, P);
  member_for_each(c, P, N, [&](int m, int e) {
    s.out[(size_t)m * N + e] = s.y[(size_t)m * N + e];
  });
  if (kRecord && blockIdx.x == 0 && (int)threadIdx.x < P) {
    float* misc = s.misc + 4 * threadIdx.x;
    misc[0] = (float)c.att[threadIdx.x];
    misc[1] = c.t[threadIdx.x];
    misc[2] = 0.0f;
    misc[3] = 0.0f;
  }
}

// The member form's replay arrays: member m's hbar, h0bar, lam at m N,
// kbar at m 6 N, its records as MemberSolveBufs lays them out.
struct MemberReplayBufs {
  const float* hbar;
  const float* tda;
  const float* yrec;
  const float* krec;
  const float* misc;
  float* h0bar;
  float* lam;
  float* kbar;
  int P, N, max_steps;
};

// adjoint_replay's fused final-state replay for P members in lockstep:
// each round replays, for every member that has one left, its latest
// accepted attempt not yet replayed (rejected attempts have a zero
// cotangent and are skipped); a member's VJPs run in adjoint_replay's
// order.  The field takes MemberVjpIn in vjp_stage() and (m, e, VjpIn) in
// take_ub().
template <class Field>
__device__ void adjoint_replay_members(const Field& field,
                                       const MemberReplayBufs& r,
                                       MemberCtl& c) {
  const int P = r.P, N = r.N, M = r.max_steps;
  const size_t N6 = 6 * (size_t)N;
  cg::grid_group grid = cg::this_grid();
  if ((int)threadIdx.x < P) {
    c.att[threadIdx.x] = (int)r.misc[4 * threadIdx.x];
    c.on[threadIdx.x] = 1;
  }
  __syncthreads();
  member_for_each(c, P, N, [&](int m, int e) {
    r.lam[(size_t)m * N + e] = r.hbar[(size_t)m * N + e];
  });
  for (;;) {
    __syncthreads();
    if ((int)threadIdx.x < P) {
      const int m = threadIdx.x;
      const float* tda = r.tda + (size_t)m * M * 4;
      int a = c.att[m] - 1;
      while (a >= 0 && tda[4 * a + 1] < 0.5f) --a;
      c.att[m] = a;
      c.on[m] = a >= 0;
      c.dt[m] = a >= 0 ? tda[4 * a] : 0.0f;
    }
    __syncthreads();
    if (!any_on(c, P)) break;
    member_for_each(c, P, N, [&](int m, int e) {
      const float lam = r.lam[(size_t)m * N + e], dt = c.dt[m];
#pragma unroll
      for (int j = 0; j < 6; ++j) r.kbar[m * N6 + j * N + e] = (dt * kB[j]) * lam;
    });
    for (int j = 5; j >= 0; --j) {
      const MemberVjpIn in{r.yrec, r.krec, r.kbar, N, M, j, &c};
      field.vjp_stage(in);
      grid.sync();
      member_for_each(c, P, N, [&](int m, int e) {
        const float dt = c.dt[m];
        const float ub = field.take_ub(m, e, in.member(m));
        float* kbar = r.kbar + m * N6;
#pragma unroll
        for (int l = 0; l < j; ++l) kbar[l * N + e] += (dt * kA[j][l]) * ub;
        r.lam[(size_t)m * N + e] += ub;
      });
    }
  }
  all_on(c, P);
  member_for_each(c, P, N, [&](int m, int e) {
    r.h0bar[(size_t)m * N + e] = r.lam[(size_t)m * N + e];
  });
}

// Launches kernel(args) as a cooperative grid of kThreads-thread blocks,
// kBlocksPerSM per SM (fewer if occupancy allows fewer); returns the CUDA
// error of the launch, 0 on success.
template <class Args>
inline int launch_cooperative(void (*kernel)(Args), Args& args,
                              cudaStream_t stream) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  int blocks = sms * (occ < kBlocksPerSM ? occ : kBlocksPerSM);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid of a cooperative launch at `per` blocks an SM: SMs x per.
inline int grid_blocks(int* G, int per) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *G = sms * per;
  return 0;
}

// Launches kernel(args) as a cooperative grid of kThreads-thread blocks
// with dynamic shared memory, kBlocksPerSM an SM while the card fits the
// bytes, else fewer: plan(G) sets the launch's geometry for a grid of G
// blocks into args and returns its bytes (at most max_bytes).  The
// occupancy of each kernel, device and size is asked once.  Returns the
// CUDA error, 0 on success.
template <class Args, class Plan>
int launch_grid(void (*kernel)(Args), Args& args, const Plan& plan,
                size_t max_bytes, cudaStream_t stream) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> occupancy;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int per = kBlocksPerSM; per >= 1; --per) {
    int G = 0;
    const int rc = grid_blocks(&G, per);
    if (rc != 0) return rc;
    if (G > kMaxBlocks) G = kMaxBlocks;
    const size_t bytes = plan(G);
    int occ = 0;
    {
      std::lock_guard<std::mutex> lock(mu);
      const auto key = std::make_tuple((const void*)kernel, dev, bytes);
      const auto it = occupancy.find(key);
      if (it != occupancy.end()) {
        occ = it->second;
      } else {
        if (bytes > max_bytes) return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)max_bytes);
        if (err == cudaSuccess)
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &occ, kernel, kThreads, bytes);
        if (err != cudaSuccess) return (int)err;
        occupancy[key] = occ;
      }
    }
    if (occ < per) continue;
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(G),
                                      dim3(kThreads), params, bytes, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorLaunchOutOfResources;
}

}  // namespace node_common
