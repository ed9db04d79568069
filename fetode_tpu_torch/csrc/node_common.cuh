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
// That is the grid policy (GridSync), every field but B.3's.  The cluster
// policy (ClusterSync, B.3's csrc/kanfet_wide.cu) runs the same solve in
// each CTA of one thread-block cluster: every CTA keeps its own copy of
// the state, stages and scratch in shared memory and runs every
// elementwise pass and error norm over all N elements itself, in one
// fixed order on identical data, so all CTAs hold the same t, dt and
// accept decisions with no exchange.  Its barrier is the CTA's; the field
// spreads its layers over the cluster with its own cluster barriers and
// leaves out, ubar complete in every CTA.  CTA 0 alone writes the outputs
// and records.
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
struct GridSync {
  __device__ static int tid() { return grid_tid(); }
  __device__ static int nth() { return grid_threads(); }
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

// Adaptive dopri5 with batch-shared step control; with kRecord, records
// every attempt.  Sync is the barrier and reduction policy; under
// ClusterSync y, ks, u point into the CTA's shared memory.  kTraj = false:
// over t in [0, 1], the final state into out (adaptive_solve_final).  kTraj = true: over [ts[0], ts[T-1]], out
// (T, N) prefilled with h0, the CONTD5 dense output of each accepted step
// written at the requested times its window (t, t + dt] holds, and the
// times past the one reached holding the last state (adaptive_solve_traj).
template <bool kRecord, bool kTraj, class Field, class Sync = GridSync>
__device__ void adaptive_solve(const Field& field, const SolveBufs& s) {
  const int tid = Sync::tid(), nth = Sync::nth(), N = s.N, T = s.T;
  const float rtol = s.rtol, atol = s.atol, inv_n = 1.0f / (float)N;
  const float tiny = 1e-12f;
  const float t0 = kTraj ? s.ts[0] : 0.0f;
  const float t_final = kTraj ? s.ts[T - 1] : 1.0f;
  int slot = 0;
  float* const f0 = s.ks;  // stage 0 holds the FSAL derivative

  for (int e = tid; e < N; e += nth) {
    const float y = s.h0[e];
    s.y[e] = y;
    if constexpr (kTraj)
      if (Sync::writes())
        for (int tau = 0; tau < T; ++tau) s.out[(size_t)tau * N + e] = y;
  }
  Sync::sync();
  field_eval<kTraj>(field, s.y, t0, f0);
  Sync::sync();

  // Hairer's initial step.
  float d[2] = {0.0f, 0.0f};
  for (int e = tid; e < N; e += nth) {
    const float y = s.y[e], sc = atol + rtol * fabsf(y);
    const float a = y / sc, b = Sync::ld(f0 + e) / sc;
    d[0] += a * a;
    d[1] += b * b;
  }
  Sync::sum(d, s.part, slot);
  const float d0 = sqrtf(d[0] * inv_n), d1 = sqrtf(d[1] * inv_n);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f)
                       ? 1e-6f
                       : 0.01f * d0 / fmaxf(d1, 1e-30f);
  for (int e = tid; e < N; e += nth)
    s.u[e] = s.y[e] + h0 * Sync::ld(f0 + e);
  Sync::sync();
  float* const f1 = s.ks + N;  // stage 1's slot, free until the loop
  field_eval<kTraj>(field, s.u, t0 + h0, f1);
  Sync::sync();
  float d2s[1] = {0.0f};
  for (int e = tid; e < N; e += nth) {
    const float sc = atol + rtol * fabsf(s.y[e]);
    const float a = (Sync::ld(f1 + e) - Sync::ld(f0 + e)) / sc;
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
  // Inside the loop t < t_final - tiny, so the JAX body's `finished` is
  // always false: every accepted attempt advances.
  while (m < s.max_steps && t < t_final - tiny) {
    dt = fminf(dt, t_final - t);
    const float dt_safe = dt == 0.0f ? 1.0f : dt;
    for (int j = 1; j < 7; ++j) {
      for (int e = tid; e < N; e += nth) {
        float incr = kA[j][0] * Sync::ld(s.ks + e);
#pragma unroll
        for (int l = 1; l < j; ++l)
          incr += kA[j][l] * Sync::ld(s.ks + l * N + e);
        s.u[e] = s.y[e] + dt * incr;
      }
      Sync::sync();
      field_eval<kTraj>(field, s.u, t + kC[j] * dt, s.ks + j * N);
      Sync::sync();
    }
    float err2[1] = {0.0f};
    for (int e = tid; e < N; e += nth) {
      const float k0 = Sync::ld(s.ks + e), y = s.y[e];
      float y1 = y + (dt * kB[0]) * k0, ye = kE[0] * k0;
#pragma unroll
      for (int j = 1; j < 7; ++j) {
        const float kj = Sync::ld(s.ks + j * N + e);
        y1 += (dt * kB[j]) * kj;
        ye += kE[j] * kj;
      }
      const float r = dt * ye / (atol + rtol * fmaxf(fabsf(y), fabsf(y1)));
      err2[0] += r * r;
      s.u[e] = y1;
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
        for (int e = tid; e < N; e += nth) {
          s.yrec[(size_t)m * N + e] = s.y[e];
#pragma unroll
          for (int j = 0; j < 7; ++j)
            s.krec[((size_t)m * 7 + j) * N + e] = Sync::ld(s.ks + j * N + e);
        }
    }
    if (accept) {
      for (int e = tid; e < N; e += nth) {
        const float y = s.y[e], y1 = s.u[e];
        const float k6 = Sync::ld(s.ks + 6 * N + e);
        if (kTraj && Sync::writes()) {
          // Dense output (CONTD5) at the requested times in (t, t + dt].
          const float k0 = Sync::ld(s.ks + e);
          float r5s = kD[0] * k0;
#pragma unroll
          for (int j = 1; j < 7; ++j)
            r5s += kD[j] * Sync::ld(s.ks + j * N + e);
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
        s.y[e] = y1;
        s.ks[e] = k6;  // FSAL
      }
      t += dt;
      errp = err;
    }
    dt = dt_next;
    ++m;
  }
  if (Sync::writes())
    for (int e = tid; e < N; e += nth) {
      if constexpr (kTraj) {
        // Step budget exhausted: unreached outputs hold the last state.
        for (int tau = 0; tau < T; ++tau)
          if (s.ts[tau] > t + tiny) s.out[(size_t)tau * N + e] = s.y[e];
      } else {
        s.out[e] = s.y[e];
      }
    }
  if (kRecord && Sync::leader()) {
    s.misc[0] = (float)m;
    s.misc[1] = t;
    s.misc[2] = 0.0f;
    s.misc[3] = 0.0f;
  }
  Sync::check_agree(t, dt);
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
// ClusterSync in the CTA's shared memory).
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
template <bool kTraj, class Field, class Sync = GridSync>
__device__ void adjoint_replay_impl(const Field& field, const ReplayBufs& r) {
  const int tid = Sync::tid(), nth = Sync::nth(), N = r.N, T = r.T;
  const float tiny = 1e-12f;
  const int n_att = (int)r.misc[0];
  for (int e = tid; e < N; e += nth) {
    if constexpr (kTraj) {
      const float t_end = r.misc[1];
      float lam = 0.0f;
      for (int tau = 0; tau < T; ++tau)
        if (r.ts[tau] > t_end + tiny) lam += r.hbar[(size_t)tau * N + e];
      r.lam[e] = lam;
    } else {
      r.lam[e] = r.hbar[e];
    }
  }
  for (int m = n_att - 1; m >= 0; --m) {
    const float dt = r.tda[4 * m], adv = r.tda[4 * m + 1];
    const float t = r.tda[4 * m + 2];
    if (adv < 0.5f) continue;
    const float dt_safe = dt == 0.0f ? 1.0f : dt;
    const float* y = r.yrec + (size_t)m * N;
    const float* ks = r.krec + (size_t)m * 7 * N;
    bool any_out = false;
    if constexpr (kTraj)
      for (int tau = 0; tau < T; ++tau)
        any_out |= r.ts[tau] > t && r.ts[tau] <= t + dt + tiny;
    for (int e = tid; e < N; e += nth) {
      const float lam = r.lam[e];
      if constexpr (kTraj) {
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
          r.kbar[j * N + e] = kb;
        }
        r.lam[e] = lam + s_w;
      } else {
#pragma unroll
        for (int j = 0; j < 6; ++j) r.kbar[j * N + e] = (dt * kB[j]) * lam;
      }
    }
    for (int j = any_out ? 6 : 5; j >= 0; --j) {
      for (int e = tid; e < N; e += nth) {
        float incr = kA[j][0] * ks[e];
#pragma unroll
        for (int l = 1; l < j; ++l) incr += kA[j][l] * ks[l * N + e];
        r.u[e] = y[e] + dt * incr;
      }
      Sync::sync();
      field_vjp<kTraj>(field, r.u, t + kC[j] * dt, r.kbar + j * N, r.ub);
      Sync::sync();
      for (int e = tid; e < N; e += nth) {
        const float ub = Sync::ld(r.ub + e);
#pragma unroll
        for (int l = 0; l < j; ++l) r.kbar[l * N + e] += (dt * kA[j][l]) * ub;
        r.lam[e] += ub;
      }
    }
  }
  if (Sync::writes())
    for (int e = tid; e < N; e += nth) {
      float lam = r.lam[e];
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

}  // namespace node_common
