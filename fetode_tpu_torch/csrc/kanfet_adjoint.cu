// Discrete-adjoint KANFET NODE kernels for Hopper (sm_90a): the training
// solve of any pure-KANFET [D, ..., D] vector field.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_adjoint.py:794
// (make_train_solver; forward _make_fwd_kernel :195, backward
// _make_bwd_kernel :478, field VJP _layer_vjp :120, _spline_with_deriv
// :67, _ferro_terms :93).  Gradients are exact for the realised discrete
// map on the frozen step mesh: the recorded t, dt and accept decisions
// are constants, the step-size controller is not differentiated.  Held
// against autograd of the eager replay
// fetode_tpu_torch/ops/kanfet_adjoint.py:replay_reference on the
// kernel's own records.
//
// kanfet_adjoint_fwd: one warp per trajectory runs the serving kernel's
// solve (kanfet_field.cuh: dopri5_solve, the same field code and the same
// order of summation) and records every attempt m < max_steps: t, dt, the
// accepted flag, y and the seven stages k1..k7, R = 3 + 8D floats (19 for
// D = 2), stored as rec[(m*R + r)*B + b]; plus its attempt count and
// final t.  At B = 256 and max_steps = 256 the records take 5 MB.
//
// kanfet_adjoint_bwd: one warp per trajectory replays its own attempts
// in reverse.  lambda (lane d: component d) starts as the cotangents of
// the unreached tail; each accepted attempt forms the dense-output sums
// P1, P3, P4, P5 over the times it wrote, builds the stage cotangents
// kbar, runs the field VJP (kanfet_field.cuh: field_vjp) through the
// stages in reverse (stage inputs rebuilt from the recorded k) and
// updates lambda.  Stage 7's VJP runs only when an output time falls in
// the step: otherwise its cotangent is zero (b[6] = 0).  Rejected
// attempts contribute nothing and are skipped.  The output times at or
// before t0 read y0 and add into x0bar at the end.
//
// The parameter gradients, a sum over trajectories.  Each lane adds the
// gradients of the terms it owns (kanfet_field.cuh: layer_vjp) into its
// warp's gradient vector, in which every entry has one owner, in program
// order: no atomics, the same bits on every run.
// * In shared memory when the block's kWarps vectors fit beside the
//   parameters and the warp scratch (the flagship [2,10,2]: 1,960 floats
//   a warp, 31 KB for 4 warps; [2, H, 2] at K = 8 up to H = 55).
//   At the end the block adds its warps' vectors in warp order into one
//   row of a (blocks, n_grad) array: no per-trajectory scratch.
// * Otherwise (e.g. [2,128,2]: 25,088 floats a warp; [2,24,24,2];
//   [2,64,64,2]: 213,248) in the warp's own slice of a (warps, n_grad)
//   array in device memory; a lane's consecutive terms are consecutive
//   words, so a group's lanes touch consecutive words.
// kanfet_adjoint_reduce then adds the rows in index order: one
// fixed-order pass.  The wrapper chooses the placement
// (ops/kanfet_node.py: smem_placement).
//
// What bounds it on this card: the SFU's work (PERF.md §6 row 2: 0.063 ms
// at B = 256), far below a chain of dependent special-function
// latencies: about 6 field VJPs per accepted attempt, each a forward of
// all but the last layer and a backward of every layer.  The warp layout
// shortens that chain as in the serving kernel (kanfet_node.cu), and the
// gradient read-modify-writes, which missed L1 from B = 32 on when each
// thread owned a column of a (n_grad, B) array, go to the warp's slice of
// shared memory.

#include "kanfet_field.cuh"

namespace {

using namespace kanfet;

// Writes one attempt's record into the (S, R, B) buffer.
struct Record {
  float* rec;  // this trajectory's column: rec + b
  int B;
  int* n_att;  // this trajectory's slot
  float* t_end;

  __device__ __forceinline__ void attempt(int m, float t, float dt,
                                          bool accept, float y, float k1,
                                          float k2, float k3, float k4,
                                          float k5, float k6, float k7,
                                          int lane, int D) {
    const int R = 3 + 8 * D;
    float* r = rec + (size_t)m * R * B;
    if (lane == 0) {
      r[0] = t;
      r[B] = dt;
      r[2 * B] = accept ? 1.0f : 0.0f;
    }
    if (lane < D) {
      r[(size_t)(3 + lane) * B] = y;
      r[(size_t)(3 + D + lane) * B] = k1;
      r[(size_t)(3 + 2 * D + lane) * B] = k2;
      r[(size_t)(3 + 3 * D + lane) * B] = k3;
      r[(size_t)(3 + 4 * D + lane) * B] = k4;
      r[(size_t)(3 + 5 * D + lane) * B] = k5;
      r[(size_t)(3 + 6 * D + lane) * B] = k6;
      r[(size_t)(3 + 7 * D + lane) * B] = k7;
    }
  }
  __device__ __forceinline__ void finish(int n, float t, int lane) {
    if (lane == 0) {
      *n_att = n;
      *t_end = t;
    }
  }
};

// ROWS: trajectory b reads its times at ts + b * ts_stride; without it
// every trajectory reads the one row at ts (the shared-times launches keep
// their own instantiations, the code they had before the stride existed).
template <bool PG, bool ROWS>
__global__ void __launch_bounds__(kThreads)
kanfet_adjoint_fwd_kernel(const float* __restrict__ x0s,
                          const float* __restrict__ ts,
                          const float* __restrict__ packed,
                          const int* __restrict__ dims,
                          float* __restrict__ out, float* __restrict__ rec,
                          int* __restrict__ n_att, float* __restrict__ t_end,
                          float* __restrict__ gscratch, Geo geo, int B, int T,
                          int ts_stride, int max_steps, float rtol,
                          float atol, float gate, float alpha, float oma) {
  extern __shared__ float smem[];
  const float* P = stage_params<PG>(smem, packed, geo.n_params);
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp
  const Field F = make_field(geo, dims, P, smem + (PG ? 0 : geo.n_params),
                             gscratch, warp, gate, alpha, oma);
  Record r{rec + b, B, n_att + b, t_end + b};
  dopri5_solve<PG>(F, x0s + (size_t)b * geo.D,
                   ROWS ? ts + (size_t)b * ts_stride : ts, T,
                   out + (size_t)b * T * geo.D, max_steps, rtol, atol, r);
}

// --------------------------------------------------------------- backward

// The warp's trajectory b: its reverse replay, adding the parameter
// gradients into gvec; x0bar's row b at the end.
template <bool PG>
__device__ void replay(const Field& F, const float* ts, const float* ybar,
                       const float* rec, const int* n_att,
                       const float* t_end, float* gvec, float* x0bar, int b,
                       int B, int T) {
  const int lane = F.lane, D = F.D, R = 3 + 8 * D;
  const bool own = lane < D;
  const float* yb = ybar + (size_t)b * T * D;
  const float tiny = 1e-12f;

  // lambda: cotangents of the outputs past the frontier land on y_final.
  float lam = 0.0f;
  {
    const float te = __ldg(t_end + b);
    for (int j = 0; j < T; ++j)
      if (own && __ldg(ts + j) > te + tiny) lam += __ldg(yb + j * D + lane);
  }

  for (int m = __ldg(n_att + b) - 1; m >= 0; --m) {
    const float* r = rec + (size_t)m * R * B + b;
    if (__ldg(r + 2 * B) < 0.5f) continue;  // rejected: lambda passes through
    const float t = __ldg(r), dt = __ldg(r + B);
    const float dt_safe = (dt == 0.0f) ? 1.0f : dt;
    float y = 0.0f, k[7];
#pragma unroll
    for (int s = 0; s < 7; ++s) k[s] = 0.0f;
    if (own) {
      y = __ldg(r + (size_t)(3 + lane) * B);
#pragma unroll
      for (int s = 0; s < 7; ++s)
        k[s] = __ldg(r + (size_t)(3 + (s + 1) * D + lane) * B);
    }

    // Dense-output cotangent sums over the times this attempt wrote, in
    // index order:
    // dense = y + P1 dy + P3 (dt k1 - dy) + P4 (2 dy - dt k1 - dt k7)
    //         + P5 dt sum_s d_s k_s.
    float wsum = 0.0f, s_dy = 0.0f, s_1 = 0.0f, s_7 = 0.0f, s_5 = 0.0f;
    bool wrote = false;
    const float hi = t + dt + tiny;
    for (int j0 = 0; j0 < T; j0 += 32) {
      const int j = j0 + lane;
      const float tj = j < T ? __ldg(ts + j) : 0.0f;
      unsigned hits = __ballot_sync(kFull, j < T && tj > t && tj <= hi);
      wrote = wrote || hits != 0u;
      while (hits) {
        const int bit = __ffs(hits) - 1;
        hits &= hits - 1;
        const float tb = __shfl_sync(kFull, tj, bit);
        const float th = fminf(fmaxf((tb - t) / dt_safe, 0.0f), 1.0f);
        const float th1 = 1.0f - th;
        const float P1 = th, P3 = th * th1, P4 = th * th * th1,
                    P5 = th * th * th1 * th1;
        const float c_dy = P1 - P3 + 2.0f * P4;
        const float w = own ? __ldg(yb + (j0 + bit) * D + lane) : 0.0f;
        wsum += w;
        s_dy += c_dy * w;
        s_1 += (P3 - P4) * w;
        s_7 += -P4 * w;
        s_5 += P5 * w;
      }
    }

    // Stage cotangents from y1 = y + dt sum_s b_s k_s and the dense sums.
    float kb[7];
    const float a = lam + s_dy;
    kb[0] = dt * (B1 * a + D1 * s_5) + dt * s_1;
    kb[1] = 0.0f;
    kb[2] = dt * (B3 * a + D3 * s_5);
    kb[3] = dt * (B4 * a + D4 * s_5);
    kb[4] = dt * (B5 * a + D5 * s_5);
    kb[5] = dt * (B6 * a + D6 * s_5);
    kb[6] = dt * (D7 * s_5) + dt * s_7;
    float ybm = lam + wsum;

    // Reverse through the stages; stage s's input is rebuilt from the
    // recorded k exactly as the forward formed it.
    float ub;
    if (wrote) {  // k7 = f(y + dt (B1 k1 + B3 k3 + B4 k4 + B5 k5 + B6 k6))
      const float u = y + dt * (B1 * k[0] + B3 * k[2] + B4 * k[3] +
                                B5 * k[4] + B6 * k[5]);
      ub = field_vjp<PG>(F, u, kb[6], gvec);
      ybm += ub;
      kb[0] += dt * (B1 * ub);
      kb[2] += dt * (B3 * ub);
      kb[3] += dt * (B4 * ub);
      kb[4] += dt * (B5 * ub);
      kb[5] += dt * (B6 * ub);
    }
    // k6
    ub = field_vjp<PG>(F, y + dt * (A61 * k[0] + A62 * k[1] + A63 * k[2] +
                                    A64 * k[3] + A65 * k[4]),
                       kb[5], gvec);
    ybm += ub;
    kb[0] += dt * (A61 * ub);
    kb[1] += dt * (A62 * ub);
    kb[2] += dt * (A63 * ub);
    kb[3] += dt * (A64 * ub);
    kb[4] += dt * (A65 * ub);
    // k5
    ub = field_vjp<PG>(
        F, y + dt * (A51 * k[0] + A52 * k[1] + A53 * k[2] + A54 * k[3]),
        kb[4], gvec);
    ybm += ub;
    kb[0] += dt * (A51 * ub);
    kb[1] += dt * (A52 * ub);
    kb[2] += dt * (A53 * ub);
    kb[3] += dt * (A54 * ub);
    // k4
    ub = field_vjp<PG>(F, y + dt * (A41 * k[0] + A42 * k[1] + A43 * k[2]),
                       kb[3], gvec);
    ybm += ub;
    kb[0] += dt * (A41 * ub);
    kb[1] += dt * (A42 * ub);
    kb[2] += dt * (A43 * ub);
    // k3
    ub = field_vjp<PG>(F, y + dt * (A31 * k[0] + A32 * k[1]), kb[2], gvec);
    ybm += ub;
    kb[0] += dt * (A31 * ub);
    kb[1] += dt * (A32 * ub);
    // k2
    ub = field_vjp<PG>(F, y + dt * (A21 * k[0]), kb[1], gvec);
    ybm += ub;
    kb[0] += dt * (A21 * ub);
    // k1 = f(y)
    ub = field_vjp<PG>(F, y, kb[0], gvec);
    lam = ybm + ub;
  }

  // Outputs at or before t0 read y0 directly.
  const float t0 = __ldg(ts);
  for (int j = 0; j < T; ++j)
    if (own && __ldg(ts + j) <= t0 + tiny) lam += __ldg(yb + j * D + lane);
  if (own) x0bar[(size_t)b * D + lane] = lam;
}

template <bool PG, bool ROWS>
__global__ void __launch_bounds__(kThreads)
kanfet_adjoint_bwd_kernel(const float* __restrict__ ts,
                          const float* __restrict__ ybar,
                          const float* __restrict__ rec,
                          const int* __restrict__ n_att,
                          const float* __restrict__ t_end,
                          const float* __restrict__ packed,
                          const int* __restrict__ dims,
                          float* __restrict__ part,
                          float* __restrict__ gscratch,
                          float* __restrict__ x0bar, Geo geo, int B, int T,
                          int ts_stride, float gate, float alpha,
                          float oma) {
  extern __shared__ float smem[];
  const float* P = stage_params<PG>(smem, packed, geo.n_params);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* after = smem + (PG ? 0 : geo.n_params);
  const Field F = make_field(geo, dims, P, after, gscratch, warp, gate, alpha,
                             oma);
  float* gsm = after + (geo.scratch_smem ? kWarps * geo.ws_floats : 0);
  float* gvec = geo.grads_smem
                    ? gsm + (size_t)warp * geo.n_grad
                    : part + ((size_t)blockIdx.x * kWarps + warp) * geo.n_grad;
  for (int i = lane; i < geo.n_grad; i += 32) gvec[i] = 0.0f;
  __syncwarp();
  const int b = blockIdx.x * kWarps + warp;
  if (b < B)  // the whole warp; no return: the block sums below
    replay<PG>(F, ROWS ? ts + (size_t)b * ts_stride : ts, ybar, rec, n_att,
               t_end, gvec, x0bar, b, B, T);
  if (geo.grads_smem) {
    // The block's warps in warp order into its row of part.
    __syncthreads();
    for (int i = threadIdx.x; i < geo.n_grad; i += kThreads) {
      float s = gsm[i];
      for (int w = 1; w < kWarps; ++w) s += gsm[(size_t)w * geo.n_grad + i];
      part[(size_t)blockIdx.x * geo.n_grad + i] = s;
    }
  }
}

// grads[g] = sum_r part[r*n_grad + g] over the rows r = 0..rows-1 in
// order, a thread per gradient entry: the same bits on every run.
__global__ void __launch_bounds__(256)
kanfet_adjoint_reduce_kernel(const float* __restrict__ part,
                             float* __restrict__ grads, int n_grad,
                             int rows) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_grad) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * n_grad + g];
  grads[g] = s;
}

template <bool PG, bool ROWS>
cudaError_t launch_fwd(const float* x0s, const float* ts, const float* packed,
                       const int* dims, float* out, float* rec, int* n_att,
                       float* t_end, float* gscratch, const Geo& geo, int B,
                       int T, int ts_stride, int max_steps, float rtol,
                       float atol, float gate, float alpha, float oma,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kanfet_adjoint_fwd_kernel<PG, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kWarps - 1) / kWarps;
  kanfet_adjoint_fwd_kernel<PG, ROWS>
      <<<blocks, kThreads, geo.smem_bytes, stream>>>(
      x0s, ts, packed, dims, out, rec, n_att, t_end, gscratch, geo, B, T,
      ts_stride, max_steps, rtol, atol, gate, alpha, oma);
  return cudaGetLastError();
}

template <bool PG, bool ROWS>
cudaError_t launch_bwd(const float* ts, const float* ybar, const float* rec,
                       const int* n_att, const float* t_end,
                       const float* packed, const int* dims, float* part,
                       float* gscratch, float* grads, float* x0bar,
                       const Geo& geo, int B, int T, int ts_stride,
                       float gate, float alpha, float oma,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kanfet_adjoint_bwd_kernel<PG, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kWarps - 1) / kWarps;
  kanfet_adjoint_bwd_kernel<PG, ROWS>
      <<<blocks, kThreads, geo.smem_bytes, stream>>>(
      ts, ybar, rec, n_att, t_end, packed, dims, part, gscratch, x0bar, geo,
      B, T, ts_stride, gate, alpha, oma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = geo.grads_smem ? blocks : blocks * kWarps;
  kanfet_adjoint_reduce_kernel<<<(geo.n_grad + 255) / 256, 256, 0, stream>>>(
      part, grads, geo.n_grad, rows);
  return cudaGetLastError();
}

}  // namespace

// Each returns 0 on success and a cudaError_t code if a launch failed.
// geo: the 13 host ints of kanfet_field.cuh: Geo for this kernel's
// placement; dims: the (L, 6) layer table on the device; gscratch:
// ceil(B / kWarps) * kWarps * ws_floats floats when the warp scratch is
// not in shared memory, else unused.  Trajectory b reads its T output
// times at ts + b * ts_stride: 0 shares one (T,) row, T gives each
// trajectory its own row of a (B, T) array.

// out (B, T, D); rec (max_steps, 3 + 8D, B); n_att (B,) int; t_end (B,).
extern "C" int kanfet_adjoint_fwd(const float* x0s, const float* ts,
                                  const float* packed, const int* dims,
                                  float* out, float* rec, int* n_att,
                                  float* t_end, float* gscratch,
                                  const int* geo, int B, int T, int ts_stride,
                                  int max_steps, float rtol, float atol,
                                  float gate, float alpha,
                                  float one_minus_alpha, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kanfet::Geo g = kanfet::read_geo(geo);
  const auto fn =
      g.params_smem
          ? (ts_stride ? launch_fwd<false, true> : launch_fwd<false, false>)
          : (ts_stride ? launch_fwd<true, true> : launch_fwd<true, false>);
  return (int)fn(x0s, ts, packed, dims, out, rec, n_att, t_end, gscratch, g,
                 B, T, ts_stride, max_steps, rtol, atol, gate, alpha,
                 one_minus_alpha, s);
}

// ybar (B, T, D); part: (blocks, n_grad) floats when the gradients are in
// shared memory, else (blocks * kWarps, n_grad), blocks = ceil(B /
// kWarps); grads (n_grad,); x0bar (B, D).
extern "C" int kanfet_adjoint_bwd(const float* ts, const float* ybar,
                                  const float* rec, const int* n_att,
                                  const float* t_end, const float* packed,
                                  const int* dims, float* part,
                                  float* gscratch, float* grads, float* x0bar,
                                  const int* geo, int B, int T, int ts_stride,
                                  float gate, float alpha,
                                  float one_minus_alpha, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kanfet::Geo g = kanfet::read_geo(geo);
  const auto fn =
      g.params_smem
          ? (ts_stride ? launch_bwd<false, true> : launch_bwd<false, false>)
          : (ts_stride ? launch_bwd<true, true> : launch_bwd<true, false>);
  return (int)fn(ts, ybar, rec, n_att, t_end, packed, dims, part, gscratch,
                 grads, x0bar, g, B, T, ts_stride, gate, alpha,
                 one_minus_alpha, s);
}
