// Discrete-adjoint KANFET NODE kernels for Hopper (sm_90a): the training
// solve of a two-layer [D, H, D] KANFET vector field.
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
// kanfet_adjoint_fwd: one thread per trajectory runs the same solve as
// the serving kernel (kanfet_field.cuh: dopri5_solve) and records every
// attempt m < max_steps: t, dt, the accepted flag, y and the seven stages
// k1..k7, R = 3 + 8D floats (19 for D = 2), stored as rec[(m*R + r)*B + b]
// so that a warp's stores coalesce; plus its attempt count and final t.
// At B = 256 and max_steps = 256 the records take 5 MB.
//
// kanfet_adjoint_bwd: one thread per trajectory replays its own attempts
// in reverse.  lambda starts as the cotangents of the unreached tail;
// each accepted attempt forms the dense-output sums P1, P3, P4, P5 over
// the times it wrote, builds the stage cotangents kbar, runs the field
// VJP through the seven stages in reverse (stage inputs rebuilt from the
// recorded k) and updates lambda.  Rejected attempts contribute nothing
// and are skipped, so each trajectory's own attempt count is exact.  The
// output times at or before t0 read y0 and add into x0bar at the end.
//
// What was hard, and what the design does about it:
// (a) Parameter gradients are a sum over trajectories, ~1.96k floats for
//     the flagship [2,10,2], K = 8: too many for registers, and threads of
//     one warp diverge (each trajectory has its own attempt count and
//     accept pattern), so warp shuffles cannot pre-sum them.  Each thread
//     accumulates into its own column of a (n_grad, B) scratch in device
//     memory (g*B + b: a warp's lanes touch neighbouring words), then
//     kanfet_adjoint_reduce sums each row in a fixed order (a strided
//     loop per lane and a shuffle tree).  No atomics: the result is
//     deterministic, the same bits on every run.
// (b) The field VJP needs the hidden activations and their cotangents.
//     The VJP walks the hidden units one at a time, as the forward does:
//     hidden unit j's activation is recomputed from the input, pushed
//     through layer 2's edges to form its cotangent, and pulled back
//     through layer 1's edges at once.  No hidden vector is kept, so H
//     stays a runtime value, bounded only by the shared memory that the
//     packed parameters take (checked by the wrapper, ValueError past it).
// (c) Numerics as in kanfet_field.cuh: float literals rounded once,
//     tiny = 1e-12f, no --use_fast_math; the wrapper turns TF32 off.
// (d) In float32 at rtol 1e-7 two correct solvers take different step
//     meshes, so the gradients are held against the plain replay on the
//     kernel's own records (a shared mesh), and only by cosine against a
//     plain solve on its own mesh.
//
// What bounds it on this card: as the serving kernel, one trajectory's
// serial chain (about 7 field VJPs per accepted attempt, each ~3 field
// evaluations of work plus ~1.96k read-modify-writes of the gradient
// column, which stay in L2 at B = 256: 2 MB).  At B <= 256 it fills at
// most 2 of 132 SMs.

#include "kanfet_field.cuh"

namespace {

using namespace kanfet;

// Writes one attempt's record into the (S, R, B) buffer.
struct Record {
  float* rec;  // this trajectory's column: rec + b
  int B;
  int* n_att;  // this trajectory's slot
  float* t_end;

  template <int D>
  __device__ __forceinline__ void attempt(
      int m, float t, float dt, bool accept, const float (&y)[D],
      const float (&k1)[D], const float (&k2)[D], const float (&k3)[D],
      const float (&k4)[D], const float (&k5)[D], const float (&k6)[D],
      const float (&k7)[D]) {
    constexpr int R = 3 + 8 * D;
    float* r = rec + (size_t)m * R * B;
    r[0] = t;
    r[B] = dt;
    r[2 * B] = accept ? 1.0f : 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      r[(3 + d) * B] = y[d];
      r[(3 + D + d) * B] = k1[d];
      r[(3 + 2 * D + d) * B] = k2[d];
      r[(3 + 3 * D + d) * B] = k3[d];
      r[(3 + 4 * D + d) * B] = k4[d];
      r[(3 + 5 * D + d) * B] = k5[d];
      r[(3 + 6 * D + d) * B] = k6[d];
      r[(3 + 7 * D + d) * B] = k7[d];
    }
  }
  __device__ __forceinline__ void finish(int n, float t) {
    *n_att = n;
    *t_end = t;
  }
};

template <int D, int ORD, int NK>
__global__ void __launch_bounds__(kThreads)
kanfet_adjoint_fwd_kernel(const float* __restrict__ x0s,
                          const float* __restrict__ ts_g,
                          const float* __restrict__ packed,
                          float* __restrict__ out, float* __restrict__ rec,
                          int* __restrict__ n_att, float* __restrict__ t_end,
                          int B, int T, int H, int K, int max_steps,
                          float rtol, float atol, float gate, float alpha,
                          float oma) {
  extern __shared__ float smem[];
  const float* ts;
  const Field p = load_field<D, ORD, NK>(smem, packed, ts_g, T, H, K, gate,
                                         alpha, oma, &ts);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Record r{rec + b, B, n_att + b, t_end + b};
  dopri5_solve<D, ORD, NK>(x0s + b * D, ts, T, out + (size_t)b * T * D,
                           max_steps, rtol, atol, p, r);
}

// --------------------------------------------------------------- backward

// One layer's gradient rows in the (n_grad, B) scratch, already offset to
// this trajectory's column: element i of a row is at row[i * B].  Same
// order as the packed parameters, without the knot grid.
struct GradLayer {
  float* bw;
  float* sw;
  float* fk;
  float* fec;
  float* fps;
  float* fbias;
  float* fcoef;
};

__device__ __forceinline__ GradLayer carve_grad(float*& g, int in, int out,
                                                int K, int C, int B) {
  GradLayer G;
  const int N = in * out * K;
  G.bw = g;    g += (size_t)out * in * B;
  G.sw = g;    g += (size_t)out * in * C * B;
  G.fk = g;    g += (size_t)N * B;
  G.fec = g;   g += (size_t)N * B;
  G.fps = g;   g += (size_t)N * B;
  G.fbias = g; g += (size_t)N * B;
  G.fcoef = g; g += (size_t)N * B;
  return G;
}

// Cox-de Boor bases of order ORD at x and their x-derivatives,
// dB_{m,p}/dx = p * (B_{m,p-1} / (g[m+p] - g[m])
//                    - B_{m+1,p-1} / (g[m+p+1] - g[m+1])).
template <int ORD, int NK>
__device__ __forceinline__ void bspline_d(float x, const float* g,
                                          float (&b)[NK - 1],
                                          float (&db)[NK - 1]) {
  constexpr int C = NK - 1 - ORD;
#pragma unroll
  for (int m = 0; m < NK - 1; ++m)
    b[m] = (x >= g[m] && x < g[m + 1]) ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 1; k < ORD; ++k) {
#pragma unroll
    for (int m = 0; m < NK - 1 - k; ++m)
      b[m] = ((x - g[m]) / (g[m + k] - g[m])) * b[m] +
             ((g[m + k + 1] - x) / (g[m + k + 1] - g[m + 1])) * b[m + 1];
  }
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const float ld = g[m + ORD] - g[m];
    const float rd = g[m + ORD + 1] - g[m + 1];
    db[m] = (float)ORD * (b[m] / ld - b[m + 1] / rd);
    b[m] = ((x - g[m]) / ld) * b[m] + ((g[m + ORD + 1] - x) / rd) * b[m + 1];
  }
}

// SiLU'(x) = s * (1 + x * (1 - s)), s = sigmoid(x).
__device__ __forceinline__ float silu_d(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// VJP of one ferro term (input x, cotangent w of its contribution):
// adds the five parameter gradients of term n and returns d/dx.  The
// branch simplifies exactly for the fresh state: target = 1 - 2*sd.
__device__ __forceinline__ float ferro_vjp(float x, float mu, const Layer& L,
                                           const GradLayer& G, int n, int B,
                                           float w, const Field& p) {
  const float ec = L.fec[n], kk = L.fk[n], ps = L.fps[n];
  const float cn = sigmoid(p.gate * (-x - ec));
  const float sd = (1.0f - mu) * cn;
  const float beta = p.alpha + p.oma * (1.0f - 2.0f * sd);
  const float zin = x + ec * beta;
  const float th = tanhf(kk * zin);
  const float fb = ps * th + L.fbias[n];
  const float fbar = L.fcoef[n] * w;
  const float sech2 = 1.0f - th * th;
  G.fcoef[n * B] += fb * w;
  G.fps[n * B] += th * fbar;
  G.fbias[n * B] += fbar;
  G.fk[n * B] += ps * zin * sech2 * fbar;
  const float gs1a = p.gate * p.oma;
  const float dbeta_dec = 2.0f * gs1a * (1.0f - mu) * cn * (1.0f - cn);
  const float dbeta_dx = 2.0f * gs1a * (1.0f - mu) * cn * (mu + 1.0f - cn);
  const float common = ps * kk * sech2 * fbar;
  G.fec[n * B] += common * (beta + ec * dbeta_dec);
  return common * (1.0f + ec * dbeta_dx);
}

// xbar = (d field / d x)^T w at x, adding the parameter gradients into
// this trajectory's columns.  Walks the hidden units one at a time.
template <int D, int ORD, int NK>
__device__ __forceinline__ void field_vjp(const float (&x)[D],
                                          const float (&w)[D],
                                          float (&xbar)[D], const Field& p,
                                          const GradLayer& g1,
                                          const GradLayer& g2, int B) {
  constexpr int C = NK - 1 - ORD;
  const int H = p.H, K = p.K;
  float s1[D], ds1[D], mu1[D], b1[D][NK - 1], db1[D][NK - 1];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    s1[i] = silu(x[i]);
    ds1[i] = silu_d(x[i]);
    mu1[i] = sigmoid(p.gate * x[i]);
    bspline_d<ORD, NK>(x[i], p.l1.grid + i * NK, b1[i], db1[i]);
    xbar[i] = 0.0f;
  }

  for (int j = 0; j < H; ++j) {
    // Layer 1 forward, hidden unit j.
    float h = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      h += p.l1.bw[j * D + i] * s1[i];
#pragma unroll
      for (int c = 0; c < C; ++c) h += p.l1.sw[(j * D + i) * C + c] * b1[i][c];
      for (int k = 0; k < K; ++k)
        h += ferro(x[i], mu1[i], p.l1, (i * H + j) * K + k, p);
    }
    // Layer 2 backward at input j: its edges to each output.
    float b2[NK - 1], db2[NK - 1];
    bspline_d<ORD, NK>(h, p.l2.grid + j * NK, b2, db2);
    const float s2 = silu(h), ds2 = silu_d(h);
    const float mu2 = sigmoid(p.gate * h);
    float hbar = 0.0f;
#pragma unroll
    for (int o = 0; o < D; ++o) {
      const float wo = w[o];
      g2.bw[(o * H + j) * B] += wo * s2;
      hbar += wo * p.l2.bw[o * H + j] * ds2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g2.sw[((o * H + j) * C + c) * B] += wo * b2[c];
        hbar += wo * p.l2.sw[(o * H + j) * C + c] * db2[c];
      }
      for (int k = 0; k < K; ++k)
        hbar += ferro_vjp(h, mu2, p.l2, g2, (j * D + o) * K + k, B, wo, p);
    }
    // Layer 1 backward, hidden unit j, cotangent hbar.
#pragma unroll
    for (int i = 0; i < D; ++i) {
      g1.bw[(j * D + i) * B] += hbar * s1[i];
      float xb = hbar * p.l1.bw[j * D + i] * ds1[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g1.sw[((j * D + i) * C + c) * B] += hbar * b1[i][c];
        xb += hbar * p.l1.sw[(j * D + i) * C + c] * db1[i][c];
      }
      for (int k = 0; k < K; ++k)
        xb += ferro_vjp(x[i], mu1[i], p.l1, g1, (i * H + j) * K + k, B, hbar,
                        p);
      xbar[i] += xb;
    }
  }
}

template <int D, int ORD, int NK>
__global__ void __launch_bounds__(kThreads)
kanfet_adjoint_bwd_kernel(const float* __restrict__ ts_g,
                          const float* __restrict__ ybar_g,
                          const float* __restrict__ rec,
                          const int* __restrict__ n_att,
                          const float* __restrict__ t_end,
                          const float* __restrict__ packed,
                          float* __restrict__ gacc, float* __restrict__ x0bar,
                          int B, int T, int H, int K, int n_grad, float gate,
                          float alpha, float oma) {
  constexpr int C = NK - 1 - ORD;
  constexpr int R = 3 + 8 * D;
  extern __shared__ float smem[];
  const float* ts;
  const Field p = load_field<D, ORD, NK>(smem, packed, ts_g, T, H, K, gate,
                                         alpha, oma, &ts);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  for (int i = 0; i < n_grad; ++i) gacc[(size_t)i * B + b] = 0.0f;
  float* gcur = gacc + b;
  const GradLayer g1 = carve_grad(gcur, D, H, K, C, B);
  const GradLayer g2 = carve_grad(gcur, H, D, K, C, B);
  const float* yb = ybar_g + (size_t)b * T * D;
  const float tiny = 1e-12f;

  // lambda: cotangents of the outputs past the frontier land on y_final.
  float lam[D];
  {
    const float te = t_end[b];
#pragma unroll
    for (int d = 0; d < D; ++d) lam[d] = 0.0f;
    for (int j = 0; j < T; ++j)
      if (ts[j] > te + tiny) {
#pragma unroll
        for (int d = 0; d < D; ++d) lam[d] += yb[j * D + d];
      }
  }

  for (int m = n_att[b] - 1; m >= 0; --m) {
    const float* r = rec + (size_t)m * R * B + b;
    if (r[2 * B] < 0.5f) continue;  // rejected: lambda passes through
    const float t = r[0], dt = r[B];
    const float dt_safe = (dt == 0.0f) ? 1.0f : dt;
    float y[D], k[7][D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      y[d] = r[(3 + d) * B];
#pragma unroll
      for (int s = 0; s < 7; ++s) k[s][d] = r[(3 + (s + 1) * D + d) * B];
    }

    // Dense-output cotangent sums over the times this attempt wrote:
    // dense = y + P1 dy + P3 (dt k1 - dy) + P4 (2 dy - dt k1 - dt k7)
    //         + P5 dt sum_s d_s k_s.
    float wsum[D], s_dy[D], s_1[D], s_7[D], s_5[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      wsum[d] = s_dy[d] = s_1[d] = s_7[d] = s_5[d] = 0.0f;
    const float hi = t + dt + tiny;
    for (int j = 0; j < T; ++j) {
      const float tj = ts[j];
      if (tj > t && tj <= hi) {
        const float th = fminf(fmaxf((tj - t) / dt_safe, 0.0f), 1.0f);
        const float th1 = 1.0f - th;
        const float P1 = th, P3 = th * th1, P4 = th * th * th1,
                    P5 = th * th * th1 * th1;
        const float c_dy = P1 - P3 + 2.0f * P4;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float w = yb[j * D + d];
          wsum[d] += w;
          s_dy[d] += c_dy * w;
          s_1[d] += (P3 - P4) * w;
          s_7[d] += -P4 * w;
          s_5[d] += P5 * w;
        }
      }
    }

    // Stage cotangents from y1 = y + dt sum_s b_s k_s and the dense sums.
    float kb[7][D], ybm[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a = lam[d] + s_dy[d];
      kb[0][d] = dt * (B1 * a + D1 * s_5[d]) + dt * s_1[d];
      kb[1][d] = 0.0f;
      kb[2][d] = dt * (B3 * a + D3 * s_5[d]);
      kb[3][d] = dt * (B4 * a + D4 * s_5[d]);
      kb[4][d] = dt * (B5 * a + D5 * s_5[d]);
      kb[5][d] = dt * (B6 * a + D6 * s_5[d]);
      kb[6][d] = dt * (D7 * s_5[d]) + dt * s_7[d];
      ybm[d] = lam[d] + wsum[d];
    }

    // Reverse through the stages; stage s's input is rebuilt from the
    // recorded k exactly as the forward formed it.
    float u[D], ub[D];
    // k7 = f(y + dt (B1 k1 + B3 k3 + B4 k4 + B5 k5 + B6 k6))
#pragma unroll
    for (int d = 0; d < D; ++d)
      u[d] = y[d] + dt * (B1 * k[0][d] + B3 * k[2][d] + B4 * k[3][d] +
                          B5 * k[4][d] + B6 * k[5][d]);
    field_vjp<D, ORD, NK>(u, kb[6], ub, p, g1, g2, B);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ybm[d] += ub[d];
      kb[0][d] += dt * (B1 * ub[d]);
      kb[2][d] += dt * (B3 * ub[d]);
      kb[3][d] += dt * (B4 * ub[d]);
      kb[4][d] += dt * (B5 * ub[d]);
      kb[5][d] += dt * (B6 * ub[d]);
    }
    // k6
#pragma unroll
    for (int d = 0; d < D; ++d)
      u[d] = y[d] + dt * (A61 * k[0][d] + A62 * k[1][d] + A63 * k[2][d] +
                          A64 * k[3][d] + A65 * k[4][d]);
    field_vjp<D, ORD, NK>(u, kb[5], ub, p, g1, g2, B);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ybm[d] += ub[d];
      kb[0][d] += dt * (A61 * ub[d]);
      kb[1][d] += dt * (A62 * ub[d]);
      kb[2][d] += dt * (A63 * ub[d]);
      kb[3][d] += dt * (A64 * ub[d]);
      kb[4][d] += dt * (A65 * ub[d]);
    }
    // k5
#pragma unroll
    for (int d = 0; d < D; ++d)
      u[d] = y[d] + dt * (A51 * k[0][d] + A52 * k[1][d] + A53 * k[2][d] +
                          A54 * k[3][d]);
    field_vjp<D, ORD, NK>(u, kb[4], ub, p, g1, g2, B);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ybm[d] += ub[d];
      kb[0][d] += dt * (A51 * ub[d]);
      kb[1][d] += dt * (A52 * ub[d]);
      kb[2][d] += dt * (A53 * ub[d]);
      kb[3][d] += dt * (A54 * ub[d]);
    }
    // k4
#pragma unroll
    for (int d = 0; d < D; ++d)
      u[d] = y[d] + dt * (A41 * k[0][d] + A42 * k[1][d] + A43 * k[2][d]);
    field_vjp<D, ORD, NK>(u, kb[3], ub, p, g1, g2, B);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ybm[d] += ub[d];
      kb[0][d] += dt * (A41 * ub[d]);
      kb[1][d] += dt * (A42 * ub[d]);
      kb[2][d] += dt * (A43 * ub[d]);
    }
    // k3
#pragma unroll
    for (int d = 0; d < D; ++d)
      u[d] = y[d] + dt * (A31 * k[0][d] + A32 * k[1][d]);
    field_vjp<D, ORD, NK>(u, kb[2], ub, p, g1, g2, B);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ybm[d] += ub[d];
      kb[0][d] += dt * (A31 * ub[d]);
      kb[1][d] += dt * (A32 * ub[d]);
    }
    // k2
#pragma unroll
    for (int d = 0; d < D; ++d) u[d] = y[d] + dt * (A21 * k[0][d]);
    field_vjp<D, ORD, NK>(u, kb[1], ub, p, g1, g2, B);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ybm[d] += ub[d];
      kb[0][d] += dt * (A21 * ub[d]);
    }
    // k1 = f(y)
    field_vjp<D, ORD, NK>(y, kb[0], ub, p, g1, g2, B);
#pragma unroll
    for (int d = 0; d < D; ++d) lam[d] = ybm[d] + ub[d];
  }

  // Outputs at or before t0 read y0 directly.
  const float t0 = ts[0];
  for (int j = 0; j < T; ++j)
    if (ts[j] <= t0 + tiny) {
#pragma unroll
      for (int d = 0; d < D; ++d) lam[d] += yb[j * D + d];
    }
#pragma unroll
  for (int d = 0; d < D; ++d) x0bar[b * D + d] = lam[d];
}

// grads[g] = sum_b gacc[g*B + b]: one warp per gradient row, each lane a
// strided partial sum, then a shuffle tree.  A fixed order: the same
// bits on every run.
__global__ void __launch_bounds__(256)
kanfet_adjoint_reduce_kernel(const float* __restrict__ gacc,
                             float* __restrict__ grads, int n_grad, int B) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_grad) return;  // whole warps leave together
  const float* g = gacc + (size_t)row * B;
  float s = 0.0f;
  for (int b = lane; b < B; b += 32) s += g[b];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) grads[row] = s;
}

template <int D, int ORD, int NK>
cudaError_t launch_fwd(const float* x0s, const float* ts, const float* packed,
                       float* out, float* rec, int* n_att, float* t_end,
                       int B, int T, int H, int K, int max_steps, float rtol,
                       float atol, float gate, float alpha, float oma,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(n_params<D, ORD, NK>(H, K) + T) * sizeof(float);
  const int blocks = (B + kThreads - 1) / kThreads;
  kanfet_adjoint_fwd_kernel<D, ORD, NK><<<blocks, kThreads, smem, stream>>>(
      x0s, ts, packed, out, rec, n_att, t_end, B, T, H, K, max_steps, rtol,
      atol, gate, alpha, oma);
  return cudaGetLastError();
}

template <int D, int ORD, int NK>
cudaError_t launch_bwd(const float* ts, const float* ybar, const float* rec,
                       const int* n_att, const float* t_end,
                       const float* packed, float* gacc, float* grads,
                       float* x0bar, int B, int T, int H, int K, float gate,
                       float alpha, float oma, cudaStream_t stream) {
  const int np = n_params<D, ORD, NK>(H, K);
  const int n_grad = np - (D + H) * NK;  // no gradient for the knot grid
  const size_t smem = (size_t)(np + T) * sizeof(float);
  const int blocks = (B + kThreads - 1) / kThreads;
  kanfet_adjoint_bwd_kernel<D, ORD, NK><<<blocks, kThreads, smem, stream>>>(
      ts, ybar, rec, n_att, t_end, packed, gacc, x0bar, B, T, H, K, n_grad,
      gate, alpha, oma);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows_per_block = 256 / 32;
  kanfet_adjoint_reduce_kernel<<<(n_grad + rows_per_block - 1) / rows_per_block,
                                 256, 0, stream>>>(gacc, grads, n_grad, B);
  return cudaGetLastError();
}

}  // namespace

// Each returns 0 on success, a cudaError_t code if a launch failed, and
// -1 for a shape the kernels are not compiled for (the Python wrapper
// checks shapes first: fetode_tpu_torch/ops/kanfet_node.py KERNEL_SHAPES).

// out (B, T, D); rec (max_steps, 3 + 8D, B); n_att (B,) int; t_end (B,).
extern "C" int kanfet_adjoint_fwd(const float* x0s, const float* ts,
                                  const float* packed, float* out, float* rec,
                                  int* n_att, float* t_end, int B, int T,
                                  int D, int H, int K, int spline_order,
                                  int n_knots, int max_steps, float rtol,
                                  float atol, float gate, float alpha,
                                  float one_minus_alpha, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 2 && spline_order == 3 && n_knots == 12)
    return (int)launch_fwd<2, 3, 12>(x0s, ts, packed, out, rec, n_att, t_end,
                                     B, T, H, K, max_steps, rtol, atol, gate,
                                     alpha, one_minus_alpha, s);
  return -1;
}

// ybar (B, T, D); gacc (n_grad, B) scratch; grads (n_grad,); x0bar (B, D).
extern "C" int kanfet_adjoint_bwd(const float* ts, const float* ybar,
                                  const float* rec, const int* n_att,
                                  const float* t_end, const float* packed,
                                  float* gacc, float* grads, float* x0bar,
                                  int B, int T, int D, int H, int K,
                                  int spline_order, int n_knots, float gate,
                                  float alpha, float one_minus_alpha,
                                  void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 2 && spline_order == 3 && n_knots == 12)
    return (int)launch_bwd<2, 3, 12>(ts, ybar, rec, n_att, t_end, packed, gacc,
                                     grads, x0bar, B, T, H, K, gate, alpha,
                                     one_minus_alpha, s);
  return -1;
}
