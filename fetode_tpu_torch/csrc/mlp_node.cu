// Whole-solve kernels of the ECG KanFetNODE 'mlp' latent field for Hopper
// (sm_90a): the forward dopri5 solve over [0, 1] (with or without
// per-attempt records) and the reverse replay, the discrete adjoint on the
// recorded step mesh.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_mlp_node.py:232
// (make_mlp_node_solver; forward _make_fwd_kernel :150, pallas_call :280;
// backward _make_bwd_kernel :173, pallas_call :308).  With L = D*K, l =
// d*K + k, and C = 8 cubic B-spline columns on each feature's own 12
// knots (Cox-de Boor on half-open intervals, as ops/bsplines.py):
//
//   h   = LayerNorm(y; lns, lnb)  (eps 1e-5, biased variance over D)
//   hb  = h_bound tanh(h / h_bound)
//   phi[b, l] = sigmoid(2 sigmoid(a[l] (hb[b, l/K] - b[l])))
//   y1  = silu(phi) bw1^T + sum_c B_c(phi) sw1_c^T    sw1: (H, L, C)
//   y2  = silu(y1) bw2^T + sum_c B_c(y1) sw2_c^T      sw2: (H, H, C)
//   f   = eff (silu(y2) W^T + bo)
//
// sw = spline_weight * spline_scaler and eff = scale softplus(log_alpha)
// are formed outside the kernels, and their chain rules run outside too.
// The solve and the replay are node_common.cuh's final-state pair; this
// file holds the field and its hand-written VJP.  Every product runs in
// the kernel's own body in FP32 FMAs (no cuBLAS, no torch.matmul, no
// TF32).
//
// Field evaluation, five grid phases:
//   (A) one warp per row b: mean and variance over D (two passes, a fixed
//       shuffle tree), the normalised row and the tanh bound;
//   (B) one thread per (b, l): the mixer, silu(phi) and the 8 layer-1
//       basis columns of phi;
//   (C) layer 1, (D) layer 2: one warp per (output o, tile of kRows rows),
//       lanes striding over the inputs and the (input, column) pairs, a
//       fixed shuffle tree; the tile's rows share each weight read.  The
//       lane that owns a row of (C) also forms silu(y1) and y1's 8 layer-2
//       basis columns, so layer 2 starts after one barrier;
//   (E) the output layer, one warp per (b, d).
// VJP with cotangent w (B, D): (A)-(D) again, then four phases in which
// every element of a product or a gradient is owned by one thread that
// sums in a fixed order:
//   (1) t[b, j] = sum_d w W[d, j], y2bar = eff t silu'(y2);
//       gW[d, j] += eff sum_b w z;  gbo[d] += eff sum_b w;
//   (2) gbw2, gsw2[o, i, :] (an item per (o, i), summed over b);
//       y1bar[b, i] = silu'(y1) sum_o y2bar bw2 + sum_c B'_c(y1) sum_o
//       y2bar sw2[o, i, c], with the analytic derivative
//       B'_j = 3 (B2_j / (g[j+3] - g[j]) - B2_{j+1} / (g[j+4] - g[j+1]));
//       geff += sum z t + sum_d bo[d] sum_b w (one warp);
//   (3) the same for layer 1, ending in zb = phibar 2 phi (1 - phi)
//       s1 (1 - s1);
//   (4) ga, gb (a thread per l), glns, glnb (a thread per d) and, a warp
//       per row, the layer-norm backward ubar = rstd (xnbar - m1 - xn m2).
// No atomics: the gradients are the same bits on every run.
//
// What bounds it on this card: at the ECG widths (D = 64, K = 12, L = 768,
// H = 128, B = 8) a field evaluation is about 2 B H L (C + 1) = 14 M FLOP
// plus 8 basis columns of B L + B H points, a few microseconds of the
// card's FP32 rate at most, and the solve takes 6 evaluations for each of
// its attempts.  It is bound by its serial chain of grid barriers (six
// per evaluation with the scaffold's, nine per VJP, plus the reductions);
// the design keeps to the barriers the data flow needs and spreads every
// phase over every SM.  The layer-1 weights, 3.1 MB, stay in L2.

#include "node_common.cuh"

namespace {

using namespace node_common;

constexpr int kC = 8;       // basis columns: grid 5 + order 3
constexpr int kNK = 12;     // knots a feature: grid 5 + 2 * order 3 + 1
constexpr int kRows = 4;    // batch rows a warp takes in the layer products
constexpr int kNG = 11;     // gradients
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// The 8 degree-3 basis columns of x on the knots g[0..11] and, with
// kDeriv, their derivatives from the degree-2 columns.
template <bool kDeriv>
__device__ __forceinline__ void bspline(float x, const float* g,
                                        float (&b3)[kC], float (&d3)[kC]) {
  float gk[kNK];
#pragma unroll
  for (int j = 0; j < kNK; ++j) gk[j] = g[j];
  float b[kNK - 1];
#pragma unroll
  for (int j = 0; j < kNK - 1; ++j)
    b[j] = (x >= gk[j] && x < gk[j + 1]) ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 1; k <= 3; ++k) {
    if (kDeriv && k == 3) {
#pragma unroll
      for (int j = 0; j < kC; ++j)
        d3[j] = 3.0f * (b[j] / (gk[j + 3] - gk[j]) -
                        b[j + 1] / (gk[j + 4] - gk[j + 1]));
    }
#pragma unroll
    for (int j = 0; j < kNK - 1 - k; ++j)
      b[j] = (x - gk[j]) / (gk[j + k] - gk[j]) * b[j] +
             (gk[j + k + 1] - x) / (gk[j + k + 1] - gk[j + 1]) * b[j + 1];
  }
#pragma unroll
  for (int j = 0; j < kC; ++j) b3[j] = b[j];
}

struct MlpField {
  // operands
  const float* lns;  // (D) layer-norm scale
  const float* lnb;  // (D) layer-norm bias
  const float* av;   // (L) mixer slope
  const float* bv;   // (L) mixer centre
  const float* g1;   // (L, 12) layer-1 knots
  const float* bw1;  // (H, L)
  const float* sw1;  // (H, L, C) scaled spline weight
  const float* g2;   // (H, 12)
  const float* bw2;  // (H, H)
  const float* sw2;  // (H, H, C)
  const float* ow;   // (D, H)
  const float* ob;   // (D)
  const float* eff;  // (1)
  // scratch
  float* xn;     // (B, D) normalised state
  float* th;     // (B, D) tanh of the bound
  float* rstd;   // (B)
  float* s1;     // (B, L) inner sigmoid
  float* phi;    // (B, L)
  float* sphi;   // (B, L) silu(phi)
  float* bas1;   // (B, L, C)
  float* y1;     // (B, H)
  float* sy1;    // (B, H) silu(y1)
  float* bas2;   // (B, H, C)
  float* y2;     // (B, H)
  float* z;      // (B, H) silu(y2)
  float* t2;     // (B, H) VJP: w W
  float* y2bar;  // (B, H) VJP
  float* y1bar;  // (B, H) VJP
  float* zb;     // (B, L) VJP: the mixer's inner cotangent
  // gradients, VJP only, shaped as their operands
  float* g[kNG];  // glns, glnb, ga, gb, gbw1, gsw1, gbw2, gsw2, gW, gbo, geff
  int B, D, K, L, H;
  float hbound;

  // (A): xn, th and rstd of the state u.
  __device__ void norm(const float* u) const {
    const int lane = lane_id();
    const float inv_d = 1.0f / (float)D;
    for (int b = grid_warp(); b < B; b += grid_warps()) {
      const float* urow = u + b * D;
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) s += ld(urow + d);
      const float mu = warp_sum(s) * inv_d;
      float v = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float c = ld(urow + d) - mu;
        v += c * c;
      }
      const float r = 1.0f / sqrtf(warp_sum(v) * inv_d + kLnEps);
      for (int d = lane; d < D; d += 32) {
        const float x = (ld(urow + d) - mu) * r;
        xn[b * D + d] = x;
        th[b * D + d] = tanhf((x * lns[d] + lnb[d]) / hbound);
      }
      if (lane == 0) rstd[b] = r;
    }
  }

  // (B): the mixer and layer 1's inputs.
  __device__ void mixer() const {
    const int tid = grid_tid(), nth = grid_threads();
    for (int i = tid; i < B * L; i += nth) {
      const int b = i / L, l = i - b * L;
      const float x = hbound * ld(th + b * D + l / K);
      const float s = sigmoid(av[l] * (x - bv[l]));
      const float p = sigmoid(2.0f * s);
      s1[i] = s;
      phi[i] = p;
      sphi[i] = silu(p);
      float c3[kC], unused[kC];
      bspline<false>(p, g1 + l * kNK, c3, unused);
#pragma unroll
      for (int c = 0; c < kC; ++c) bas1[(size_t)i * kC + c] = c3[c];
    }
  }

  // One warp: acc[r] = sum_i xs[b_r, i] bw[o, i] + sum_j bas[b_r, j]
  // sw[o, j] over the n inputs and n*C (input, column) pairs, for the rows
  // b_r = b0 + r (clamped to B - 1; the caller drops those past B); every
  // lane gets the totals.
  __device__ void layer_rows(const float* xs, const float* bas,
                             const float* bw, const float* sw, int n, int o,
                             int b0, float (&acc)[kRows]) const {
    const int lane = lane_id();
    int rows[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      rows[r] = min(b0 + r, B - 1);
      acc[r] = 0.0f;
    }
    const float* wrow = bw + (size_t)o * n;
    for (int i = lane; i < n; i += 32) {
      const float wv = wrow[i];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] += ld(xs + (size_t)rows[r] * n + i) * wv;
    }
    const int nc = n * kC;
    const float* srow = sw + (size_t)o * nc;
    for (int j = lane; j < nc; j += 32) {
      const float wv = srow[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] += ld(bas + (size_t)rows[r] * nc + j) * wv;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
  }

  // (C) with which == 1: y1, silu(y1) and y1's layer-2 basis columns;
  // (D) with which == 2: y2 and z = silu(y2).
  __device__ void kan_layer(int which) const {
    const int lane = lane_id();
    const int tiles = (B + kRows - 1) / kRows;
    const int n = which == 1 ? L : H;
    for (int q = grid_warp(); q < H * tiles; q += grid_warps()) {
      const int o = q % H, b0 = (q / H) * kRows;
      float acc[kRows];
      if (which == 1)
        layer_rows(sphi, bas1, bw1, sw1, n, o, b0, acc);
      else
        layer_rows(sy1, bas2, bw2, sw2, n, o, b0, acc);
      float v = acc[0];
#pragma unroll
      for (int r = 1; r < kRows; ++r)
        if (lane == r) v = acc[r];
      const int b = b0 + lane;
      if (lane >= kRows || b >= B) continue;
      const int e = b * H + o;
      if (which == 1) {
        y1[e] = v;
        sy1[e] = silu(v);
        float c3[kC], unused[kC];
        bspline<false>(v, g2 + o * kNK, c3, unused);
#pragma unroll
        for (int c = 0; c < kC; ++c) bas2[(size_t)e * kC + c] = c3[c];
      } else {
        y2[e] = v;
        z[e] = silu(v);
      }
    }
  }

  // (A)-(D) of the state u, a grid barrier after each.
  __device__ void hidden(const float* u) const {
    cg::grid_group grid = cg::this_grid();
    norm(u);
    grid.sync();
    mixer();
    grid.sync();
    kan_layer(1);
    grid.sync();
    kan_layer(2);
    grid.sync();
  }

  __device__ void eval(const float* u, float* out) const {
    hidden(u);
    // (E) the output layer.
    const int lane = lane_id();
    const float e = *eff;
    for (int q = grid_warp(); q < B * D; q += grid_warps()) {
      const int b = q / D, d = q - b * D;
      const float* zrow = z + b * H;
      const float* wrow = ow + d * H;
      float acc = 0.0f;
      for (int j = lane; j < H; j += 32) acc += ld(zrow + j) * wrow[j];
      acc = warp_sum(acc);
      if (lane == 0) out[q] = e * (acc + ob[d]);
    }
  }

  // Item (o, i) of a layer's weight gradients over n inputs, summed over
  // b: gbw[o, i] += sum_b ybar[b, o] xs[b, i] and gsw[o, i, c] += sum_b
  // ybar[b, o] bas[b, i, c].
  __device__ void weight_grads(int item, int n, const float* xs,
                               const float* bas, const float* ybar,
                               float* gbw, float* gsw) const {
    const int o = item / n, i = item - o * n;
    float sb = 0.0f, sc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) sc[c] = 0.0f;
    for (int b = 0; b < B; ++b) {
      const float yb = ld(ybar + b * H + o);
      sb += yb * ld(xs + (size_t)b * n + i);
      const float* brow = bas + ((size_t)b * n + i) * kC;
#pragma unroll
      for (int c = 0; c < kC; ++c) sc[c] += yb * ld(brow + c);
    }
    gbw[item] = ld(gbw + item) + sb;
    float* gs = gsw + (size_t)item * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) gs[c] = ld(gs + c) + sc[c];
  }

  // The cotangent of a layer's input x[b, i] (e = b n + i): silu'(x)
  // sum_o ybar[b, o] bw[o, i] + sum_c B'_c(x) sum_o ybar[b, o] sw[o, i, c].
  __device__ float input_bar(int e, int n, const float* x, const float* gk,
                             const float* bw, const float* sw,
                             const float* ybar) const {
    const int b = e / n, i = e - b * n;
    const float xv = ld(x + e);
    float c3[kC], d3[kC];
    bspline<true>(xv, gk + i * kNK, c3, d3);
    float sb = 0.0f, sc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) sc[c] = 0.0f;
    for (int o = 0; o < H; ++o) {
      const float yb = ld(ybar + b * H + o);
      sb += yb * bw[(size_t)o * n + i];
      const float* srow = sw + ((size_t)o * n + i) * kC;
#pragma unroll
      for (int c = 0; c < kC; ++c) sc[c] += yb * srow[c];
    }
    float v = sb * dsilu(xv);
#pragma unroll
    for (int c = 0; c < kC; ++c) v += sc[c] * d3[c];
    return v;
  }

  __device__ void vjp(const float* u, const float* w, float* ubar) const {
    cg::grid_group grid = cg::this_grid();
    hidden(u);
    const int tid = grid_tid(), nth = grid_threads(), lane = lane_id();
    const float e = *eff;
    float *glns = g[0], *glnb = g[1], *gav = g[2], *gbv = g[3];
    float *gbw1 = g[4], *gsw1 = g[5], *gbw2 = g[6], *gsw2 = g[7];
    float *gow = g[8], *gob = g[9], *geff = g[10];
    // (1) t and y2bar; gW, gbo.
    const int nBH = B * H, nDH = D * H;
    for (int i = tid; i < nBH + nDH + D; i += nth) {
      if (i < nBH) {
        const int b = i / H, j = i - b * H;
        float s = 0.0f;
        for (int d = 0; d < D; ++d) s += ld(w + b * D + d) * ow[d * H + j];
        t2[i] = s;
        y2bar[i] = e * s * dsilu(ld(y2 + i));
      } else if (i < nBH + nDH) {
        const int q = i - nBH, d = q / H, j = q - d * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * D + d) * ld(z + b * H + j);
        gow[q] = ld(gow + q) + e * s;
      } else {
        const int d = i - nBH - nDH;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * D + d);
        gob[d] = ld(gob + d) + e * s;
      }
    }
    grid.sync();
    // (2) layer 2's gradients and y1bar; geff from the grid's last warp.
    for (int i = tid; i < H * H + nBH; i += nth) {
      if (i < H * H)
        weight_grads(i, H, sy1, bas2, y2bar, gbw2, gsw2);
      else
        y1bar[i - H * H] = input_bar(i - H * H, H, y1, g2, bw2, sw2, y2bar);
    }
    if (grid_warp() == grid_warps() - 1) {
      float s = 0.0f;
      for (int i = lane; i < nBH; i += 32) s += ld(z + i) * ld(t2 + i);
      for (int i = lane; i < B * D; i += 32) s += ld(w + i) * ob[i % D];
      s = warp_sum(s);
      if (lane == 0) geff[0] = ld(geff) + s;
    }
    grid.sync();
    // (3) layer 1's gradients and phibar, then zb.
    for (int i = tid; i < H * L + B * L; i += nth) {
      if (i < H * L) {
        weight_grads(i, L, sphi, bas1, y1bar, gbw1, gsw1);
      } else {
        const int q = i - H * L;
        const float p = ld(phi + q), s = ld(s1 + q);
        zb[q] = input_bar(q, L, phi, g1, bw1, sw1, y1bar) *
                (2.0f * p * (1.0f - p)) * (s * (1.0f - s));
      }
    }
    grid.sync();
    // (4) the mixer's and the layer norm's gradients, and ubar.
    for (int i = tid; i < L + D; i += nth) {
      if (i < L) {
        const int l = i;
        float sa = 0.0f, sb = 0.0f;
        for (int b = 0; b < B; ++b) {
          const float zv = ld(zb + b * L + l);
          sa += zv * (hbound * ld(th + b * D + l / K) - bv[l]);
          sb += -zv * av[l];
        }
        gav[l] = ld(gav + l) + sa;
        gbv[l] = ld(gbv + l) + sb;
      } else {
        const int d = i - L;
        float ss = 0.0f, sb = 0.0f;
        for (int b = 0; b < B; ++b) {
          const float hl = hln_bar(b, d);
          ss += hl * ld(xn + b * D + d);
          sb += hl;
        }
        glns[d] = ld(glns + d) + ss;
        glnb[d] = ld(glnb + d) + sb;
      }
    }
    const float inv_d = 1.0f / (float)D;
    for (int b = grid_warp(); b < B; b += grid_warps()) {
      float m1 = 0.0f, m2 = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float xb = hln_bar(b, d) * lns[d];
        m1 += xb;
        m2 += xb * ld(xn + b * D + d);
      }
      m1 = warp_sum(m1) * inv_d;
      m2 = warp_sum(m2) * inv_d;
      const float r = ld(rstd + b);
      for (int d = lane; d < D; d += 32) {
        const float xb = hln_bar(b, d) * lns[d];
        ubar[b * D + d] = r * (xb - m1 - ld(xn + b * D + d) * m2);
      }
    }
  }

  // The cotangent of the layer norm's output at (b, d): the mixer's
  // cotangent summed over the K bases of feature d, through the tanh
  // bound.
  __device__ float hln_bar(int b, int d) const {
    const float* zrow = zb + b * L + d * K;
    float s = 0.0f;
    for (int k = 0; k < K; ++k) s += ld(zrow + k) * av[d * K + k];
    const float t = ld(th + b * D + d);
    return s * (1.0f - t * t);
  }
};

struct FwdArgs {
  MlpField f;
  SolveBufs s;
};

struct BwdArgs {
  MlpField f;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kThreads) mlp_node_fwd_kernel(FwdArgs a) {
  adaptive_solve_final<kRecord>(a.f, a.s);
}

// Element counts of the gradients, in the order of MlpField::g.
__host__ __device__ inline void grad_sizes(int D, int K, int H,
                                           size_t (&n)[kNG]) {
  const size_t L = (size_t)D * K;
  const size_t sizes[kNG] = {(size_t)D, (size_t)D, L, L, H * L, H * L * kC,
                             (size_t)H * H, (size_t)H * H * kC,
                             (size_t)D * H, (size_t)D, 1};
  for (int i = 0; i < kNG; ++i) n[i] = sizes[i];
}

__global__ void __launch_bounds__(kThreads) mlp_node_bwd_kernel(BwdArgs a) {
  const int tid = grid_tid(), nth = grid_threads();
  const MlpField& f = a.f;
  size_t n[kNG];
  grad_sizes(f.D, f.K, f.H, n);
  for (int k = 0; k < kNG; ++k)
    for (size_t i = tid; i < n[k]; i += nth) f.g[k][i] = 0.0f;
  cg::this_grid().sync();
  adjoint_replay(f, a.r);
}

// Scratch layout in `work` (floats): the scaffold's 10 N (fwd y, ks, u;
// bwd lam, kbar, u, ub), the field's scratch, then part.
size_t field_floats(int B, int D, int K, int H) {
  const size_t BD = (size_t)B * D, BL = BD * K, BH = (size_t)B * H;
  return 2 * BD + B + 4 * BL + BL * kC + 7 * BH + BH * kC;
}

size_t work_floats(int B, int D, int K, int H) {
  return 10 * (size_t)B * D + field_floats(B, D, K, H) + kPartFloats;
}

MlpField make_field(const float* const* w, float* work, int B, int D, int K,
                    int H, float hbound) {
  MlpField f{};
  f.lns = w[0];
  f.lnb = w[1];
  f.av = w[2];
  f.bv = w[3];
  f.g1 = w[4];
  f.bw1 = w[5];
  f.sw1 = w[6];
  f.g2 = w[7];
  f.bw2 = w[8];
  f.sw2 = w[9];
  f.ow = w[10];
  f.ob = w[11];
  f.eff = w[12];
  f.B = B;
  f.D = D;
  f.K = K;
  f.L = D * K;
  f.H = H;
  f.hbound = hbound;
  const size_t BD = (size_t)B * D, BL = BD * K, BH = (size_t)B * H;
  float* p = work + 10 * BD;
  f.xn = p;
  f.th = f.xn + BD;
  f.rstd = f.th + BD;
  f.s1 = f.rstd + B;
  f.phi = f.s1 + BL;
  f.sphi = f.phi + BL;
  f.zb = f.sphi + BL;
  f.bas1 = f.zb + BL;
  f.y1 = f.bas1 + BL * kC;
  f.sy1 = f.y1 + BH;
  f.y2 = f.sy1 + BH;
  f.z = f.y2 + BH;
  f.t2 = f.z + BH;
  f.y2bar = f.t2 + BH;
  f.y1bar = f.y2bar + BH;
  f.bas2 = f.y1bar + BH;
  return f;
}

float* part_of(float* work, int B, int D, int K, int H) {
  return work + 10 * (size_t)B * D + field_floats(B, D, K, H);
}

}  // namespace

extern "C" long long mlp_node_work_floats(int B, int D, int K, int H) {
  return (long long)work_floats(B, D, K, H);
}

// h0 (B, D) and the 13 operands w (lns, lnb, a, b, g1, bw1, sw1, g2, bw2,
// sw2, W, bo, eff; shapes in MlpField) -> out (B, D) and, when record is
// nonzero, tda (M, 4), yrec (M, B, D), krec (M, 7, B, D), misc (4).
extern "C" int mlp_node_fwd(const float* h0, const float* const* w,
                            float* out, float* tda, float* yrec, float* krec,
                            float* misc, float* work, int B, int D, int K,
                            int H, int max_steps, float rtol, float atol,
                            float h_bound, int record, void* stream) {
  if (B <= 0) return 0;
  FwdArgs a{};
  a.f = make_field(w, work, B, D, K, H, h_bound);
  const size_t N = (size_t)B * D;
  a.s.h0 = h0;
  a.s.out = out;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.y = work;
  a.s.ks = work + N;
  a.s.u = work + 8 * N;
  a.s.part = part_of(work, B, D, K, H);
  a.s.N = (int)N;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cooperative(mlp_node_fwd_kernel<true>, a, s)
                : launch_cooperative(mlp_node_fwd_kernel<false>, a, s);
}

// hbar (B, D), the forward's records and the 13 operands -> the 11
// gradients g (of all operands but the two grids, shaped as they are) and
// h0bar (B, D).
extern "C" int mlp_node_bwd(const float* hbar, const float* tda,
                            const float* yrec, const float* krec,
                            const float* misc, const float* const* w,
                            float* const* g, float* h0bar, float* work,
                            int B, int D, int K, int H, float h_bound,
                            void* stream) {
  if (B <= 0) return 0;
  BwdArgs a{};
  a.f = make_field(w, work, B, D, K, H, h_bound);
  for (int i = 0; i < kNG; ++i) a.f.g[i] = g[i];
  const size_t N = (size_t)B * D;
  a.r.hbar = hbar;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = h0bar;
  a.r.lam = work;
  a.r.kbar = work + N;
  a.r.u = work + 8 * N;
  a.r.ub = work + 9 * N;
  a.r.N = (int)N;
  return launch_cooperative(mlp_node_bwd_kernel, a,
                            static_cast<cudaStream_t>(stream));
}
