// Whole-solve kernels of the conditional-diffusion node encoder for Hopper
// (sm_90a): the forward dopri5 solve of the non-autonomous latent field
// over t in [0, 1] (with or without per-attempt records) and the reverse
// replay, the discrete adjoint on the recorded step mesh, which also
// scatters the cotangent of the interpolated past signal into its rows.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_node_enc.py:160
// (make_node_enc_solver; forward _make_fwd_kernel :75, pallas_call :196;
// backward _make_bwd_kernel :95, pallas_call :217).  The field, with the
// first layer's weight (H, C+P) split into its LN(z) block w1z (H, C) and
// its x(t) block w1x (H, P) (:146-156):
//
//   x(t) = X[i0] + w (X[i0 + 1] - X[i0])    X: (L*B, P) table, rows l*B+b
//   zn   = LN(z) = (z - mean) rsqrt(var + 1e-5) scale + bias   (B, C)
//   h1   = silu(zn w1z^T + x(t) w1x^T + b1)                    (B, H)
//   h2   = silu(h1 W2^T + b2)                                  (B, H)
//   f    = h2 W3^T + b3                                        (B, C)
//
// with tf = clip(t, 0, 1) (L - 1), i0 = clip(floor(tf), 0, L - 2), w =
// tf - i0 (:56-64).  The solve and the replay are node_common.cuh's
// trajectory pair at the output times [0, 1] (only z(1) is used; CONTD5
// at theta = 1 is y1); this file holds the field and its hand-written VJP.
// Every product runs in the kernel's own body in FP32 FMAs (no cuBLAS, no
// torch.matmul, no TF32).  Field evaluation, four grid phases:
//   (A) one warp per row b: the row's mean and variance over C (two
//       passes, a fixed shuffle tree), zn and yhat = (z - mean) rstd, and
//       the row's x(t) from the two table rows;
//   (B) h1, (C) h2, (D) f: one warp per output element, lanes striding
//       over the contraction, a fixed shuffle tree.
// VJP with cotangent w (B, C): (A)-(C) again, keeping the pre-activations,
// then four phases of owned items, each element of a product or of a
// gradient owned by one thread that sums in a fixed order:
//   (3) g2 = (w W3) silu'(h2p);  gW3 += w^T h2;  gb3 += sum_b w
//   (4) g1 = (g2 W2) silu'(h1p); gW2 += g2^T h1; gb2 += sum_b g2
//   (5) gzn = g1 w1z;  gxt = g1 w1x, added as (1 - w) gxt to table row
//       i0*B+b and w gxt to row (i0+1)*B+b (the thread that owns (b, p)
//       owns both, and adds in replay order);  gw1z += g1^T zn;
//       gw1x += g1^T x(t);  gb1 += sum_b g1
//   (6) g_scale += sum_b gzn yhat;  g_bias += sum_b gzn (a thread per
//       column); then a warp per row b: gh = gzn scale, m1 = mean_c gh,
//       m2 = mean_c gh yhat, ubar = rstd (gh - m1 - yhat m2).
// No atomics: the gradients are the same bits on every run.
//
// What bounds it on this card: at the encoder's widths (C = P = H = 128,
// B = 64 in training, up to 256 in serving) a field evaluation is about
// 2 B (C H + P H + H H + H C) = 8.4 M FLOP at B = 64, about 0.13 us of the
// card's FP32 rate, and the solve takes 6 evaluations for each of its 5-10
// attempts.  It is bound by its serial chain of grid barriers (six per
// evaluation with the scaffold's, more in the VJP, plus the reductions),
// not by arithmetic or bytes; the design keeps to the barriers the data
// flow needs and spreads every phase over every SM.

#include "node_common.cuh"

namespace {

using namespace node_common;

constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

struct NodeEncField {
  const float* xtab;  // (L*B, P) projected past signal, row l*B+b
  const float* lns;   // (C) LN scale
  const float* lnb;   // (C) LN bias
  const float* w1z;   // (H, C)
  const float* w1x;   // (H, P)
  const float* b1;    // (H)
  const float* w2;    // (H, H)
  const float* b2;    // (H)
  const float* w3;    // (C, H)
  const float* b3;    // (C)
  // scratch
  float* zn;    // (B, C) LN(z)
  float* yhat;  // (B, C) normalised z before scale and bias
  float* rstd;  // (B)
  float* xt;    // (B, P) x(t)
  float* h1p;   // (B, H) pre-activations and activations
  float* a1;
  float* h2p;
  float* a2;
  float* g2;   // (B, H) VJP
  float* g1;   // (B, H) VJP
  float* gzn;  // (B, C) VJP
  // gradients, VJP only, shaped as their tensors
  float* glns;
  float* glnb;
  float* gw1z;
  float* gw1x;
  float* gb1;
  float* gw2;
  float* gb2;
  float* gw3;
  float* gb3;
  float* gxtab;  // (L*B, P)
  int B, C, P, H, L;

  // The first bracketing table row and the lerp weight of time t.
  __device__ void rows(float t, int& i0, float& w) const {
    const float tf = fminf(fmaxf(t, 0.0f), 1.0f) * (float)(L - 1);
    int i = (int)floorf(tf);
    i = i < 0 ? 0 : (i > L - 2 ? L - 2 : i);
    i0 = i;
    w = tf - (float)i;
  }

  // zn, yhat, rstd, x(t), then h1 and h2 of the state u at time t.
  __device__ void hidden(const float* u, float t) const {
    const int lane = lane_id();
    int i0;
    float w;
    rows(t, i0, w);
    const float inv_c = 1.0f / (float)C;
    // (A) layer norm and x(t): one warp per row.
    for (int b = grid_warp(); b < B; b += grid_warps()) {
      const float* urow = u + b * C;
      float s = 0.0f;
      for (int c = lane; c < C; c += 32) s += ld(urow + c);
      const float mu = warp_sum(s) * inv_c;
      float v = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float d = ld(urow + c) - mu;
        v += d * d;
      }
      const float r = 1.0f / sqrtf(warp_sum(v) * inv_c + kLnEps);
      for (int c = lane; c < C; c += 32) {
        const float yh = (ld(urow + c) - mu) * r;
        yhat[b * C + c] = yh;
        zn[b * C + c] = yh * lns[c] + lnb[c];
      }
      if (lane == 0) rstd[b] = r;
      const float* x0 = xtab + ((size_t)i0 * B + b) * P;
      const float* x1 = x0 + (size_t)B * P;
      for (int p = lane; p < P; p += 32)
        xt[b * P + p] = x0[p] + w * (x1[p] - x0[p]);
    }
    cg::this_grid().sync();
    // (B) h1: one warp per (b, j) over the C + P inputs.
    for (int q = grid_warp(); q < B * H; q += grid_warps()) {
      const int b = q / H, j = q - b * H;
      const float* zrow = zn + b * C;
      const float* xrow = xt + b * P;
      const float* wz = w1z + j * C;
      const float* wx = w1x + j * P;
      float acc = 0.0f;
      for (int c = lane; c < C; c += 32) acc += ld(zrow + c) * wz[c];
      for (int p = lane; p < P; p += 32) acc += ld(xrow + p) * wx[p];
      acc = warp_sum(acc);
      if (lane == 0) {
        const float h = acc + b1[j];
        h1p[q] = h;
        a1[q] = silu(h);
      }
    }
    cg::this_grid().sync();
    // (C) h2.
    for (int q = grid_warp(); q < B * H; q += grid_warps()) {
      const int b = q / H, j = q - b * H;
      const float* hrow = a1 + b * H;
      const float* wrow = w2 + j * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += ld(hrow + k) * wrow[k];
      acc = warp_sum(acc);
      if (lane == 0) {
        const float h = acc + b2[j];
        h2p[q] = h;
        a2[q] = silu(h);
      }
    }
    cg::this_grid().sync();
  }

  __device__ void eval(const float* u, float t, float* out) const {
    hidden(u, t);
    // (D) f.
    const int lane = lane_id();
    for (int q = grid_warp(); q < B * C; q += grid_warps()) {
      const int b = q / C, o = q - b * C;
      const float* hrow = a2 + b * H;
      const float* wrow = w3 + o * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += ld(hrow + k) * wrow[k];
      acc = warp_sum(acc);
      if (lane == 0) out[q] = acc + b3[o];
    }
  }

  __device__ void vjp(const float* u, float t, const float* w,
                      float* ubar) const {
    hidden(u, t);
    const int tid = grid_tid(), nth = grid_threads();
    const int nBH = B * H;
    // (3) g2, gW3, gb3.
    for (int i = tid; i < nBH + C * H + C; i += nth) {
      if (i < nBH) {
        const int b = i / H, j = i - b * H;
        float s = 0.0f;
        for (int o = 0; o < C; ++o) s += ld(w + b * C + o) * w3[o * H + j];
        g2[i] = s * dsilu(ld(h2p + i));
      } else if (i < nBH + C * H) {
        const int q = i - nBH, o = q / H, j = q - o * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * C + o) * ld(a2 + b * H + j);
        gw3[q] += s;
      } else {
        const int o = i - nBH - C * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * C + o);
        gb3[o] += s;
      }
    }
    cg::this_grid().sync();
    // (4) g1, gW2, gb2.
    for (int i = tid; i < nBH + H * H + H; i += nth) {
      if (i < nBH) {
        const int b = i / H, k = i - b * H;
        float s = 0.0f;
        for (int j = 0; j < H; ++j) s += ld(g2 + b * H + j) * w2[j * H + k];
        g1[i] = s * dsilu(ld(h1p + i));
      } else if (i < nBH + H * H) {
        const int q = i - nBH, j = q / H, k = q - j * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b)
          s += ld(g2 + b * H + j) * ld(a1 + b * H + k);
        gw2[q] += s;
      } else {
        const int j = i - nBH - H * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(g2 + b * H + j);
        gb2[j] += s;
      }
    }
    cg::this_grid().sync();
    // (5) gzn, the x(t) cotangent into the table, gw1z, gw1x, gb1.
    int i0;
    float wl;
    rows(t, i0, wl);
    const int nBC = B * C, nBP = B * P;
    const int n5 = nBC + nBP + H * C + H * P + H;
    for (int i = tid; i < n5; i += nth) {
      if (i < nBC) {
        const int b = i / C, c = i - b * C;
        float s = 0.0f;
        for (int j = 0; j < H; ++j) s += ld(g1 + b * H + j) * w1z[j * C + c];
        gzn[i] = s;
      } else if (i < nBC + nBP) {
        const int q = i - nBC, b = q / P, p = q - b * P;
        float s = 0.0f;
        for (int j = 0; j < H; ++j) s += ld(g1 + b * H + j) * w1x[j * P + p];
        float* r0 = gxtab + ((size_t)i0 * B + b) * P + p;
        r0[0] += (1.0f - wl) * s;
        r0[(size_t)B * P] += wl * s;
      } else if (i < nBC + nBP + H * C) {
        const int q = i - nBC - nBP, j = q / C, c = q - j * C;
        float s = 0.0f;
        for (int b = 0; b < B; ++b)
          s += ld(g1 + b * H + j) * ld(zn + b * C + c);
        gw1z[q] += s;
      } else if (i < nBC + nBP + H * C + H * P) {
        const int q = i - nBC - nBP - H * C, j = q / P, p = q - j * P;
        float s = 0.0f;
        for (int b = 0; b < B; ++b)
          s += ld(g1 + b * H + j) * ld(xt + b * P + p);
        gw1x[q] += s;
      } else {
        const int j = i - nBC - nBP - H * C - H * P;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(g1 + b * H + j);
        gb1[j] += s;
      }
    }
    cg::this_grid().sync();
    // (6) the layer norm: its scale and bias gradients, a thread per
    // column; then ubar, a warp per row.
    for (int c = tid; c < C; c += nth) {
      float ss = 0.0f, sb = 0.0f;
      for (int b = 0; b < B; ++b) {
        const float g = ld(gzn + b * C + c);
        ss += g * ld(yhat + b * C + c);
        sb += g;
      }
      glns[c] += ss;
      glnb[c] += sb;
    }
    const int lane = lane_id();
    const float inv_c = 1.0f / (float)C;
    for (int b = grid_warp(); b < B; b += grid_warps()) {
      float m1 = 0.0f, m2 = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float gh = ld(gzn + b * C + c) * lns[c];
        m1 += gh;
        m2 += gh * ld(yhat + b * C + c);
      }
      m1 = warp_sum(m1) * inv_c;
      m2 = warp_sum(m2) * inv_c;
      const float r = ld(rstd + b);
      for (int c = lane; c < C; c += 32) {
        const float gh = ld(gzn + b * C + c) * lns[c];
        ubar[b * C + c] = r * (gh - m1 - ld(yhat + b * C + c) * m2);
      }
    }
  }
};

struct FwdArgs {
  NodeEncField f;
  SolveBufs s;
};

struct BwdArgs {
  NodeEncField f;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kThreads) node_enc_fwd_kernel(FwdArgs a) {
  adaptive_solve_traj<kRecord>(a.f, a.s);
}

__global__ void __launch_bounds__(kThreads) node_enc_bwd_kernel(BwdArgs a) {
  const int tid = grid_tid(), nth = grid_threads();
  const NodeEncField& f = a.f;
  const int C = f.C, P = f.P, H = f.H;
  for (int i = tid; i < H * C; i += nth) f.gw1z[i] = 0.0f;
  for (int i = tid; i < H * P; i += nth) f.gw1x[i] = 0.0f;
  for (int i = tid; i < H * H; i += nth) f.gw2[i] = 0.0f;
  for (int i = tid; i < C * H; i += nth) f.gw3[i] = 0.0f;
  for (int i = tid; i < H; i += nth) f.gb1[i] = f.gb2[i] = 0.0f;
  for (int i = tid; i < C; i += nth) f.glns[i] = f.glnb[i] = f.gb3[i] = 0.0f;
  for (size_t i = tid; i < (size_t)f.L * f.B * P; i += nth) f.gxtab[i] = 0.0f;
  cg::this_grid().sync();
  adjoint_replay_traj(f, a.r);
}

// Scratch layout in `work` (floats): the scaffold's 10 N (fwd y, ks, u;
// bwd lam, kbar, u, ub), then zn, yhat, gzn (3 B*C), rstd (B), xt (B*P),
// h1p, a1, h2p, a2, g2, g1 (6 B*H) and part.
size_t field_floats(int B, int C, int P, int H) {
  return 3 * (size_t)B * C + B + (size_t)B * P + 6 * (size_t)B * H;
}

size_t work_floats(int B, int C, int P, int H) {
  return 10 * (size_t)B * C + field_floats(B, C, P, H) + kPartFloats;
}

NodeEncField make_field(const float* xtab, const float* const* w,
                        float* work, int B, int C, int P, int H, int L) {
  NodeEncField f{};
  f.xtab = xtab;
  f.lns = w[0];
  f.lnb = w[1];
  f.w1z = w[2];
  f.w1x = w[3];
  f.b1 = w[4];
  f.w2 = w[5];
  f.b2 = w[6];
  f.w3 = w[7];
  f.b3 = w[8];
  f.B = B;
  f.C = C;
  f.P = P;
  f.H = H;
  f.L = L;
  const size_t BC = (size_t)B * C, BH = (size_t)B * H;
  float* p = work + 10 * BC;
  f.zn = p;
  f.yhat = f.zn + BC;
  f.gzn = f.yhat + BC;
  f.rstd = f.gzn + BC;
  f.xt = f.rstd + B;
  f.h1p = f.xt + (size_t)B * P;
  f.a1 = f.h1p + BH;
  f.h2p = f.a1 + BH;
  f.a2 = f.h2p + BH;
  f.g2 = f.a2 + BH;
  f.g1 = f.g2 + BH;
  return f;
}

float* part_of(float* work, int B, int C, int P, int H) {
  return work + 10 * (size_t)B * C + field_floats(B, C, P, H);
}

}  // namespace

extern "C" long long node_enc_work_floats(int B, int C, int P, int H) {
  return (long long)work_floats(B, C, P, H);
}

// z0 (B, C), xtab (L*B, P), ts (2) = [0, 1]; ln_scale, ln_bias (C), w1z
// (H, C), w1x (H, P), b1 (H), W2 (H, H), b2 (H), W3 (C, H), b3 (C) -> out
// (2, B, C) and, when record is nonzero, tda (M, 4), yrec (M, B, C), krec
// (M, 7, B, C), misc (4).
extern "C" int node_enc_fwd(const float* z0, const float* xtab,
                            const float* ts, const float* lns,
                            const float* lnb, const float* w1z,
                            const float* w1x, const float* b1,
                            const float* w2, const float* b2,
                            const float* w3, const float* b3, float* out,
                            float* tda, float* yrec, float* krec,
                            float* misc, float* work, int B, int C, int P,
                            int H, int L, int max_steps, float rtol,
                            float atol, int record, void* stream) {
  if (B <= 0) return 0;
  const float* w[9] = {lns, lnb, w1z, w1x, b1, w2, b2, w3, b3};
  FwdArgs a{};
  a.f = make_field(xtab, w, work, B, C, P, H, L);
  const size_t N = (size_t)B * C;
  a.s.h0 = z0;
  a.s.out = out;
  a.s.ts = ts;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.y = work;
  a.s.ks = work + N;
  a.s.u = work + 8 * N;
  a.s.part = part_of(work, B, C, P, H);
  a.s.N = (int)N;
  a.s.T = 2;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cooperative(node_enc_fwd_kernel<true>, a, s)
                : launch_cooperative(node_enc_fwd_kernel<false>, a, s);
}

// ybar (2, B, C), the cotangent of the trajectory at [0, 1], and the
// forward's records -> the gradients of ln_scale, ln_bias, w1z, w1x, b1,
// W2, b2, W3, b3 (shaped as they are), of the table, gxtab (L*B, P), and
// z0bar (B, C).
extern "C" int node_enc_bwd(const float* ybar, const float* ts,
                            const float* tda, const float* yrec,
                            const float* krec, const float* misc,
                            const float* xtab, const float* lns,
                            const float* lnb, const float* w1z,
                            const float* w1x, const float* b1,
                            const float* w2, const float* b2,
                            const float* w3, const float* b3, float* glns,
                            float* glnb, float* gw1z, float* gw1x,
                            float* gb1, float* gw2, float* gb2, float* gw3,
                            float* gb3, float* gxtab, float* z0bar,
                            float* work, int B, int C, int P, int H, int L,
                            void* stream) {
  if (B <= 0) return 0;
  const float* w[9] = {lns, lnb, w1z, w1x, b1, w2, b2, w3, b3};
  BwdArgs a{};
  a.f = make_field(xtab, w, work, B, C, P, H, L);
  a.f.glns = glns;
  a.f.glnb = glnb;
  a.f.gw1z = gw1z;
  a.f.gw1x = gw1x;
  a.f.gb1 = gb1;
  a.f.gw2 = gw2;
  a.f.gb2 = gb2;
  a.f.gw3 = gw3;
  a.f.gb3 = gb3;
  a.f.gxtab = gxtab;
  const size_t N = (size_t)B * C;
  a.r.hbar = ybar;
  a.r.ts = ts;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = z0bar;
  a.r.lam = work;
  a.r.kbar = work + N;
  a.r.u = work + 8 * N;
  a.r.ub = work + 9 * N;
  a.r.N = (int)N;
  a.r.T = 2;
  return launch_cooperative(node_enc_bwd_kernel, a,
                            static_cast<cudaStream_t>(stream));
}
