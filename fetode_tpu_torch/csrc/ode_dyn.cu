// Whole-solve kernels of the forecasters' latent ODE field for Hopper
// (sm_90a): the forward dopri5 trajectory solve over [ts[0], ts[T-1]]
// with CONTD5 dense output at the T requested times (with or without
// per-attempt records) and the reverse replay, the discrete adjoint on
// the recorded step mesh with the dense-output cotangents injected.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_ode_dyn.py:143
// (make_ode_dyn_solver; forward _make_fwd_kernel :50, backward
// _make_bwd_kernel :78).  The field, with the first layer's weight W0
// (H, D+1) split into its state block and its time column (:130-139):
//
//   h1  = tanh(z W0[:, :D]^T + t W0[:, D] + b0)     (B, H)
//   h2  = tanh(h1 W1^T + b1)                        (B, H)
//   f   = h2 W2^T + b2                              (B, D)
//
// The solve and the replay are node_common.cuh's trajectory pair; this
// file holds the field and its hand-written VJP.  Every product runs in
// the kernel's own body in FP32 FMAs (no cuBLAS, no torch.matmul inside
// the solve).  Field evaluation, three grid phases (each layer needs the
// previous one complete): one warp per output element, lanes striding
// over the contraction with both operand rows read contiguously, a fixed
// shuffle tree.  VJP with cotangent w (B, D): the two hidden layers again,
// then three phases of owned items, each element of a product or a
// gradient owned by one thread that sums in a fixed order:
//   (3) g2 = (w W2) (1 - h2^2);  gW2 += w^T h2;  gb2 += sum_b w
//   (4) g1 = (g2 W1) (1 - h1^2); gW1 += g2^T h1; gb1 += sum_b g2
//   (5) ubar = g1 W0[:, :D];  gW0[:, :D] += g1^T u;
//       gW0[:, D] += t sum_b g1;  gb0 += sum_b g1
// In the products with a transposed weight the output index runs fastest
// over the threads, so the weight reads are contiguous and the other
// operand is broadcast.  No atomics: the gradients are the same bits on
// every run.
//
// What bounds it on this card: at the forecaster's widths (D = 64, H =
// 128, B = 64 in training, up to 297 in evaluation) a field evaluation is
// 2 B (D H + H H + H D) = 4.2 M FLOP at B = 64, under 0.1 us of the card's
// FP32 rate, and about 10 attempts of 6 evaluations cover the 8-step
// horizon.  The solve is bound by its serial chain of grid barriers (four
// per evaluation, plus the reductions), not by arithmetic or bytes; the
// design keeps to the barriers the data flow needs and spreads every
// phase over every SM.

#include "node_common.cuh"

namespace {

using namespace node_common;

struct OdeDynField {
  const float* w0;  // (H, D + 1): state block, then the time column
  const float* b0;  // (H)
  const float* w1;  // (H, H)
  const float* b1;  // (H)
  const float* w2;  // (D, H)
  const float* b2;  // (D)
  float* h1;        // (B, H) scratch
  float* h2;        // (B, H) scratch
  float* g2;        // (B, H) scratch (VJP)
  float* g1;        // (B, H) scratch (VJP)
  float* gw0;       // gradients, VJP only, shaped as their parameters
  float* gb0;
  float* gw1;
  float* gb1;
  float* gw2;
  float* gb2;
  int B, D, H;

  // h1 and h2 of the state u at time t: one warp per (b, j).
  __device__ void hidden(const float* u, float t) const {
    const int lane = lane_id(), K = D + 1;
    for (int w = grid_warp(); w < B * H; w += grid_warps()) {
      const int b = w / H, j = w - b * H;
      const float* urow = u + b * D;
      const float* wrow = w0 + j * K;
      float acc = 0.0f;
      for (int d = lane; d < D; d += 32) acc += ld(urow + d) * wrow[d];
      acc = warp_sum(acc);
      if (lane == 0) h1[w] = tanhf(acc + t * wrow[D] + b0[j]);
    }
    cg::this_grid().sync();
    for (int w = grid_warp(); w < B * H; w += grid_warps()) {
      const int b = w / H, j = w - b * H;
      const float* hrow = h1 + b * H;
      const float* wrow = w1 + j * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += ld(hrow + k) * wrow[k];
      acc = warp_sum(acc);
      if (lane == 0) h2[w] = tanhf(acc + b1[j]);
    }
    cg::this_grid().sync();
  }

  __device__ void eval(const float* u, float t, float* out) const {
    hidden(u, t);
    const int lane = lane_id();
    for (int w = grid_warp(); w < B * D; w += grid_warps()) {
      const int b = w / D, o = w - b * D;
      const float* hrow = h2 + b * H;
      const float* wrow = w2 + o * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += ld(hrow + k) * wrow[k];
      acc = warp_sum(acc);
      if (lane == 0) out[w] = acc + b2[o];
    }
  }

  __device__ void vjp(const float* u, float t, const float* w,
                      float* ubar) const {
    hidden(u, t);
    const int tid = grid_tid(), nth = grid_threads(), K = D + 1;
    const int nBH = B * H;
    // (3) g2, gW2, gb2.
    for (int i = tid; i < nBH + D * H + D; i += nth) {
      if (i < nBH) {
        const int b = i / H, j = i - b * H;
        float s = 0.0f;
        for (int o = 0; o < D; ++o) s += ld(w + b * D + o) * w2[o * H + j];
        const float z = ld(h2 + i);
        g2[i] = s * (1.0f - z * z);
      } else if (i < nBH + D * H) {
        const int q = i - nBH, o = q / H, j = q - o * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * D + o) * ld(h2 + b * H + j);
        gw2[q] += s;
      } else {
        const int o = i - nBH - D * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * D + o);
        gb2[o] += s;
      }
    }
    cg::this_grid().sync();
    // (4) g1, gW1, gb1.
    for (int i = tid; i < nBH + H * H + H; i += nth) {
      if (i < nBH) {
        const int b = i / H, k = i - b * H;
        float s = 0.0f;
        for (int j = 0; j < H; ++j) s += ld(g2 + b * H + j) * w1[j * H + k];
        const float z = ld(h1 + i);
        g1[i] = s * (1.0f - z * z);
      } else if (i < nBH + H * H) {
        const int q = i - nBH, j = q / H, k = q - j * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b)
          s += ld(g2 + b * H + j) * ld(h1 + b * H + k);
        gw1[q] += s;
      } else {
        const int j = i - nBH - H * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(g2 + b * H + j);
        gb1[j] += s;
      }
    }
    cg::this_grid().sync();
    // (5) ubar, gW0 (state block and time column), gb0.
    const int nBD = B * D;
    for (int i = tid; i < nBD + H * D + H; i += nth) {
      if (i < nBD) {
        const int b = i / D, d = i - b * D;
        float s = 0.0f;
        for (int j = 0; j < H; ++j) s += ld(g1 + b * H + j) * w0[j * K + d];
        ubar[i] = s;
      } else if (i < nBD + H * D) {
        const int q = i - nBD, j = q / D, d = q - j * D;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(g1 + b * H + j) * ld(u + b * D + d);
        gw0[j * K + d] += s;
      } else {
        const int j = i - nBD - H * D;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(g1 + b * H + j);
        gw0[j * K + D] += t * s;
        gb0[j] += s;
      }
    }
  }
};

struct FwdArgs {
  OdeDynField f;
  SolveBufs s;
};

struct BwdArgs {
  OdeDynField f;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kThreads) ode_dyn_fwd_kernel(FwdArgs a) {
  adaptive_solve_traj<kRecord>(a.f, a.s);
}

__global__ void __launch_bounds__(kThreads) ode_dyn_bwd_kernel(BwdArgs a) {
  const int tid = grid_tid(), nth = grid_threads();
  const OdeDynField& f = a.f;
  const int K = f.D + 1;
  for (int i = tid; i < f.H * K; i += nth) f.gw0[i] = 0.0f;
  for (int i = tid; i < f.H * f.H; i += nth) f.gw1[i] = 0.0f;
  for (int i = tid; i < f.D * f.H; i += nth) f.gw2[i] = 0.0f;
  for (int i = tid; i < f.H; i += nth) f.gb0[i] = f.gb1[i] = 0.0f;
  for (int i = tid; i < f.D; i += nth) f.gb2[i] = 0.0f;
  cg::this_grid().sync();
  adjoint_replay_traj(f, a.r);
}

// Scratch layout in `work` (floats): fwd y, ks, u (9N); bwd lam, kbar,
// u, ub (10N); then h1, h2, g2, g1 (4 B*H) and part.
size_t work_floats(int B, int D, int H) {
  const size_t N = (size_t)B * D, BH = (size_t)B * H;
  return 10 * N + 4 * BH + kPartFloats;
}

OdeDynField make_field(const float* w0, const float* b0, const float* w1,
                       const float* b1, const float* w2, const float* b2,
                       float* work, int B, int D, int H) {
  OdeDynField f{};
  f.w0 = w0;
  f.b0 = b0;
  f.w1 = w1;
  f.b1 = b1;
  f.w2 = w2;
  f.b2 = b2;
  f.B = B;
  f.D = D;
  f.H = H;
  const size_t BH = (size_t)B * H;
  f.h1 = work + 10 * (size_t)B * D;
  f.h2 = f.h1 + BH;
  f.g2 = f.h2 + BH;
  f.g1 = f.g2 + BH;
  return f;
}

float* part_of(float* work, int B, int D, int H) {
  return work + 10 * (size_t)B * D + 4 * (size_t)B * H;
}

}  // namespace

extern "C" long long ode_dyn_work_floats(int B, int D, int H) {
  return (long long)work_floats(B, D, H);
}

// z0 (B, D), ts (T); W0 (H, D+1), b0 (H), W1 (H, H), b1 (H), W2 (D, H),
// b2 (D) -> out (T, B, D) and, when record is nonzero, tda (M, 4), yrec
// (M, B, D), krec (M, 7, B, D), misc (4).
extern "C" int ode_dyn_fwd(const float* z0, const float* ts, const float* w0,
                           const float* b0, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* out,
                           float* tda, float* yrec, float* krec, float* misc,
                           float* work, int B, int D, int H, int T,
                           int max_steps, float rtol, float atol, int record,
                           void* stream) {
  if (B <= 0 || T <= 0) return 0;
  FwdArgs a{};
  a.f = make_field(w0, b0, w1, b1, w2, b2, work, B, D, H);
  const size_t N = (size_t)B * D;
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
  a.s.part = part_of(work, B, D, H);
  a.s.N = (int)N;
  a.s.T = T;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cooperative(ode_dyn_fwd_kernel<true>, a, s)
                : launch_cooperative(ode_dyn_fwd_kernel<false>, a, s);
}

// ct (T, B, D), the trajectory's cotangent, and the forward's records ->
// gW0 (H, D+1), gb0 (H), gW1 (H, H), gb1 (H), gW2 (D, H), gb2 (D), z0bar
// (B, D).
extern "C" int ode_dyn_bwd(const float* ct, const float* ts, const float* tda,
                           const float* yrec, const float* krec,
                           const float* misc, const float* w0,
                           const float* b0, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* gw0,
                           float* gb0, float* gw1, float* gb1, float* gw2,
                           float* gb2, float* z0bar, float* work, int B,
                           int D, int H, int T, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  BwdArgs a{};
  a.f = make_field(w0, b0, w1, b1, w2, b2, work, B, D, H);
  a.f.gw0 = gw0;
  a.f.gb0 = gb0;
  a.f.gw1 = gw1;
  a.f.gb1 = gb1;
  a.f.gw2 = gw2;
  a.f.gb2 = gb2;
  const size_t N = (size_t)B * D;
  a.r.hbar = ct;
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
  a.r.T = T;
  return launch_cooperative(ode_dyn_bwd_kernel, a,
                            static_cast<cudaStream_t>(stream));
}
