// Whole-solve kernels of the ECG KanFetNODE 'plain' latent field for
// Hopper (sm_90a): the forward dopri5 solve over [0, 1] (with or without
// per-attempt records) and the reverse replay, the discrete adjoint on
// the recorded step mesh.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_logistic_node.py:90
// (make_logistic_node_solver; forward _make_fwd_kernel :39, backward
// _make_bwd_kernel :58).  With L = D*K and l = d*K + k:
//
//   phi[b, l] = sigmoid(2 * sigmoid(a[l] * (y[b, l/K] - b[l])))
//   dh[b, o]  = sum_l phi[b, l] * W[o, l] + bp[o]        W: (D, L)
//
// The solve and the replay are node_common.cuh's; this file holds the
// field and its hand-written VJP.  As in the TPU kernel, the product
// phi W^T and its transposes run inside the kernel's own body (no cuBLAS,
// no torch.matmul inside the solve).
//
// Field evaluation, two grid phases: (1) phi over all B*L elements, one
// thread each; (2) one warp per output (b, o), lanes striding over l,
// a fixed shuffle tree.  VJP with cotangent w (B, D), two phases:
// (1) one thread per (b, l): phi, s1 and phibar = sum_o w[b,o] W[o,l],
// then zb = phibar * 2 phi (1 - phi) * s1 (1 - s1); (2) every gradient
// element is owned by one thread, which adds its sum over the batch in a
// fixed order to the gradient array: gW[o, l] += sum_b w[b,o] phi[b,l],
// ga[l] += sum_b zb (x - b), gb[l] += sum_b -zb a, gbp[o] += sum_b w[b,o],
// and ubar[b, d] = sum_k zb[b, dK+k] a[dK+k].  No atomics: the gradients
// are the same bits on every run.
//
// What bounds it on this card: at the ECG widths (D = 64, K = 12, B = 8)
// a field evaluation is 0.4 M multiply-adds and 12 k sigmoids, a few
// microseconds of work for the whole card, so the solve is bound by its
// serial chain of grid barriers (three per evaluation, 6 evaluations per
// attempt, up to 16 attempts, plus the reductions).  The design keeps the
// barriers per evaluation at the minimum the data flow allows (phi must be
// complete before any output's dot) and spreads each phase over every SM.

#include "node_common.cuh"

namespace {

using namespace node_common;

struct LogisticField {
  const float* av;  // (L)
  const float* bv;  // (L)
  const float* pw;  // (D, L)
  const float* pb;  // (D)
  float* phi;       // (B, L) scratch
  float* zb;        // (B, L) scratch (VJP)
  float* gav;       // (L) gradients, VJP only
  float* gbv;       // (L)
  float* gpw;       // (D, L)
  float* gpb;       // (D)
  int B, D, K, L;

  __device__ void eval(const float* u, float* out) const {
    const int tid = grid_tid(), nth = grid_threads();
    for (int i = tid; i < B * L; i += nth) {
      const int b = i / L, l = i - b * L;
      const float x = ld(u + b * D + l / K);
      phi[i] = sigmoid(2.0f * sigmoid(av[l] * (x - bv[l])));
    }
    cg::this_grid().sync();
    const int lane = lane_id();
    for (int w = grid_warp(); w < B * D; w += grid_warps()) {
      const int b = w / D, o = w - b * D;
      const float* prow = phi + b * L;
      const float* wrow = pw + o * L;
      float acc = 0.0f;
      for (int l = lane; l < L; l += 32) acc += ld(prow + l) * wrow[l];
      acc = warp_sum(acc);
      if (lane == 0) out[w] = acc + pb[o];
    }
  }

  __device__ void vjp(const float* u, const float* w, float* ubar) const {
    const int tid = grid_tid(), nth = grid_threads();
    for (int i = tid; i < B * L; i += nth) {
      const int b = i / L, l = i - b * L;
      const float x = ld(u + b * D + l / K);
      const float s1 = sigmoid(av[l] * (x - bv[l]));
      const float ph = sigmoid(2.0f * s1);
      float pbar = 0.0f;
      for (int o = 0; o < D; ++o) pbar += ld(w + b * D + o) * pw[o * L + l];
      phi[i] = ph;
      zb[i] = pbar * (2.0f * ph * (1.0f - ph)) * (s1 * (1.0f - s1));
    }
    cg::this_grid().sync();
    // Owned items: gpw (D*L), then ga/gb (L), gpb (D), ubar (B*D).
    const int n_pw = D * L, n_items = n_pw + L + D + B * D;
    for (int i = tid; i < n_items; i += nth) {
      if (i < n_pw) {
        const int o = i / L, l = i - o * L;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * D + o) * ld(phi + b * L + l);
        gpw[i] += s;
      } else if (i < n_pw + L) {
        const int l = i - n_pw;
        float sa = 0.0f, sb = 0.0f;
        for (int b = 0; b < B; ++b) {
          const float z = ld(zb + b * L + l);
          sa += z * (ld(u + b * D + l / K) - bv[l]);
          sb += -z * av[l];
        }
        gav[l] += sa;
        gbv[l] += sb;
      } else if (i < n_pw + L + D) {
        const int o = i - n_pw - L;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * D + o);
        gpb[o] += s;
      } else {
        const int j = i - n_pw - L - D, b = j / D, d = j - b * D;
        const float* zrow = zb + b * L + d * K;
        float s = 0.0f;
        for (int k = 0; k < K; ++k) s += ld(zrow + k) * av[d * K + k];
        ubar[j] = s;
      }
    }
  }
};

struct FwdArgs {
  LogisticField f;
  SolveBufs s;
};

struct BwdArgs {
  LogisticField f;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kThreads) logistic_node_fwd_kernel(
    FwdArgs a) {
  adaptive_solve_final<kRecord>(a.f, a.s);
}

__global__ void __launch_bounds__(kThreads) logistic_node_bwd_kernel(
    BwdArgs a) {
  const int tid = grid_tid(), nth = grid_threads();
  const LogisticField& f = a.f;
  for (int i = tid; i < f.D * f.L; i += nth) f.gpw[i] = 0.0f;
  for (int i = tid; i < f.L; i += nth) f.gav[i] = f.gbv[i] = 0.0f;
  for (int i = tid; i < f.D; i += nth) f.gpb[i] = 0.0f;
  cg::this_grid().sync();
  adjoint_replay(f, a.r);
}

// Scratch layout in `work` (floats): fwd y, ks, u (9N), phi (B*L), part;
// bwd lam, kbar, u, ub (10N), phi, zb (2*B*L), part.
size_t work_floats(int B, int D, int K) {
  const size_t N = (size_t)B * D, BL = (size_t)B * D * K;
  return 10 * N + 2 * BL + kPartFloats;
}

LogisticField make_field(const float* av, const float* bv, const float* pw,
                         const float* pb, float* work, int B, int D, int K) {
  LogisticField f{};
  f.av = av;
  f.bv = bv;
  f.pw = pw;
  f.pb = pb;
  f.B = B;
  f.D = D;
  f.K = K;
  f.L = D * K;
  f.phi = work + 10 * (size_t)B * D;
  f.zb = f.phi + (size_t)B * f.L;
  return f;
}

}  // namespace

extern "C" long long logistic_node_work_floats(int B, int D, int K) {
  return (long long)work_floats(B, D, K);
}

// h0 (B, D); a, b (L); W (D, L); bp (D) -> out (B, D) and, when record is
// nonzero, tda (M, 4), yrec (M, B, D), krec (M, 7, B, D), misc (4).
extern "C" int logistic_node_fwd(const float* h0, const float* av,
                                 const float* bv, const float* pw,
                                 const float* pb, float* out, float* tda,
                                 float* yrec, float* krec, float* misc,
                                 float* work, int B, int D, int K,
                                 int max_steps, float rtol, float atol,
                                 int record, void* stream) {
  if (B <= 0) return 0;
  FwdArgs a{};
  a.f = make_field(av, bv, pw, pb, work, B, D, K);
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
  a.s.part = work + 10 * N + 2 * (size_t)B * D * K;
  a.s.N = (int)N;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cooperative(logistic_node_fwd_kernel<true>, a, s)
                : launch_cooperative(logistic_node_fwd_kernel<false>, a, s);
}

// hbar (B, D) and the forward's records -> ga, gb (L), gW (D, L), gbp (D),
// h0bar (B, D).
extern "C" int logistic_node_bwd(const float* hbar, const float* tda,
                                 const float* yrec, const float* krec,
                                 const float* misc, const float* av,
                                 const float* bv, const float* pw,
                                 const float* pb, float* gav, float* gbv,
                                 float* gpw, float* gpb, float* h0bar,
                                 float* work, int B, int D, int K,
                                 void* stream) {
  if (B <= 0) return 0;
  BwdArgs a{};
  a.f = make_field(av, bv, pw, pb, work, B, D, K);
  a.f.gav = gav;
  a.f.gbv = gbv;
  a.f.gpw = gpw;
  a.f.gpb = gpb;
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
  return launch_cooperative(logistic_node_bwd_kernel, a,
                            static_cast<cudaStream_t>(stream));
}
