// The custom-field whole-solve example for Hopper (sm_90a): a user's own
// vector field plugged into node_common.cuh's final-state pair, the
// forward dopri5 solve over [0, 1] (with or without per-attempt records)
// and the reverse replay, the discrete adjoint on the recorded mesh.
//
// Replaces the TPU kernels of examples/02_custom_field_kernel.py (the
// forward pallas_call :95, kernel _fwd_kernel :41; the backward
// pallas_call :116, kernel _bwd_kernel :54).  The field is a one-hidden-
// layer tanh MLP, with h (B, D), w1 (H, D) and w2 (D, H):
//
//   z  = tanh(h w1^T)        (B, H)
//   dh = z w2^T              (B, D)
//
// and its VJP with cotangent w (B, D) is the example's field_vjp
// (:61-67): gw2 += w^T z; zbar = (w w2) * (1 - z^2); gw1 += zbar^T u;
// ubar = zbar w1.  As in the TPU kernel, the products run inside the
// kernel's own body (no cuBLAS, no torch.matmul inside the solve).
//
// Field evaluation, two grid phases: (1) z over all B*H elements, one
// thread each, its D-long dot in order; (2) dh over all B*D elements, one
// thread each, its H-long dot in order.  VJP, two phases: (1) one thread
// per (b, h): z and zbar; (2) every gradient element is owned by one
// thread, which adds its sum over the batch (b = 0..B-1 in order) to the
// gradient array: gw2[d, h] += sum_b w[b,d] z[b,h], gw1[h, d] += sum_b
// zbar[b,h] u[b,d], and ubar[b, d] = sum_h zbar[b,h] w1[h,d].  No atomics:
// the gradients are the same bits on every run.  FP32 throughout, tanhf
// (no fast math).
//
// What bounds it on this card: at D = 64, H = 128, B = 64 a field
// evaluation is 1 M multiply-adds and 8 k tanhs, well under a
// microsecond of the card's work, so the solve is bound by its serial
// chain of grid barriers (two per evaluation, six evaluations an attempt,
// plus the reductions), as the other final-state fields are.

#include "node_common.cuh"

namespace {

using namespace node_common;

struct TanhMlpField {
  const float* w1;  // (H, D)
  const float* w2;  // (D, H)
  float* z;         // (B, H) scratch
  float* zb;        // (B, H) scratch (VJP)
  float* gw1;       // (H, D) gradients, VJP only
  float* gw2;       // (D, H)
  int B, D, H;

  __device__ void eval(const float* u, float* out) const {
    const int tid = grid_tid(), nth = grid_threads();
    for (int i = tid; i < B * H; i += nth) {
      const int b = i / H, h = i - b * H;
      const float* urow = u + b * D;
      const float* wrow = w1 + h * D;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s += ld(urow + d) * wrow[d];
      z[i] = tanhf(s);
    }
    cg::this_grid().sync();
    for (int i = tid; i < B * D; i += nth) {
      const int b = i / D, d = i - b * D;
      const float* zrow = z + b * H;
      const float* wrow = w2 + d * H;
      float s = 0.0f;
      for (int h = 0; h < H; ++h) s += ld(zrow + h) * wrow[h];
      out[i] = s;
    }
  }

  __device__ void vjp(const float* u, const float* w, float* ubar) const {
    const int tid = grid_tid(), nth = grid_threads();
    for (int i = tid; i < B * H; i += nth) {
      const int b = i / H, h = i - b * H;
      const float* urow = u + b * D;
      const float* wrow = w + b * D;
      float pre = 0.0f, wb = 0.0f;
      for (int d = 0; d < D; ++d) {
        pre += ld(urow + d) * w1[h * D + d];
        wb += ld(wrow + d) * w2[d * H + h];
      }
      const float zz = tanhf(pre);
      z[i] = zz;
      zb[i] = wb * (1.0f - zz * zz);
    }
    cg::this_grid().sync();
    // Owned items: gw2 (D*H), gw1 (H*D), ubar (B*D).
    const int n_w = D * H, n_items = 2 * n_w + B * D;
    for (int i = tid; i < n_items; i += nth) {
      if (i < n_w) {
        const int d = i / H, h = i - d * H;
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += ld(w + b * D + d) * ld(z + b * H + h);
        gw2[i] += s;
      } else if (i < 2 * n_w) {
        const int j = i - n_w, h = j / D, d = j - h * D;
        float s = 0.0f;
        for (int b = 0; b < B; ++b)
          s += ld(zb + b * H + h) * ld(u + b * D + d);
        gw1[j] += s;
      } else {
        const int j = i - 2 * n_w, b = j / D, d = j - b * D;
        const float* zrow = zb + b * H;
        float s = 0.0f;
        for (int h = 0; h < H; ++h) s += ld(zrow + h) * w1[h * D + d];
        ubar[j] = s;
      }
    }
  }
};

struct FwdArgs {
  TanhMlpField f;
  SolveBufs s;
};

struct BwdArgs {
  TanhMlpField f;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kThreads) custom_field_fwd_kernel(
    FwdArgs a) {
  adaptive_solve_final<kRecord>(a.f, a.s);
}

__global__ void __launch_bounds__(kThreads) custom_field_bwd_kernel(
    BwdArgs a) {
  const int tid = grid_tid(), nth = grid_threads();
  const TanhMlpField& f = a.f;
  for (int i = tid; i < f.H * f.D; i += nth) f.gw1[i] = f.gw2[i] = 0.0f;
  cg::this_grid().sync();
  adjoint_replay(f, a.r);
}

// Scratch layout in `work` (floats): fwd y, ks, u (9N); bwd lam, kbar, u,
// ub (10N); then z, zb (2*B*H) and the grid reductions' partial sums.
size_t work_floats(int B, int D, int H) {
  const size_t N = (size_t)B * D, BH = (size_t)B * H;
  return 10 * N + 2 * BH + kPartFloats;
}

TanhMlpField make_field(const float* w1, const float* w2, float* work, int B,
                        int D, int H) {
  TanhMlpField f{};
  f.w1 = w1;
  f.w2 = w2;
  f.B = B;
  f.D = D;
  f.H = H;
  f.z = work + 10 * (size_t)B * D;
  f.zb = f.z + (size_t)B * H;
  return f;
}

}  // namespace

extern "C" long long custom_field_work_floats(int B, int D, int H) {
  return (long long)work_floats(B, D, H);
}

// h0 (B, D); w1 (H, D); w2 (D, H) -> out (B, D) and, when record is
// nonzero, tda (M, 4), yrec (M, B, D), krec (M, 7, B, D), misc (4).
extern "C" int custom_field_fwd(const float* h0, const float* w1,
                                const float* w2, float* out, float* tda,
                                float* yrec, float* krec, float* misc,
                                float* work, int B, int D, int H,
                                int max_steps, float rtol, float atol,
                                int record, void* stream) {
  if (B <= 0) return 0;
  FwdArgs a{};
  a.f = make_field(w1, w2, work, B, D, H);
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
  a.s.part = work + 10 * N + 2 * (size_t)B * H;
  a.s.N = (int)N;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cooperative(custom_field_fwd_kernel<true>, a, s)
                : launch_cooperative(custom_field_fwd_kernel<false>, a, s);
}

// hbar (B, D) and the forward's records -> gw1 (H, D), gw2 (D, H), h0bar
// (B, D).
extern "C" int custom_field_bwd(const float* hbar, const float* tda,
                                const float* yrec, const float* krec,
                                const float* misc, const float* w1,
                                const float* w2, float* gw1, float* gw2,
                                float* h0bar, float* work, int B, int D,
                                int H, void* stream) {
  if (B <= 0) return 0;
  BwdArgs a{};
  a.f = make_field(w1, w2, work, B, D, H);
  a.f.gw1 = gw1;
  a.f.gw2 = gw2;
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
  return launch_cooperative(custom_field_bwd_kernel, a,
                            static_cast<cudaStream_t>(stream));
}
