// Whole-solve kernels of a wide KANFET NODE stack for Hopper (sm_90a): the
// forward dopri5 trajectory solve over [ts[0], ts[T-1]] with CONTD5 dense
// output at the T requested times (with or without per-attempt records)
// and the reverse replay, the discrete adjoint on the recorded step mesh
// with the dense-output cotangents injected.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_kanfet_wide.py:573
// (make_wide_train_solver; forward _make_fwd_kernel :101, pallas_call
// :632; backward _make_bwd_kernel :286, pallas_call :663).  The field is
// autonomous: a stack of KANFET layers, D -> ... -> D, each with the
// hysteresis state fresh and frozen (prev_x = 0, branch = +1,
// _ferro_rows :90-99):
//
//   y[b, o] = sum_i silu(x[b, i]) bw[o, i]
//           + sum_i sum_c B_c(x[b, i]) sw[o, i, c]
//           + sum_i sum_k coef (ps tanh(k (x + ec beta)) + bias)[i, o, k]
//   beta    = alpha + (1 - alpha) target,  target = up - dn + (1 - up - dn),
//   up      = mu sigmoid(g (x - ec)),  dn = (1 - mu) sigmoid(g (-x - ec)),
//   mu      = sigmoid(g x)
//
// At this state up cancels: target = 1 - 2 (1 - mu) cn with cn =
// sigmoid(g (-x - ec)), so a term costs one sigmoid and one tanhf, the
// form the TPU kernel evaluates (_ferro_rows :92-101) and the one this
// file uses forward and in the VJP.
//
// The C = 8 cubic B-spline columns run on each input feature's own 12
// knots (Cox-de Boor on half-open intervals, as ops/bsplines.py), and sw
// = spline_weight * spline_scaler is formed outside the kernel (autograd
// carries the scaler's chain).  The gate slope g and alpha are layer 0's,
// as the TPU kernel takes them (:587-589).  The solve and the replay are
// node_common.cuh's trajectory pair (the stage time is ignored); this
// file holds the field and its hand-written VJP.  Every sum runs in the
// kernel's own body in FP32 (no cuBLAS, no TF32, no --use_fast_math: the
// step controller's accept decisions read the error estimate at float32
// rounding).
//
// None of the TPU layout devices come across (the 128-lane padding, the
// 0/1 repetition matmuls, the one-hot output tiles, the per-sample loop):
// each edge (i, o) reads its own K ferro values and C spline weights, 32
// contiguous bytes each, and its input's 12 knots, from global memory.
// The [2, 64, 64, 2] stack's parameters, about 0.8 MB, stay in L2.
//
// Field evaluation, one grid phase a layer (a barrier between layers):
// a row (b, o) is taken by a group of W = ceil(I / 32) warps (rounded up
// to 1, 2, 4 or 8) of one block, the lanes striding over the inputs i;
// each lane forms its inputs' silu, 8 basis columns and 1 - mu once and sums
// the edge's 1 + 8 + K terms; the group adds its warps' shuffle-tree sums
// in warp order through shared memory, so one owner writes y[b, o] and
// the sum has a fixed order.  At B = 1 the middle layer of [2, 64, 64, 2]
// is 64 rows of 64 edges (2 warps a row, 16 blocks), each lane one edge.
//
// VJP with cotangent w (B, D): the layers' inputs again (L - 1 phases),
// then the layers in reverse, one phase each, two kinds of owned items:
//   rows (b, i), W = ceil(O / 32) warps with the lanes over the outputs
//     o: xbar[b, i] = sum_o g[b, o] (silu'(x) bw[o, i] + sum_c B'_c(x)
//     sw[o, i, c] + sum_k coef ps k sech^2 (1 + ec dbeta/dx)), B' from the
//     same recursion's degree-2 columns;
//   edges (o, i), one thread each, summing over b in order: gbw, gsw (8
//     columns), and per k the five ferro gradients (coef, ps, bias, k,
//     ec with dbeta/dec).
// No atomics: the gradients are the same bits on every run.
//
// What bounds it on this card: a [2, 64, 64, 2] evaluation at B = 1 is
// 4,352 edges, about 35,000 ferro terms of a sigmoid and a tanhf, some
// 0.03 us of the card's SFU rate; the solve takes 6 evaluations an
// attempt and 50-100 attempts at rtol 1e-7.  It is bound by the latency
// of one lane's edge (Cox-de Boor's divisions, K sigmoids and tanhfs in
// sequence) and by its serial chain of grid barriers (one a layer
// boundary, with the scaffold's), not by bytes or the card's FP32 or SFU
// rate.

#include "node_common.cuh"

namespace {

using namespace node_common;

constexpr int kC = 8;           // basis columns: grid 5 + order 3
constexpr int kNK = 12;         // knots a feature: grid 5 + 2 * order 3 + 1
constexpr int kMaxLayers = 8;
constexpr int kNW = 8;          // operands a layer
constexpr int kNG = 7;          // gradients a layer: all operands but grid

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

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
      b[j] = ((x - gk[j]) / (gk[j + k] - gk[j])) * b[j] +
             ((gk[j + k + 1] - x) / (gk[j + k + 1] - gk[j + 1])) * b[j + 1];
  }
#pragma unroll
  for (int j = 0; j < kC; ++j) b3[j] = b[j];
}

// Warps of one block that take a row of n terms: ceil(n / 32), rounded up
// to a power of two, at most the block's kWarps.
__device__ __forceinline__ int warps_per_row(int n) {
  int w = 1;
  while (w < kWarps && 32 * w < n) w <<= 1;
  return w;
}

struct Layer {
  const float* bw;     // (O, I)
  const float* sw;     // (O, I, C) scaled spline weight
  const float* grid;   // (I, 12)
  const float* fk;     // (I, O, K) ferro arrays
  const float* fec;
  const float* fps;
  const float* fbias;
  const float* fcoef;
  float* g[kNG];       // gradients, VJP only: bw, sw, k, ec, ps, bias, coef
  float* x;            // (B, I) scratch: this layer's input (layers >= 1)
  float* xbar;         // (B, I) scratch: its cotangent (layers >= 1)
  int I, O, K;
};

// What one input value gives every edge leaving it.
struct InputTerms {
  float x, s, omu;     // the value, silu(x), 1 - sigmoid(g x)
  float bas[kC];
};

struct WideField {
  Layer layer[kMaxLayers];
  int n_layers, B;
  float gate, alpha, oma;  // oma = 1 - alpha, rounded from double

  __device__ InputTerms input_terms(const Layer& L, float xv, int i) const {
    InputTerms p;
    p.x = xv;
    p.s = silu(xv);
    p.omu = 1.0f - sigmoid(gate * xv);
    float unused[kC];
    bspline<false>(xv, L.grid + i * kNK, p.bas, unused);
    return p;
  }

  // Edge (i, o)'s term of y[b, o] at the input terms p of x[b, i].
  __device__ float edge(const Layer& L, const InputTerms& p, int i,
                        int o) const {
    float acc = p.s * L.bw[o * L.I + i];
    const float* sw = L.sw + ((size_t)o * L.I + i) * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc += p.bas[c] * sw[c];
    const size_t e0 = ((size_t)i * L.O + o) * L.K;
    for (int k = 0; k < L.K; ++k) {
      const size_t e = e0 + k;
      const float ec = L.fec[e];
      const float cn = sigmoid(gate * (-p.x - ec));
      const float beta = alpha + oma * (1.0f - 2.0f * p.omu * cn);
      acc += (L.fps[e] * tanhf(L.fk[e] * (p.x + ec * beta)) + L.fbias[e]) *
             L.fcoef[e];
    }
    return acc;
  }

  // One layer's output y (B, O) from its input x (B, I).
  __device__ void layer_fwd(const Layer& L, const float* x, float* y) const {
    __shared__ float red[kWarps];
    const int W = warps_per_row(L.I), per_block = kWarps / W;
    const int warp = threadIdx.x >> 5, lane = lane_id();
    const int sub = warp % W, slot = warp / W;
    const int n_rows = B * L.O;
    for (int r0 = blockIdx.x * per_block; r0 < n_rows;
         r0 += gridDim.x * per_block) {
      const int r = r0 + slot;
      float acc = 0.0f;
      if (r < n_rows) {
        const int b = r / L.O, o = r - b * L.O;
        for (int i = sub * 32 + lane; i < L.I; i += 32 * W)
          acc += edge(L, input_terms(L, ld(x + b * L.I + i), i), i, o);
      }
      acc = warp_sum(acc);
      if (lane == 0) red[warp] = acc;
      __syncthreads();
      if (sub == 0 && lane == 0 && r < n_rows) {
        float s = red[slot * W];
        for (int q = 1; q < W; ++q) s += red[slot * W + q];
        y[r] = s;
      }
      __syncthreads();
    }
  }

  // One layer's VJP: the cotangent g (B, O) of its output at its input x
  // (B, I) -> xbar (B, I); the layer's gradients accumulated.
  __device__ void layer_vjp(const Layer& L, const float* x, const float* g,
                            float* xbar) const {
    const float c2 = 2.0f * gate * oma;
    // Rows (b, i): the input cotangents.
    {
      __shared__ float red[kWarps];
      const int W = warps_per_row(L.O), per_block = kWarps / W;
      const int warp = threadIdx.x >> 5, lane = lane_id();
      const int sub = warp % W, slot = warp / W;
      const int n_rows = B * L.I;
      for (int r0 = blockIdx.x * per_block; r0 < n_rows;
           r0 += gridDim.x * per_block) {
        const int r = r0 + slot;
        float acc = 0.0f;
        if (r < n_rows) {
          const int b = r / L.I, i = r - b * L.I;
          const float xv = ld(x + r);
          const float ds = dsilu(xv), mu = sigmoid(gate * xv);
          float bas[kC], d3[kC];
          bspline<true>(xv, L.grid + i * kNK, bas, d3);
          for (int o = sub * 32 + lane; o < L.O; o += 32 * W) {
            const float gv = ld(g + b * L.O + o);
            float v = ds * L.bw[o * L.I + i];
            const float* sw = L.sw + ((size_t)o * L.I + i) * kC;
#pragma unroll
            for (int c = 0; c < kC; ++c) v += d3[c] * sw[c];
            const size_t e0 = ((size_t)i * L.O + o) * L.K;
            for (int k = 0; k < L.K; ++k) {
              const size_t e = e0 + k;
              const float ec = L.fec[e], kk = L.fk[e];
              const float cn = sigmoid(gate * (-xv - ec));
              const float beta =
                  alpha + oma * (1.0f - 2.0f * (1.0f - mu) * cn);
              const float th = tanhf(kk * (xv + ec * beta));
              const float dbdx = c2 * (1.0f - mu) * cn * (mu + 1.0f - cn);
              v += L.fcoef[e] * L.fps[e] * kk * (1.0f - th * th) *
                   (1.0f + ec * dbdx);
            }
            acc += gv * v;
          }
        }
        acc = warp_sum(acc);
        if (lane == 0) red[warp] = acc;
        __syncthreads();
        if (sub == 0 && lane == 0 && r < n_rows) {
          float s = red[slot * W];
          for (int q = 1; q < W; ++q) s += red[slot * W + q];
          xbar[r] = s;
        }
        __syncthreads();
      }
    }
    // Edges (o, i): the gradients, summed over b in order (each term added
    // to the owner's gradient entry as b advances).  Items run from the
    // grid's last thread down, away from the blocks that took rows.
    const int nth = grid_threads();
    float *gbw = L.g[0], *gsw = L.g[1], *gk = L.g[2], *gec = L.g[3];
    float *gps = L.g[4], *gbias = L.g[5], *gcoef = L.g[6];
    for (int q = nth - 1 - grid_tid(); q < L.O * L.I; q += nth) {
      const int o = q / L.I, i = q - o * L.I;
      const size_t e0 = ((size_t)i * L.O + o) * L.K;
      float* gs = gsw + (size_t)q * kC;
      for (int b = 0; b < B; ++b) {
        const float xv = ld(x + b * L.I + i), gv = ld(g + b * L.O + o);
        const float omu = 1.0f - sigmoid(gate * xv);
        float bas[kC], unused[kC];
        bspline<false>(xv, L.grid + i * kNK, bas, unused);
        gbw[q] = ld(gbw + q) + gv * silu(xv);
#pragma unroll
        for (int c = 0; c < kC; ++c) gs[c] = ld(gs + c) + gv * bas[c];
        for (int k = 0; k < L.K; ++k) {
          const size_t e = e0 + k;
          const float ec = L.fec[e], kk = L.fk[e], ps = L.fps[e];
          const float cn = sigmoid(gate * (-xv - ec));
          const float beta = alpha + oma * (1.0f - 2.0f * omu * cn);
          const float z = xv + ec * beta;
          const float th = tanhf(kk * z);
          const float fb = gv * L.fcoef[e];       // the term's cotangent
          const float common = fb * ps * (1.0f - th * th);
          gcoef[e] = ld(gcoef + e) + gv * (ps * th + L.fbias[e]);
          gps[e] = ld(gps + e) + fb * th;
          gbias[e] = ld(gbias + e) + fb;
          gk[e] = ld(gk + e) + common * z;
          gec[e] = ld(gec + e) +
                   common * kk * (beta + ec * c2 * omu * cn * (1.0f - cn));
        }
      }
    }
  }

  __device__ void eval(const float* u, float t, float* out) const {
    for (int l = 0; l < n_layers; ++l) {
      const bool last = l == n_layers - 1;
      layer_fwd(layer[l], l == 0 ? u : layer[l].x,
                last ? out : layer[l + 1].x);
      if (!last) cg::this_grid().sync();
    }
  }

  __device__ void vjp(const float* u, float t, const float* w,
                      float* ubar) const {
    cg::grid_group grid = cg::this_grid();
    for (int l = 0; l + 1 < n_layers; ++l) {
      layer_fwd(layer[l], l == 0 ? u : layer[l].x, layer[l + 1].x);
      grid.sync();
    }
    for (int l = n_layers - 1; l >= 0; --l) {
      layer_vjp(layer[l], l == 0 ? u : layer[l].x,
                l == n_layers - 1 ? w : layer[l + 1].xbar,
                l == 0 ? ubar : layer[l].xbar);
      if (l > 0) grid.sync();
    }
  }
};

struct FwdArgs {
  WideField f;
  SolveBufs s;
};

struct BwdArgs {
  WideField f;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kThreads) kanfet_wide_fwd_kernel(FwdArgs a) {
  adaptive_solve_traj<kRecord>(a.f, a.s);
}

// Element counts of a layer's gradients, in the order of Layer::g.
__host__ __device__ inline void grad_sizes(const Layer& L, size_t (&n)[kNG]) {
  const size_t e = (size_t)L.I * L.O;
  n[0] = e;
  n[1] = e * kC;
  for (int j = 2; j < kNG; ++j) n[j] = e * L.K;
}

__global__ void __launch_bounds__(kThreads) kanfet_wide_bwd_kernel(BwdArgs a) {
  const int tid = grid_tid(), nth = grid_threads();
  for (int l = 0; l < a.f.n_layers; ++l) {
    size_t n[kNG];
    grad_sizes(a.f.layer[l], n);
    for (int j = 0; j < kNG; ++j)
      for (size_t i = tid; i < n[j]; i += nth) a.f.layer[l].g[j][i] = 0.0f;
  }
  cg::this_grid().sync();
  adjoint_replay_traj(a.f, a.r);
}

// dims holds (I, O, K) a layer; returns false unless the layers chain
// D -> ... -> D and fit the field.
bool check_dims(const int* dims, int n_layers) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int l = 0; l < n_layers; ++l) {
    const int* d = dims + 3 * l;
    if (d[0] < 1 || d[1] < 1 || d[2] < 1) return false;
    if (l > 0 && d[0] != dims[3 * (l - 1) + 1]) return false;
  }
  return dims[3 * (n_layers - 1) + 1] == dims[0];
}

// Scratch layout in `work` (floats): the scaffold's 10 N (fwd y, ks, u;
// bwd lam, kbar, u, ub), per layer l >= 1 its input and the input's
// cotangent (2 B I_l), then part.
size_t field_floats(int B, const int* dims, int n_layers) {
  size_t n = 0;
  for (int l = 1; l < n_layers; ++l) n += 2 * (size_t)B * dims[3 * l];
  return n;
}

size_t work_floats(int B, const int* dims, int n_layers) {
  return 10 * (size_t)B * dims[0] + field_floats(B, dims, n_layers) +
         kPartFloats;
}

WideField make_field(const float* const* w, const int* dims, int n_layers,
                     float* work, int B, float gate, float alpha, float oma) {
  WideField f{};
  f.n_layers = n_layers;
  f.B = B;
  f.gate = gate;
  f.alpha = alpha;
  f.oma = oma;
  float* p = work + 10 * (size_t)B * dims[0];
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = f.layer[l];
    const float* const* lw = w + kNW * l;
    L.bw = lw[0];
    L.sw = lw[1];
    L.grid = lw[2];
    L.fk = lw[3];
    L.fec = lw[4];
    L.fps = lw[5];
    L.fbias = lw[6];
    L.fcoef = lw[7];
    L.I = dims[3 * l];
    L.O = dims[3 * l + 1];
    L.K = dims[3 * l + 2];
    if (l > 0) {
      L.x = p;
      L.xbar = p + (size_t)B * L.I;
      p += 2 * (size_t)B * L.I;
    }
  }
  return f;
}

float* part_of(float* work, int B, const int* dims, int n_layers) {
  return work + 10 * (size_t)B * dims[0] + field_floats(B, dims, n_layers);
}

}  // namespace

extern "C" long long kanfet_wide_work_floats(int B, const int* dims,
                                             int n_layers) {
  if (!check_dims(dims, n_layers)) return -1;
  return (long long)work_floats(B, dims, n_layers);
}

// x0 (B, D), ts (T) and per layer the 8 operands w (bw (O, I), sw (O, I,
// 8), grid (I, 12), k, ec, ps, bias, coef (I, O, K)), dims (I, O, K) a
// layer -> out (T, B, D) and, when record is nonzero, tda (M, 4), yrec
// (M, B, D), krec (M, 7, B, D), misc (4).
extern "C" int kanfet_wide_fwd(const float* x0, const float* ts,
                               const float* const* w, const int* dims,
                               int n_layers, float* out, float* tda,
                               float* yrec, float* krec, float* misc,
                               float* work, int B, int T, int max_steps,
                               float rtol, float atol, float gate,
                               float alpha, float oma, int record,
                               void* stream) {
  if (!check_dims(dims, n_layers)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return 0;
  FwdArgs a{};
  a.f = make_field(w, dims, n_layers, work, B, gate, alpha, oma);
  const size_t N = (size_t)B * dims[0];
  a.s.h0 = x0;
  a.s.out = out;
  a.s.ts = ts;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.y = work;
  a.s.ks = work + N;
  a.s.u = work + 8 * N;
  a.s.part = part_of(work, B, dims, n_layers);
  a.s.N = (int)N;
  a.s.T = T;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cooperative(kanfet_wide_fwd_kernel<true>, a, s)
                : launch_cooperative(kanfet_wide_fwd_kernel<false>, a, s);
}

// ct (T, B, D), the trajectory's cotangent, the forward's records and the
// operands -> per layer the 7 gradients g (of all operands but the grid,
// shaped as they are) and x0bar (B, D).
extern "C" int kanfet_wide_bwd(const float* ct, const float* ts,
                               const float* tda, const float* yrec,
                               const float* krec, const float* misc,
                               const float* const* w, float* const* g,
                               const int* dims, int n_layers, float* x0bar,
                               float* work, int B, int T, float gate,
                               float alpha, float oma, void* stream) {
  if (!check_dims(dims, n_layers)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return 0;
  BwdArgs a{};
  a.f = make_field(w, dims, n_layers, work, B, gate, alpha, oma);
  for (int l = 0; l < n_layers; ++l)
    for (int j = 0; j < kNG; ++j) a.f.layer[l].g[j] = g[kNG * l + j];
  const size_t N = (size_t)B * dims[0];
  a.r.hbar = ct;
  a.r.ts = ts;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = x0bar;
  a.r.lam = work;
  a.r.kbar = work + N;
  a.r.u = work + 8 * N;
  a.r.ub = work + 9 * N;
  a.r.N = (int)N;
  a.r.T = T;
  return launch_cooperative(kanfet_wide_bwd_kernel, a,
                            static_cast<cudaStream_t>(stream));
}
