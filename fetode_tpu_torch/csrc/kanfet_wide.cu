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
// knots (Cox-de Boor on half-open intervals, as ops/bsplines.py), on the
// window of the 4 bases that are nonzero at x, with kanfet_field.cuh's
// bspline_window (the full recursion's bits, div_knot's branch-free
// quotient), and sw = spline_weight * spline_scaler is formed outside the
// kernel (autograd carries the scaler's chain).  The gate slope g and
// alpha are layer 0's, as the TPU kernel takes them (:587-589).  The
// sigmoid is kanfet_field.cuh's (rcp_sigmoid: IEEE's bits wherever the
// quotient is not denormal, without the branch that serialised a lane's
// quotients).  Every sum runs in the kernel's own body in FP32 (no cuBLAS,
// no TF32, no --use_fast_math: the step controller's accept decisions read
// the error estimate at float32 rounding).
//
// Design (redesigned for Hopper; the first form was a cooperative grid
// with a grid barrier at every layer and stage, the parameters read from
// L2 and each edge's input prep formed by every edge):
//
// * One thread-block cluster of C CTAs of kCTA threads (1 <= C <= 16; 16
//   needs the non-portable cluster size) runs the whole solve.  CTA c
//   owns the outputs [c O / C, (c + 1) O / C) of every layer and holds in
//   its own shared memory, for the whole launch, every parameter of the
//   edges (i, o) of its slice (bw, 8 sw, and K each of k, ec, ps, bias,
//   coef), every layer's knots and, in the backward, its edges' gradient
//   accumulators (the same layout); they are written to the gradient
//   tensors once, at the end.  The wrapper's plan (ops/kanfet_wide.py:
//   cluster_plan) takes, for both kernels, the fewest CTAs whose shared
//   memory holds the backward's bytes (smem_layout below; 11 at [2, 64,
//   64, 2] and B = 1), and the launcher checks with
//   cudaOccupancyMaxActiveClusters that the card runs the cluster.
// * The dopri5 state and stages (N = B D floats) are replicated in every
//   CTA: node_common.cuh's trajectory pair under its cluster policy
//   (ClusterSync) runs the stage updates, the error norm and the
//   accept / reject in every CTA, in one fixed order on identical data,
//   so no reduction crosses CTAs.  CTA 0 writes the outputs and records.
// * A layer's input x[b, :] and its mu = sigmoid(g x) sit in every CTA.
//   A layer is two phases and one cluster barrier.  (A): a CTA's threads
//   form its edges' terms fb = ps tanh(k (x + ec beta)) + bias, K threads
//   an edge, while its last threads form the rest of the inputs' prep
//   (SiLU and the spline window; SiLU' and the slopes in the VJP) and
//   each edge's first part, s bw + bas_c sw_c for c = 0..7.  (B): a row
//   (b, o) is W warps with the lanes over the inputs; a lane finishes its
//   edges (+ fb_k coef_k, k = 0..K-1) and adds them, the warps' sums meet
//   in a shuffle tree and then warp order, and the owner warp pushes y[b,
//   o] and its mu into every CTA (distributed shared memory).  That is
//   the first form's order and fused multiply-adds, so the forward is its
//   bits exactly.
// * VJP: the layers' inputs again (L - 1 barriers), then the layers in
//   reverse.  A row (b, i) of input i is a group of threads over the
//   CTA's (o, k) terms; each term gives its share of xbar[b, i] and adds
//   its gradients into the CTA's shared-memory accumulators (each entry
//   one owner thread, over b in order and the replay in order: no
//   atomics, the same bits on every run).  The CTAs' partial sums of
//   xbar[b, i] meet in every CTA after one cluster barrier, added in rank
//   order.
// * Barriers: each buffer that another CTA writes is read only between
//   two cluster barriers that every CTA passes, and its next write comes
//   after a later one.  A one-layer stack would write the stage derivative
//   while a slower CTA may still read it, so it takes one more barrier
//   before each evaluation and VJP.  A cluster of one CTA takes
//   __syncthreads for its barriers.
//
// What bounds it on this card: a [2, 64, 64, 2] evaluation at B = 1 is
// 4,352 edges, about 35,000 ferro terms of a sigmoid and a tanhf, some
// 0.03 us of the card's SFU rate; the solve takes 6 evaluations an
// attempt and 50-100 attempts at rtol 1e-7.  It is bound by latency: per
// layer a few dependent terms a thread, an edge's chain of K + 9 fused
// multiply-adds, a shuffle tree and a cluster barrier, on a handful of
// SMs.

#include "kanfet_field.cuh"
#include "node_common.cuh"

namespace {

using namespace node_common;

constexpr int kC = 8;           // basis columns: grid 5 + order 3
constexpr int kOrd = 3;         // spline order
constexpr int kNK = 12;         // knots a feature: grid 5 + 2 * order 3 + 1
constexpr int kMaxLayers = 8;
constexpr int kNW = 8;          // operands a layer
constexpr int kNG = 7;          // gradients a layer: all operands but grid
constexpr int kCTA = 512;       // threads a CTA (64 registers a thread
                                // at 1,024 spilled; 256 and 384 no faster)
static_assert(kCTA >= 256 && kCTA <= 1024 && (kCTA & (kCTA - 1)) == 0,
              "the row groups and passes take a power-of-two CTA");
constexpr int kMaxCluster = 16;
constexpr int kRed = 32;        // group-sum scratch floats: a warp's sum each
// Output times the kernels keep in static shared memory (the scaffold's
// dense output and its cotangents read them every accepted step); more
// stay in device memory.
constexpr int kMaxTsShared = 128;
// Dynamic shared memory a CTA may take: the card's 227 KB less 1 KB kept
// for the static arrays (node_common.cuh's block_sum, the output times).
constexpr size_t kMaxSmem = 227 * 1024 - 1024;
// Input-prep slots (each B * I_l floats a layer): SiLU, mu = sigmoid(g
// x), the window start (int bits) and the 4 window bases; the backward's
// add SiLU' and the bases' slopes.
constexpr int kPrepFwd = 3 + kOrd + 1;
constexpr int kPrepBwd = kPrepFwd + 1 + kOrd + 1;
constexpr int kSlotS = 0, kSlotMu = 1, kSlotJ0 = 2, kSlotB = 3;
constexpr int kSlotDs = kPrepFwd, kSlotDb = kPrepFwd + 1;

struct Dims {
  int L, B, C;
  int I[kMaxLayers], O[kMaxLayers], K[kMaxLayers];
};

__host__ __device__ inline int out_lo(const Dims& d, int l, int c) {
  return c * d.O[l] / d.C;
}

// Floats of a layer's parameter block (or gradient block) for n_e edges:
// bw, sw (8 a edge), then k, ec, ps, bias, coef (K a edge).
__host__ __device__ inline size_t edge_floats(size_t n_e, int K) {
  return n_e * (1 + kC + 5 * (size_t)K);
}

// Float offsets of CTA `rank`'s dynamic shared memory.  The layout up to
// knots is the same in every CTA; the parameter and gradient blocks
// follow the CTA's own slices.  ops/kanfet_wide.py: smem_floats mirrors it
// (the wrapper checks the two agree).
struct Smem {
  size_t state;              // 10 N: the scaffold's buffers
  size_t xin[kMaxLayers];    // layer l >= 1's input (B, I_l)
  size_t xbar[kMaxLayers];   // its cotangent (B, I_l), VJP only
  size_t prep[kMaxLayers];   // layer l's input prep (slots, B, I_l)
  size_t part;               // VJP: 2 buffers of (C, B, maxI)
  size_t red;                // kRed
  size_t knots[kMaxLayers];  // (I_l, 12)
  size_t par[kMaxLayers];    // the CTA's edges' parameters
  size_t grad[kMaxLayers];   // their gradients, VJP only
  size_t fbuf;               // the forward's terms and spline partials
  size_t total;
  int maxI;
};

__host__ __device__ inline Smem smem_layout(const Dims& d, int rank,
                                            bool bwd) {
  Smem m{};
  const size_t B = d.B, N = B * d.I[0];
  int maxI = 0;
  for (int l = 0; l < d.L; ++l) maxI = d.I[l] > maxI ? d.I[l] : maxI;
  m.maxI = maxI;
  size_t p = 0;
  m.state = p;  p += 10 * N;
  for (int l = 1; l < d.L; ++l) { m.xin[l] = p;  p += B * d.I[l]; }
  if (bwd)
    for (int l = 1; l < d.L; ++l) { m.xbar[l] = p;  p += B * d.I[l]; }
  for (int l = 0; l < d.L; ++l) {
    m.prep[l] = p;
    p += (size_t)(bwd ? kPrepBwd : kPrepFwd) * B * d.I[l];
  }
  m.part = p;  if (bwd) p += 2 * (size_t)d.C * B * maxI;
  m.red = p;  p += kRed;
  for (int l = 0; l < d.L; ++l) { m.knots[l] = p;  p += (size_t)d.I[l] * kNK; }
  size_t fb = 0;
  for (int l = 0; l < d.L; ++l) {
    const int n_o = out_lo(d, l, rank + 1) - out_lo(d, l, rank);
    const size_t n_e = (size_t)n_o * d.I[l];
    const size_t ef = edge_floats(n_e, d.K[l]);
    m.par[l] = p;  p += ef;
    if (bwd) { m.grad[l] = p;  p += ef; }
    const size_t f = B * n_e * (d.K[l] + 1);
    fb = f > fb ? f : fb;
  }
  m.fbuf = p;  p += fb;
  m.total = p;
  return m;
}

// The most floats any CTA of a C-CTA cluster takes.
size_t smem_floats(Dims d, int C, bool bwd) {
  d.C = C;
  size_t most = 0;
  for (int c = 0; c < C; ++c) {
    const size_t t = smem_layout(d, c, bwd).total;
    most = t > most ? t : most;
  }
  return most;
}

// A parameter (or gradient) block: base of the 7 arrays of one layer.
struct Block {
  float *bw, *sw, *k, *ec, *ps, *bias, *coef;
};

__device__ __forceinline__ Block block_at(float* p, size_t n_e, int K) {
  Block b;
  b.bw = p;
  b.sw = p + n_e;
  b.k = b.sw + n_e * kC;
  b.ec = b.k + n_e * K;
  b.ps = b.ec + n_e * K;
  b.bias = b.ps + n_e * K;
  b.coef = b.bias + n_e * K;
  return b;
}

// Sum of v over the aligned group of G threads (G a power of two) that
// holds this thread; the group's first thread gets the total.  A fixed
// tree: shuffles within the warp, then the warps' sums in warp order.
// Every thread of the CTA calls it.
__device__ __forceinline__ float group_total(float v, int G, float* red) {
  const int w = G < 32 ? G : 32;
  for (int off = w >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (G <= 32) return v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if ((threadIdx.x & (G - 1)) == 0)
    for (int q = 1; q < G / 32; ++q) v += red[warp + q];
  __syncthreads();
  return v;
}

// n / d for 0 <= n, d < 2^22 by a float reciprocal rd = 1 / d of d: the
// product is within one of the quotient, and one correction makes it
// exact.  (The hardware's integer division is a long subroutine.)
__device__ __forceinline__ int fdiv(int n, int d, float rd) {
  int q = __float2int_rz(__int2float_rn(n) * rd);
  const int r = n - q * d;
  q += (r >= d) - (r < 0);
  return q;
}

// The first form's warps a row of n inputs: ceil(n / 32), rounded up to a
// power of two, at most 8 (its blocks' warps).
__device__ __forceinline__ int warps_per_row(int n) {
  int w = 1;
  while (w < 8 && 32 * w < n) w <<= 1;
  return w;
}

// The largest power of two G <= the row's terms (rounded up) with G rows
// threads at most the CTA's.
__device__ __forceinline__ int group_size(int terms, int rows) {
  int G = 1;
  while (G < terms && 2 * G <= kCTA && 2 * G * rows <= kCTA) G <<= 1;
  return G;
}

// The CTA's dynamic shared memory.  Every pointer into it is formed from
// this symbol inside the function that uses it, so the compiler knows the
// address space: shared loads and stores, and no generic store that could
// alias (and force reloads of) the field's own scalars.
extern __shared__ float4 wide_smem[];

__device__ __forceinline__ float* smem_base() {
  return reinterpret_cast<float*>(wide_smem);
}

struct ClusterField {
  Dims d;
  Smem m;
  int rank;
  int lo[kMaxLayers], no[kMaxLayers];  // this CTA's outputs of each layer
  float gate, alpha, oma;  // oma = 1 - alpha, rounded from double

  __device__ int n_out(int l) const { return no[l]; }
  __device__ Block par(int l) const {
    return block_at(smem_base() + m.par[l], (size_t)n_out(l) * d.I[l],
                    d.K[l]);
  }
  __device__ Block grad(int l) const {
    return block_at(smem_base() + m.grad[l], (size_t)n_out(l) * d.I[l],
                    d.K[l]);
  }
  // A layer barrier: the cluster's, or the CTA's when it is alone.
  __device__ void layer_sync() const {
    if (d.C == 1) __syncthreads();
    else cg::this_cluster().sync();
  }
  // Where CTA q keeps the float this CTA keeps at p.
  __device__ float* in_cta(float* p, int q) const {
    return d.C == 1 ? p : cg::this_cluster().map_shared_rank(p, q);
  }

  // The prep of input r (of n) of layer l at its value v, but for mu: SiLU,
  // the window start and bases (the first form's bits) and, with kBwd,
  // SiLU' and the bases' slopes.
  template <bool kBwd>
  __device__ __forceinline__ void prep_rest(int l, int r, int n,
                                            float v) const {
    float* const pp = smem_base() + m.prep[l];
    const int I = d.I[l];
    const float* const g =
        smem_base() + m.knots[l] + (r - fdiv(r, I, 1.0f / (float)I) * I) * kNK;
    float b[kOrd + 1], db[kOrd + 1];
    const int j0 = kanfet::bspline_window<false, kBwd>(v, g, kOrd, kNK, b, db);
    pp[kSlotS * n + r] = kanfet::silu(v);
    pp[kSlotJ0 * n + r] = __int_as_float(j0);
#pragma unroll
    for (int t = 0; t <= kOrd; ++t) pp[(kSlotB + t) * n + r] = b[t];
    if constexpr (kBwd) {
      pp[kSlotDs * n + r] = kanfet::silu_d(v);
#pragma unroll
      for (int t = 0; t <= kOrd; ++t) pp[(kSlotDb + t) * n + r] = db[t];
    }
  }

  // Layer l's whole prep in this CTA from its input x (B, I): layer 0's,
  // and the backward's last layer's; the other layers' mu comes with their
  // inputs from the rows' owners and the rest is formed in their term
  // phase.
  template <bool kBwd>
  __device__ void prep_phase(int l, const float* x, bool with_mu) const {
    float* const pp = smem_base() + m.prep[l];
    const int n = d.B * d.I[l];
    for (int r = threadIdx.x; r < n; r += kCTA) {
      const float v = x[r];
      if (with_mu) pp[kSlotMu * n + r] = kanfet::sigmoid(gate * v);
      prep_rest<kBwd>(l, r, n, v);
    }
    __syncthreads();
  }

  // Layer l's outputs of this CTA from its input x (B, I), pushed into
  // dst (B, O) of every CTA with (unless l is the last layer) their mu as
  // layer l + 1's; ends with the layer barrier.  Layer l's mu is in its
  // prep; for l >= 1 the term phase also forms the rest of it (kBwd: the
  // backward's), which the rows read.  The values are the first (cooperative-grid) form's bits: its
  // edge (i, o) of row (b, o) was s bw, then + bas_c sw_c for c = 0..7,
  // then + fb_k coef_k for k = 0..K-1 (each a fused multiply-add), fb = ps
  // tanh(k (x + ec beta)) + bias; the edges of a row were added by a group
  // of W = warps_per_row(I) warps with the lanes over the inputs, in a
  // shuffle tree and then warp order.  Here every thread forms terms fb
  // (A), then each row's lanes form their edges from them and add them in
  // that order (B).
  template <bool kBwd>
  __device__ void layer_fwd(int l, const float* x, float* dst) const {
    float* const sm = smem_base();
    const int I = d.I[l], O = d.O[l], K = d.K[l], B = d.B, C = d.C;
    const int lo = this->lo[l], n_o = no[l];
    const float g_ = gate, alpha_ = alpha, oma_ = oma;
    const bool last = l == d.L - 1;
    const Block P = par(l);
    const int nx = B * I;                      // the prep slots' stride
    const float* const pp = sm + m.prep[l];
    const int n_e = n_o * I, n_er = B * n_e;
    float* const fb = sm + m.fbuf;             // (B, n_e, K) terms
    float* const sp = fb + (size_t)n_er * K;   // (B, n_e) spline partials
    const int t = threadIdx.x;
    // (A) on the CTA's last np threads (one an input, or one per 8 edges,
    // at most a quarter): the rest of the inputs' prep (l >= 1), then,
    // after a barrier of those threads alone, the first part of each
    // edge's sum, s bw + bas_c sw_c for c = 0..7; on the others the terms,
    // K threads an edge.
    const int np = min((max(nx, n_er / 8) + 31) & ~31, kCTA / 4);
    const int nt = kCTA - np;
    if (t >= nt) {
      if (l > 0) {
        for (int r = kCTA - 1 - t; r < nx; r += np)
          prep_rest<kBwd>(l, r, nx, x[r]);
        asm volatile("bar.sync 1, %0;" ::"r"(np) : "memory");
      }
      const float rI = 1.0f / (float)I;
      for (int q = kCTA - 1 - t; q < n_er; q += np) {   // q = (b, o, i)
        const int b = fdiv(q, n_e, 1.0f / (float)n_e), e = q - b * n_e;
        const int i = e - fdiv(e, I, rI) * I, r = b * I + i;
        const int j0 = __float_as_int(pp[kSlotJ0 * nx + r]);
        float bw4[kOrd + 1];
#pragma unroll
        for (int u = 0; u <= kOrd; ++u) bw4[u] = pp[(kSlotB + u) * nx + r];
        float ae = pp[kSlotS * nx + r] * P.bw[e];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int tt = c - j0;
          float bas = 0.0f;
#pragma unroll
          for (int u = 0; u <= kOrd; ++u) bas = tt == u ? bw4[u] : bas;
          ae += bas * P.sw[(size_t)e * kC + c];
        }
        sp[q] = ae;
      }
    }
    if (K <= nt) {
      const float rK = 1.0f / (float)K;
      const int step = fdiv(nt, K, rK), tk = fdiv(t, K, rK), k = t - tk * K;
      const float rn_e = 1.0f / (float)n_e, rI = 1.0f / (float)I;
      if (t < step * K)
#pragma unroll 4
        for (int er = tk; er < n_er; er += step) {
          const int b = fdiv(er, n_e, rn_e), e = er - b * n_e;
          const int i = e - fdiv(e, I, rI) * I;
          const int pr = b * I + i;
          const size_t q = (size_t)e * K + k;
          const float xv = x[pr], omu = 1.0f - pp[kSlotMu * nx + pr];
          const float ec = P.ec[q];
          // kanfet_field.cuh's sigmoid: the IEEE quotient's bits wherever
          // it is not denormal, and a denormal cn or mu moves no bit of
          // beta (1 - 2 omu cn rounds to 1 there), so these are the first
          // form's bits without the quotient's slow-path branch.
          const float cn = kanfet::sigmoid(g_ * (-xv - ec));
          const float beta = alpha_ + oma_ * (1.0f - 2.0f * omu * cn);
          fb[(size_t)er * K + k] =
              P.ps[q] * tanhf(P.k[q] * (xv + ec * beta)) + P.bias[q];
        }
    }
    __syncthreads();
    // (B) the rows (b, o): W warps a row, each lane its inputs' edges.
    const int W = warps_per_row(I), lw = __ffs(W) - 1;
    const int per = (kCTA / 32) >> lw;
    const int warp = t >> 5, lane = t & 31, sub = warp & (W - 1);
    const int rs = warp >> lw;
    const float rn_o = 1.0f / (float)max(n_o, 1);
    float* const red = sm + m.red;
    const int n_rows = B * n_o, In = last ? 0 : d.I[l + 1];
    float* const mun = last ? nullptr : sm + m.prep[l + 1] + kSlotMu * B * In;
    for (int r0 = 0; r0 < n_rows; r0 += per) {
      const int r = r0 + rs;
      float acc = 0.0f;
      if (r < n_rows) {
        const int b = fdiv(r, n_o, rn_o), ol = r - b * n_o;
        for (int i = sub * 32 + lane; i < I; i += 32 * W) {
          const int e = ol * I + i;
          float ae = sp[b * n_e + e];
          const float* const fr = fb + ((size_t)b * n_e + e) * K;
          const float* const cf = P.coef + (size_t)e * K;
#pragma unroll 8
          for (int k = 0; k < K; ++k) ae += fr[k] * cf[k];
          acc += ae;
        }
      }
      acc = warp_sum(acc);
      if (W > 1) {
        if (lane == 0) red[warp] = acc;
        __syncthreads();
        acc = red[rs * W];
        for (int q = 1; q < W; ++q) acc += red[rs * W + q];
      }
      // The owner warp: every lane holds the row's value; lane q pushes it,
      // and its mu as layer l + 1's input, into CTA q.
      if (sub == 0 && r < n_rows) {
        const int b = fdiv(r, n_o, rn_o), o = lo + r - b * n_o;
        const int idx = b * O + o;
        const float mu = last ? 0.0f : kanfet::sigmoid(g_ * acc);
        if (lane < C) {
          in_cta(dst, lane)[idx] = acc;
          if (!last) in_cta(mun, lane)[idx] = mu;
        }
      }
      if (W > 1) __syncthreads();
    }
    layer_sync();
  }

  // Layer l's VJP at its input x (B, I), its prep (the backward's) and
  // output cotangent gy (B, O): this CTA's gradients accumulated, xbar (B,
  // I) into dst of this CTA (every CTA forms the same bits); part is one of
  // the two partial buffers (C, B, I).
  __device__ void layer_vjp(int l, const float* x, const float* gy,
                            float* dst, float* part) const {
    float* const sm = smem_base();
    const int I = d.I[l], O = d.O[l], K = d.K[l], B = d.B, C = d.C;
    const int lo = this->lo[l], n_o = no[l];
    const int rk = rank;
    const float g_ = gate, alpha_ = alpha, oma_ = oma;
    const float c2 = 2.0f * g_ * oma_;
    const Block P = par(l), Gr = grad(l);
    const int nx = B * I;
    const float* const pp = sm + m.prep[l];
    const int NK = n_o * K;
    const int G = group_size(NK, I), lg = __ffs(G) - 1, RP = kCTA >> lg;
    const int g = threadIdx.x & (G - 1);
    const float rK = 1.0f / (float)K;
    float* const red = sm + m.red;
    for (int r0 = 0; r0 < I; r0 += RP) {
      const int i = r0 + ((int)threadIdx.x >> lg);
      for (int b = 0; b < B; ++b) {
        float acc = 0.0f;
        if (i < I) {
          const int pr = b * I + i;
          const float xv = x[pr], mu = pp[kSlotMu * nx + pr];
          const float omu = 1.0f - mu;
          const int j0 = __float_as_int(pp[kSlotJ0 * nx + pr]);
          for (int jj = g; jj < NK; jj += G) {
            const int ol = fdiv(jj, K, rK), k = jj - ol * K;
            const int e = ol * I + i;
            const size_t q = (size_t)e * K + k;
            const float gv = gy[b * O + lo + ol];
            const float ec = P.ec[q], kk = P.k[q], ps = P.ps[q];
            const float cf = P.coef[q];
            const float cn = kanfet::sigmoid(g_ * (-xv - ec));
            const float beta = alpha_ + oma_ * (1.0f - 2.0f * omu * cn);
            const float z = xv + ec * beta;
            const float th = tanhf(kk * z);
            const float sech2 = 1.0f - th * th;
            const float dbdx = c2 * omu * cn * (mu + 1.0f - cn);
            float v = cf * ps * kk * sech2 * (1.0f + ec * dbdx);
            const float fb = gv * cf;             // the term's cotangent
            const float common = fb * ps * sech2;
            Gr.coef[q] += gv * (ps * th + P.bias[q]);
            Gr.ps[q] += fb * th;
            Gr.bias[q] += fb;
            Gr.k[q] += common * z;
            Gr.ec[q] += common * kk * (beta + ec * c2 * omu * cn * (1.0f - cn));
            if (k == 0) {
              v += pp[kSlotDs * nx + pr] * P.bw[e];
              Gr.bw[e] += gv * pp[kSlotS * nx + pr];
            }
            for (int c = k; c < kC; c += K) {
              const int tt = c - j0;
              if (tt >= 0 && tt <= kOrd) {
                const size_t sc = (size_t)e * kC + c;
                v += pp[(kSlotDb + tt) * nx + pr] * P.sw[sc];
                Gr.sw[sc] += gv * pp[(kSlotB + tt) * nx + pr];
              }
            }
            acc += gv * v;
          }
        }
        acc = group_total(acc, G, red);
        if (g == 0 && i < I)
          for (int q = 0; q < C; ++q)
            in_cta(part, q)[(rk * B + b) * I + i] = acc;
      }
    }
    layer_sync();
    for (int r = threadIdx.x; r < B * I; r += kCTA) {
      float v = part[r];
      for (int q = 1; q < C; ++q) v += part[(size_t)q * B * I + r];
      dst[r] = v;
    }
    __syncthreads();
  }

  __device__ const float* input(int l, const float* u) const {
    return l == 0 ? u : smem_base() + m.xin[l];
  }

  __device__ void eval(const float* u, float, float* out) const {
    if (d.L == 1) layer_sync();
    prep_phase<false>(0, u, true);
    for (int l = 0; l < d.L; ++l)
      layer_fwd<false>(l, input(l, u),
                       l == d.L - 1 ? out : smem_base() + m.xin[l + 1]);
  }

  __device__ void vjp(const float* u, float, const float* w,
                      float* ubar) const {
    float* const sm = smem_base();
    if (d.L == 1) layer_sync();
    prep_phase<true>(0, u, true);
    for (int l = 0; l + 1 < d.L; ++l)
      layer_fwd<true>(l, input(l, u), sm + m.xin[l + 1]);
    if (d.L > 1) prep_phase<true>(d.L - 1, input(d.L - 1, u), false);
    const size_t half = (size_t)d.C * d.B * m.maxI;
    for (int l = d.L - 1; l >= 0; --l)
      layer_vjp(l, input(l, u), l == d.L - 1 ? w : sm + m.xbar[l + 1],
                l == 0 ? ubar : sm + m.xbar[l], sm + m.part + (l & 1) * half);
  }
};

struct Operands {
  const float* w[kMaxLayers * kNW];  // per layer bw, sw, grid, k, ec, ps,
                                     // bias, coef, global
  float* g[kMaxLayers * kNG];        // backward: their gradients, global
  float gate, alpha, oma;
};

// Copy (kLoad) the CTA's slices of the operands into its shared memory,
// or (!kLoad) its gradient blocks out to the gradient tensors.
template <bool kLoad>
__device__ void transfer(const ClusterField& f, const Operands& ops) {
  const Dims& d = f.d;
  for (int l = 0; l < d.L; ++l) {
    const int I = d.I[l], O = d.O[l], K = d.K[l];
    const int lo = out_lo(d, l, f.rank), n_o = out_lo(d, l, f.rank + 1) - lo;
    const size_t n_e = (size_t)n_o * I;
    const Block P = kLoad ? f.par(l) : f.grad(l);
    const float* const* w = ops.w + kNW * l;
    float* const* g = ops.g + kNG * l;
    // bw (O, I) and sw (O, I, 8): the slice's rows are contiguous.
    for (size_t q = threadIdx.x; q < n_e; q += kCTA) {
      if (kLoad) P.bw[q] = w[0][(size_t)lo * I + q];
      else g[0][(size_t)lo * I + q] = P.bw[q];
    }
    for (size_t q = threadIdx.x; q < n_e * kC; q += kCTA) {
      if (kLoad) P.sw[q] = w[1][(size_t)lo * I * kC + q];
      else g[1][(size_t)lo * I * kC + q] = P.sw[q];
    }
    if (kLoad)
      for (int q = threadIdx.x; q < I * kNK; q += kCTA)
        smem_base()[f.m.knots[l] + q] = w[2][q];
    // The ferro arrays: global (I, O, K), shared (o - lo, I, K).
    float* const loc[5] = {P.k, P.ec, P.ps, P.bias, P.coef};
    for (int a = 0; a < 5; ++a)
      for (size_t q = threadIdx.x; q < n_e * K; q += kCTA) {
        const size_t e = q / K;
        const int k = (int)(q - e * K);
        const int ol = (int)(e / I), i = (int)(e - (size_t)ol * I);
        const size_t gq = ((size_t)i * O + lo + ol) * K + k;
        if (kLoad) loc[a][q] = w[3 + a][gq];
        else g[2 + a][gq] = loc[a][q];
      }
  }
}

__device__ ClusterField make_field(const Dims& d, const Operands& ops,
                                   bool bwd) {
  ClusterField f;
  f.d = d;
  f.rank = (int)cg::this_cluster().block_rank();
  f.m = smem_layout(d, f.rank, bwd);
  for (int l = 0; l < d.L; ++l) {
    f.lo[l] = out_lo(d, l, f.rank);
    f.no[l] = out_lo(d, l, f.rank + 1) - f.lo[l];
  }
  f.gate = ops.gate;
  f.alpha = ops.alpha;
  f.oma = ops.oma;
  return f;
}

struct FwdArgs {
  Dims d;
  Operands ops;
  SolveBufs s;
};

struct BwdArgs {
  Dims d;
  Operands ops;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kCTA, 1) kanfet_wide_fwd_kernel(FwdArgs a) {
  float* const sm = smem_base();
  const ClusterField f = make_field(a.d, a.ops, false);
  transfer<true>(f, a.ops);
  SolveBufs s = a.s;
  __shared__ float ts_s[kMaxTsShared];
  if (s.T <= kMaxTsShared) {
    for (int q = threadIdx.x; q < s.T; q += kCTA) ts_s[q] = s.ts[q];
    s.ts = ts_s;
  }
  s.y = sm + f.m.state;
  s.ks = s.y + s.N;
  s.u = s.ks + 7 * s.N;
  // every CTA has started, its slices in place, before any remote store
  cg::this_cluster().sync();
  adaptive_solve_traj<kRecord, ClusterSync>(f, s);
}

__global__ void __launch_bounds__(kCTA, 1) kanfet_wide_bwd_kernel(BwdArgs a) {
  float* const sm = smem_base();
  const ClusterField f = make_field(a.d, a.ops, true);
  transfer<true>(f, a.ops);
  for (int l = 0; l < a.d.L; ++l) {
    const int n_o = out_lo(a.d, l, f.rank + 1) - out_lo(a.d, l, f.rank);
    const size_t n = edge_floats((size_t)n_o * a.d.I[l], a.d.K[l]);
    float* gp = sm + f.m.grad[l];
    for (size_t q = threadIdx.x; q < n; q += kCTA) gp[q] = 0.0f;
  }
  ReplayBufs r = a.r;
  __shared__ float ts_s[kMaxTsShared];
  if (r.T <= kMaxTsShared) {
    for (int q = threadIdx.x; q < r.T; q += kCTA) ts_s[q] = r.ts[q];
    r.ts = ts_s;
  }
  r.lam = sm + f.m.state;
  r.kbar = r.lam + r.N;
  r.u = r.kbar + 7 * r.N;
  r.ub = r.u + r.N;
  cg::this_cluster().sync();
  adjoint_replay_traj<ClusterSync>(f, r);
  __syncthreads();
  transfer<false>(f, a.ops);
}

// dims holds (I, O, K) a layer; false unless the layers chain D -> ... ->
// D and fit the field, and 1 <= B, 1 <= C <= kMaxCluster.
bool make_dims(const int* dims, int n_layers, int B, int C, Dims* d) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1 || C < 1 ||
      C > kMaxCluster)
    return false;
  d->L = n_layers;
  d->B = B;
  d->C = C;
  for (int l = 0; l < n_layers; ++l) {
    const int* t = dims + 3 * l;
    if (t[0] < 1 || t[1] < 1 || t[2] < 1) return false;
    if (l > 0 && t[0] != dims[3 * (l - 1) + 1]) return false;
    d->I[l] = t[0];
    d->O[l] = t[1];
    d->K[l] = t[2];
  }
  return dims[3 * (n_layers - 1) + 1] == dims[0];
}

Operands make_operands(const float* const* w, float* const* g, int n_layers,
                       float gate, float alpha, float oma) {
  Operands ops{};
  for (int j = 0; j < kNW * n_layers; ++j) ops.w[j] = w[j];
  if (g != nullptr)
    for (int j = 0; j < kNG * n_layers; ++j) ops.g[j] = g[j];
  ops.gate = gate;
  ops.alpha = alpha;
  ops.oma = oma;
  return ops;
}

// Launches kernel(args) as one cluster of C CTAs with `floats` floats of
// dynamic shared memory each; an error if the card cannot run it.
template <class Args>
int launch_cluster(void (*kernel)(Args), Args& args, int C, size_t floats,
                   cudaStream_t stream) {
  const size_t bytes = floats * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kCTA, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The most bytes of dynamic shared memory a CTA of a C-CTA cluster takes
// for the forward (bwd = 0) or the backward (bwd = 1) at batch B; -1 if
// the stack or C is not one the kernels take.
extern "C" long long kanfet_wide_smem_bytes(int B, const int* dims,
                                            int n_layers, int C, int bwd) {
  Dims d;
  if (!make_dims(dims, n_layers, B, C, &d)) return -1;
  return (long long)(smem_floats(d, C, bwd != 0) * sizeof(float));
}

// x0 (B, D), ts (T) and per layer the 8 operands w (bw (O, I), sw (O, I,
// 8), grid (I, 12), k, ec, ps, bias, coef (I, O, K)), dims (I, O, K) a
// layer -> out (T, B, D) and, when record is nonzero, tda (M, 4), yrec
// (M, B, D), krec (M, 7, B, D), misc (4).  One cluster of C CTAs.
extern "C" int kanfet_wide_fwd(const float* x0, const float* ts,
                               const float* const* w, const int* dims,
                               int n_layers, float* out, float* tda,
                               float* yrec, float* krec, float* misc, int B,
                               int T, int max_steps, float rtol, float atol,
                               float gate, float alpha, float oma, int record,
                               int C, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  FwdArgs a{};
  if (!make_dims(dims, n_layers, B, C, &a.d)) return (int)cudaErrorInvalidValue;
  a.ops = make_operands(w, nullptr, n_layers, gate, alpha, oma);
  a.s.h0 = x0;
  a.s.out = out;
  a.s.ts = ts;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.part = nullptr;
  a.s.N = B * dims[0];
  a.s.T = T;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  const size_t floats = smem_floats(a.d, C, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cluster(kanfet_wide_fwd_kernel<true>, a, C, floats, s)
                : launch_cluster(kanfet_wide_fwd_kernel<false>, a, C, floats,
                                 s);
}

// ct (T, B, D), the trajectory's cotangent, the forward's records and the
// operands -> per layer the 7 gradients g (of all operands but the grid,
// shaped as they are) and x0bar (B, D).  One cluster of C CTAs.
extern "C" int kanfet_wide_bwd(const float* ct, const float* ts,
                               const float* tda, const float* yrec,
                               const float* krec, const float* misc,
                               const float* const* w, float* const* g,
                               const int* dims, int n_layers, float* x0bar,
                               int B, int T, float gate, float alpha,
                               float oma, int C, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  BwdArgs a{};
  if (!make_dims(dims, n_layers, B, C, &a.d)) return (int)cudaErrorInvalidValue;
  a.ops = make_operands(w, g, n_layers, gate, alpha, oma);
  a.r.hbar = ct;
  a.r.ts = ts;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = x0bar;
  a.r.N = B * dims[0];
  a.r.T = T;
  return launch_cluster(kanfet_wide_bwd_kernel, a, C,
                        smem_floats(a.d, C, true),
                        static_cast<cudaStream_t>(stream));
}
