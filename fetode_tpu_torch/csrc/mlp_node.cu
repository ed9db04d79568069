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
// The solve and the replay are node_common.cuh's final-state pair on its
// cooperative grid; this file holds the field and its hand-written VJP.
// Every product runs in the kernel's own body in FP32 FMAs (no cuBLAS, no
// torch.matmul, no TF32).
//
// The parameters stay put (parameter-stationary tiles, as B.4's
// csrc/ferro_node.cu).  Each of the three layers (layer 1 H x L, layer 2
// H x H, the output layer D x H) is cut into tiles of 16 output rows by
// CG input columns: 2 K columns (two whole features) in layer 1, 16 in
// layer 2, 32 in the output layer (ops/mlp_node.py: slice_plan mirrors
// it).  A layer with fewer tiles than blocks holds G / tiles replicas of
// each; copy v goes to block (v + off) mod G, the output layer's
// replica 0 on other blocks than layer 2's.  A block keeps its copies'
// parameters, the nine coefficients of an (o, l) element together (the
// SiLU base weight, then the 8 spline weights), and their columns' knots
// and mixer parameters in shared memory for the whole launch, and, in the
// backward, their gradients beside them: the sum over the replay stays on
// chip and each gradient is written once, at the end.  At the ECG widths
// a block holds about 30 KB (60 KB with the gradients); 256 + 64 + 16
// tiles on the H100's 264 blocks.
//
// No staged basis tensor: the block that holds a tile forms its columns'
// inputs itself for every row of the batch, in shared memory: layer 1's
// the layer norm, the tanh bound, the mixer, silu(phi) and the 4 nonzero
// cubic bases of phi (knot_quotient.cuh's bases_window and div_knot:
// plain's bits); layer 2's silu(y1) and the bases of y1; the output
// layer's silu(y2).  Each weight is read once an evaluation for every row
// (row_products.cuh: product_rows / rows_item, 4 rows a pass).  The sum
// over a layer's inputs crosses tiles: each tile writes its rows'
// partials, tile-major (cc, b, o), and the consumer adds a row's NC
// partials in tile order (node_common.cuh: ordered_sum); the backward's
// input cotangent likewise over the NR row groups.  So every output and
// gradient is the same bits on every run, and no atomics.
//
// The solve takes node_common.cuh's fused-stage hook: the stage input is
// formed where it is read, straight from y, the stages and the output
// layer's pending partials.  The form follows the batch (ops/mlp_node.py:
// forward_form).  Up to 16 rows the block's threads form one chunk's
// inputs together, and layer 1's prologue forms the layer norm and the
// mixer of its rows: an evaluation is three grid phases (layer 1, layer
// 2, the output layer, left pending); a VJP five (layers 1 and 2 forward;
// layer 2's backward, with the output layer's backward and gradients and
// t = w W in its prologue; layer 1's backward, whose epilogue takes the
// mixer's backward and sums the cotangent over each feature's K bases;
// the layer norm's backward, a warp a row).  Past 16 rows the prologues'
// redundant work (every block forming every row's layer norm, every
// consumer adding partials) outgrows a barrier: phases form the layer
// norm's tanh (B, D) and the crossing sums y1 and y2 (B, H) once, and in
// the forward each warp takes its own groups of 4 rows through a tile with
// no block barrier, the replicas of a layer's tiles sharing the groups:
// six barriers an evaluation, eight a VJP.  Both forms add the same terms
// in the same order.  The field itself lives in the block's shared memory
// (bind_field).
//
// What bounds it on this card: at the ECG widths (D = 64, K = 12, L = 768,
// H = 128) an evaluation is about 2 B H L (C + 1) = 14 M FLOP at B = 8 and
// 453 M at B = 256, 7 us of the card's FP32 rate; with the bases about
// that again.  At B = 8 the grid barriers (about 7 K cycles each) and each
// phase's chain of dependent loads set the time; at 256 the tiles'
// products (each weight a shared-memory read for 4 rows) and the basis
// columns each of layer 1's 8 row groups of tiles forms again.

#include "knot_quotient.cuh"
#include "node_common.cuh"
#include "row_products.cuh"

namespace {

using namespace node_common;
using row_products::cdiv;
using row_products::cols_partials;
using row_products::kGroup;
using row_products::Padded;
using row_products::product_cols;
using row_products::product_rows;
using row_products::round4;
using row_products::row_stride;
using row_products::rows_item;

constexpr int kC = 8;          // basis columns: grid 5 + order 3
constexpr int kNK = 12;        // knots a feature: grid 5 + 2 * order 3 + 1
constexpr int kF = kC + 1;     // coefficients of a KAN element
constexpr int kNG = 11;        // gradients
constexpr int kChunk = 16;     // batch rows a tile pass takes
constexpr int kTileRows = 16;  // output rows of a tile
constexpr int kCols2 = 16;     // input columns of a layer-2 tile
constexpr int kCols3 = 32;     // input columns of an output-layer tile
constexpr int kSum = 32;       // partials a consumer's sum loads at once
constexpr float kLnEps = 1e-5f;
// Dynamic shared memory a block may take: the card's 227 KB less the
// static arrays of the scaffold's reductions.
constexpr size_t kMaxDynamicSmem = 232448 - 2048;

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// The cubic bases of x on the 12 knots g (a feature's row): m, the
// interval [g[m], g[m+1]) that holds x (-1 outside the grid, where every
// basis is 0), and v[r] = B_{m-3+r}, r = 0..3, the window of nonzero
// columns, in plain's arithmetic (knot_quotient.cuh: bases_window, then
// the last level as there); with kDeriv, dv[r] = B'_{m-3+r} = 3 (B2_j /
// (g[j+3] - g[j]) - B2_{j+1} / (g[j+4] - g[j+1])), the quotients
// div_knot's.
template <bool kDeriv>
__device__ __forceinline__ int cubic(float x, const float* g, float (&v)[4],
                                     float (&dv)[4]) {
  float gk[kNK];
#pragma unroll
  for (int j = 0; j < kNK; ++j) gk[j] = g[j];
  int m = -1;
#pragma unroll
  for (int j = 0; j < kNK - 1; ++j)
    if (x >= gk[j] && x < gk[j + 1]) m = j;
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = dv[r] = 0.0f;
  if (m < 0) return -1;
  float v2[3];
  bases_window<2>(x, g, kNK, 2, m, v2);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = m - 3 + r;
    if (j < 0 || j > kC - 1) continue;
    const float oj = r >= 1 ? v2[r - 1] : 0.0f;
    const float oj1 = r <= 2 ? v2[r] : 0.0f;
    const float gj = g[j], gj1 = g[j + 1], gj3 = g[j + 3], gj4 = g[j + 4];
    const float left = div_knot(__fsub_rn(x, gj), __fsub_rn(gj3, gj));
    const float right = div_knot(__fsub_rn(gj4, x), __fsub_rn(gj4, gj1));
    v[r] = __fadd_rn(__fmul_rn(left, oj), __fmul_rn(right, oj1));
    if (kDeriv)
      dv[r] = 3.0f * (div_knot(oj, gj3 - gj) - div_knot(oj1, gj4 - gj1));
  }
  return m;
}

// How one layer (O outputs, I inputs, F coefficients an element) is cut
// into tiles of RG rows by CG columns: NR row groups by NC column chunks,
// tile q = rg * NC + cc.  A layer with fewer tiles than blocks holds rep =
// G / tiles replicas of each: copy v = k tiles + q (replica k of tile q)
// on block (v + off) mod G, which holds `slots` copies at most.  Replica
// 0 runs the backward and the chunk form's forward; in the rows form the
// replicas share the forward's row groups.  KP: a tile's contraction (CG
// F, to a multiple of 4), SW: its rows' stride in shared memory (4 mod 32
// words).
struct Plan {
  int O, I, F, RG, CG, NR, NC, tiles, slots, KP, SW, rep;
  int off;  // copy v on block (v + off) mod G
};

__host__ __device__ inline Plan layer_plan(int G, int O, int I, int F,
                                           int RG, int CG) {
  Plan p;
  p.O = O;
  p.I = I;
  p.F = F;
  p.RG = RG;
  p.CG = CG < I ? CG : I;
  p.NR = cdiv(O, p.RG);
  p.NC = cdiv(I, p.CG);
  p.tiles = p.NR * p.NC;
  p.rep = G > p.tiles ? G / p.tiles : 1;
  p.slots = cdiv(p.tiles * p.rep, G);
  p.off = 0;
  p.KP = round4(p.CG * F);
  p.SW = row_stride(p.KP);
  return p;
}

// The block's shared-memory layout (floats) for G blocks.
struct Geo {
  Plan p[3];         // layer 1 (H, L, 9), layer 2 (H, H, 9), output (D, H, 1)
  int G, bwd, D, K, L, H;
  int rows;  // form 1: the forward by warp rows, the layer norm's tanh
             // and the crossing sums, y1 and y2, formed in phases
  int tsz[3];        // floats of one tile's parameters
  int w_off[3], g_off[3];  // slot 0's parameters / gradients of each layer
  int kn_off[2], kn_sz[2];  // slot 0's knots of layers 1 and 2, a slot's
  int ab_off;        // ga, gb running sums of layer 1's slots (2 CG1 a slot)
  int gbo_off;       // gbo running sums of the output layer's slots (16)
  int gef_off;       // geff running sums of layer 2's slots (4 a slot)
  int owc_off, OCS;  // the output layer's columns of layer 2's slots' rows
                     // (16 rows of OCS floats a slot: ow[:, j], OCS odd)
  int x_off, s_off, p_off, y_off, u_off, m_off, KPm, CG4, MS;
  long long smem_floats;
};

Geo make_geo(int G, int D, int K, int H, bool bwd, int form) {
  Geo g{};
  g.G = G;
  g.bwd = bwd;
  g.rows = form >= 1;
  g.D = D;
  g.K = K;
  g.L = D * K;
  g.H = H;
  g.p[0] = layer_plan(G, H, g.L, kF, kTileRows, 2 * K);
  g.p[1] = layer_plan(G, H, H, kF, kTileRows, kCols2);
  g.p[2] = layer_plan(G, D, H, 1, kTileRows, kCols3);
  // The output layer's replica 0 on other blocks than layer 2's: the two
  // run side by side in the backward's phase.
  g.p[2].off = g.p[1].tiles % G;
  long long at = 0;
  g.KPm = 0;
  for (int ly = 0; ly < 3; ++ly) {
    g.tsz[ly] = g.p[ly].RG * g.p[ly].SW;
    g.w_off[ly] = (int)at;
    at += (long long)g.p[ly].slots * g.tsz[ly];
    g.KPm = g.KPm > g.p[ly].KP ? g.KPm : g.p[ly].KP;
  }
  g.CG4 = round4(g.p[0].CG);
  // A chunk row of the mixer's (x, phi, s1) or of layer 2's inputs' y.
  g.MS = g.CG4 > round4(g.p[1].CG) ? g.CG4 : round4(g.p[1].CG);
  // Each layer-1 / layer-2 copy's knots (CG x 12), layer 1's with the
  // mixer's slope and centre of its columns (2 CG4).
  g.kn_sz[0] = round4(g.p[0].CG * kNK) + 2 * g.CG4;
  g.kn_sz[1] = round4(g.p[1].CG * kNK);
  for (int ly = 0; ly < 2; ++ly) {
    g.kn_off[ly] = (int)at;
    at += (long long)g.p[ly].slots * g.kn_sz[ly];
  }
  if (bwd) {
    for (int ly = 0; ly < 3; ++ly) {
      g.g_off[ly] = (int)at;
      at += (long long)g.p[ly].slots * g.tsz[ly];
    }
    g.ab_off = (int)at;
    at += (long long)g.p[0].slots * 2 * g.CG4;
    g.gbo_off = (int)at;
    at += (long long)g.p[2].slots * g.p[2].RG;
    g.gef_off = (int)at;
    at += (long long)g.p[1].slots * 4;
    g.OCS = D | 1;
    g.owc_off = (int)round4((int)at);
    at = g.owc_off + (long long)g.p[1].slots * g.p[1].RG * g.OCS;
    at = round4((int)at);
  }
  // The chunk's inputs (and, backward, their cotangents), or each warp's
  // 4 rows of inputs in the phase form's forward.
  g.x_off = (int)at;
  g.s_off = g.x_off + kChunk * g.KPm;
  const int xs = kChunk * g.KPm * (bwd ? 2 : 1), xw = kWarps * kGroup * g.KPm;
  at += xs > xw ? xs : xw;
  if (bwd) {
    g.p_off = (int)at;
    at += cols_partials(g.KPm, kThreads);
    g.y_off = (int)at;
    at += (long long)kChunk * kTileRows;
  }
  g.u_off = (int)at;  // a warp's row of the stage input, or a chunk's tanh
  const int urows = kChunk > kWarps ? kChunk : kWarps;
  at += (long long)urows * round4(D > 2 * kC ? D : 2 * kC);
  g.m_off = (int)at;  // the mixer of a chunk: x, phi, s1 (3 kChunk MS)
  at += 3LL * kChunk * g.MS;
  g.smem_floats = at;
  return g;
}

// Scratch layout in `work` (floats), N = B*D: the scaffold's 10 N and
// part; the partials of layer 1 (B H NC1), layer 2 (B H NC2) and the
// output layer (B D NC3); rows: the layer norm's tanh (B D), y1 and y2
// (B H); backward: layer 2's input-cotangent partials (B H NR2), the
// cotangent of the layer norm's output a row group (B D NR1), ubar (B D),
// the layer-norm gradients a row (2 B D), sum_d w bo a row (B), ga and gb
// a row group (2 NR1 L), geff a row group (NR2).
struct WorkLayout {
  size_t part, y1p, y2p, fp, th, y1, y2, y1bp, hp, ubar, glp, wbo, abp, gep,
      total;
};

WorkLayout work_layout(int B, int D, int K, int H, bool bwd, int form) {
  const Geo g = make_geo(1, D, K, H, bwd, form);
  const size_t N = (size_t)B * D, BH = (size_t)B * H;
  WorkLayout w{};
  w.part = 10 * N;
  w.y1p = w.part + kPartFloats;
  w.y2p = w.y1p + BH * g.p[0].NC;
  w.fp = w.y2p + BH * g.p[1].NC;
  w.th = w.fp + N * g.p[2].NC;
  w.y1 = w.th + (g.rows ? N : 0);
  w.y2 = w.y1 + (g.rows ? BH : 0);
  w.y1bp = w.y2 + (g.rows ? BH : 0);
  w.hp = w.y1bp + (bwd ? BH * g.p[1].NR : 0);
  w.ubar = w.hp + (bwd ? N * g.p[0].NR : 0);
  w.glp = w.ubar + (bwd ? N : 0);
  w.wbo = w.glp + (bwd ? 2 * N : 0);
  w.abp = w.wbo + (bwd ? (size_t)B : 0);
  w.gep = w.abp + (bwd ? 2 * (size_t)g.p[0].NR * g.L : 0);
  w.total = w.gep + (bwd ? (size_t)g.p[1].NR : 0);
  return w;
}

// One tile of a layer as this block holds it (replica k).
struct Tile {
  int q, k, rg, cc, o0, c0, rows, cols;
  float* w;   // (16, SW) parameters, element (r, c, k) at r SW + c F + k
  float* gr;  // its gradients, backward
  float* kn;  // layers 1 and 2: its columns' knots (cols, 12)
  float* ma;  // layer 1: its columns' mixer slope and centre (mb = ma + CG4)
  float* mb;
};

struct MlpField {
  static constexpr bool kFused = true;
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
  const float* effp; // (1)
  // gradients, backward only, shaped as their operands
  float* g[kNG];  // glns, glnb, ga, gb, gbw1, gsw1, gbw2, gsw2, gW, gbo, geff
  int B, D, K, L, H;
  float hbound;
  float* work;
  WorkLayout wl;
  Geo geo;
  float* sm;  // the block's dynamic shared memory
  float eff;

  __device__ __forceinline__ const Plan& plan(int ly) const {
    return geo.p[ly];
  }

  // This block's first copy of layer ly: v0 = (block - off) mod G.
  __device__ __forceinline__ int first_copy(int ly) const {
    return ((int)blockIdx.x - plan(ly).off + geo.G) % geo.G;
  }

  __device__ __forceinline__ int slots(int ly) const {
    const Plan& p = plan(ly);
    return (p.tiles * p.rep - first_copy(ly) + geo.G - 1) / geo.G;
  }

  __device__ __forceinline__ Tile tile(int ly, int slot) const {
    const Plan& p = plan(ly);
    Tile t;
    const int v = first_copy(ly) + slot * geo.G;
    t.k = v / p.tiles;
    t.q = v - t.k * p.tiles;
    t.rg = t.q / p.NC;
    t.cc = t.q - t.rg * p.NC;
    t.o0 = t.rg * p.RG;
    t.c0 = t.cc * p.CG;
    t.rows = min(p.RG, p.O - t.o0);
    t.cols = min(p.CG, p.I - t.c0);
    t.w = sm + geo.w_off[ly] + slot * geo.tsz[ly];
    t.gr = sm + geo.g_off[ly] + slot * geo.tsz[ly];
    t.kn = ly < 2 ? sm + geo.kn_off[ly] + slot * geo.kn_sz[ly] : nullptr;
    t.ma = ly == 0 ? t.kn + round4(p.CG * kNK) : nullptr;
    t.mb = ly == 0 ? t.ma + geo.CG4 : nullptr;
    return t;
  }

  // The global element of a tile's (r, c, k): (pointer, index), or null
  // past the layer's edge.
  __device__ __forceinline__ const float* param(int ly, const Tile& t, int r,
                                                int c, int k) const {
    if (r >= t.rows || c >= t.cols) return nullptr;
    const int o = t.o0 + r, i = t.c0 + c;
    if (ly == 2) return ow + (size_t)o * H + i;
    const int n = ly == 0 ? L : H;
    const float* bw = ly == 0 ? bw1 : bw2;
    const float* sw = ly == 0 ? sw1 : sw2;
    return k == 0 ? bw + (size_t)o * n + i
                  : sw + ((size_t)o * n + i) * kC + k - 1;
  }

  __device__ float* gparam(int ly, const Tile& t, int r, int c, int k) const {
    if (r >= t.rows || c >= t.cols) return nullptr;
    const int o = t.o0 + r, i = t.c0 + c;
    if (ly == 2) return g[8] + (size_t)o * H + i;
    const int n = ly == 0 ? L : H;
    float* gbw = g[ly == 0 ? 4 : 6];
    float* gsw = g[ly == 0 ? 5 : 7];
    return k == 0 ? gbw + (size_t)o * n + i
                  : gsw + ((size_t)o * n + i) * kC + k - 1;
  }

  // The tiles' parameters into shared memory, the gradients and running
  // sums zeroed.
  __device__ void load() const {
    for (int ly = 0; ly < 3; ++ly) {
      const Plan& p = plan(ly);
      for (int s = 0; s < slots(ly); ++s) {
        const Tile t = tile(ly, s);
        for (int e = threadIdx.x; e < geo.tsz[ly]; e += blockDim.x) {
          const int r = e / p.SW, ck = e - r * p.SW;
          const int c = ck / p.F, k = ck - c * p.F;
          const float* src = ck < p.CG * p.F ? param(ly, t, r, c, k) : nullptr;
          t.w[e] = src ? __ldg(src) : 0.0f;
          if (geo.bwd) t.gr[e] = 0.0f;
        }
        if (ly == 2) continue;
        const float* gk = ly == 0 ? g1 : g2;
        for (int e = threadIdx.x; e < t.cols * kNK; e += blockDim.x)
          t.kn[e] = __ldg(gk + (size_t)t.c0 * kNK + e);
        if (ly == 0)
          for (int c = threadIdx.x; c < t.cols; c += blockDim.x) {
            t.ma[c] = __ldg(av + t.c0 + c);
            t.mb[c] = __ldg(bv + t.c0 + c);
          }
      }
    }
    if (geo.bwd) {
      const int n = geo.gef_off + plan(1).slots * 4 - geo.ab_off;
      for (int e = threadIdx.x; e < n; e += blockDim.x)
        sm[geo.ab_off + e] = 0.0f;
      for (int s = 0; s < slots(1); ++s) {
        const Tile t = tile(1, s);
        const int RG = plan(1).RG;
        float* oc = sm + geo.owc_off + s * RG * geo.OCS;
        for (int e = threadIdx.x; e < RG * D; e += blockDim.x) {
          const int d = e / RG, r = e - d * RG;
          oc[r * geo.OCS + d] =
              r < t.rows ? __ldg(ow + (size_t)d * H + t.o0 + r) : 0.0f;
        }
      }
    }
  }

  // The pending output at element e, as the forward leaves it.
  __device__ __forceinline__ float pend(int e) const {
    const int d = e % D;
    return eff * (ordered_sum<kSum>(work + wl.fp + e, plan(2).NC,
                                    (size_t)B * D) + ob[d]);
  }

  // The layer norm of row b of the stage input uf by one warp: the row
  // into buf (D floats), its mean and reciprocal deviation (two passes, a
  // fixed shuffle tree).
  template <class UF>
  __device__ __forceinline__ void row_norm(const UF& uf, int b, float* buf,
                                           float& mu, float& r) const {
    const int lane = threadIdx.x & 31;
    const float inv_d = 1.0f / (float)D;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float u = uf(b * D + d);
      buf[d] = u;
      s += u;
    }
    mu = warp_sum(s) * inv_d;
    float v = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float c = buf[d] - mu;
      v += c * c;
    }
    r = 1.0f / sqrtf(warp_sum(v) * inv_d + kLnEps);
  }

  __device__ __forceinline__ float tanh_of(float u, float mu, float r,
                                           int d) const {
    const float x = (u - mu) * r;
    return tanhf((x * lns[d] + lnb[d]) / hbound);
  }

  // rows: the layer norm's tanh of every row into the (B, D) buffer, a warp
  // a row over the grid.
  template <class UF>
  __device__ void ln_phase(const UF& uf) const {
    float* buf = sm + geo.u_off + (threadIdx.x >> 5) * round4(max(D, 2 * kC));
    float* th = work + wl.th;
    for (int b = grid_warp(); b < B; b += grid_warps()) {
      float mu, r;
      row_norm(uf, b, buf, mu, r);
      for (int d = lane_id(); d < D; d += 32)
        th[b * D + d] = tanh_of(buf[d], mu, r, d);
    }
  }

  // phases: y1 or y2 (B, H), each the sum of its NC partials, over the grid.
  __device__ __forceinline__ void fin_phase(int ly) const {
    const int NC = plan(ly).NC;
    const float* part = work + (ly == 0 ? wl.y1p : wl.y2p);
    float* out = work + (ly == 0 ? wl.y1 : wl.y2);
    for (int e = grid_tid(); e < B * H; e += grid_threads())
      out[e] = ordered_sum<kSum>(part + e, NC, (size_t)B * H);
  }

  __device__ __forceinline__ float y_at(int ly, int b, int i) const {
    const int e = b * H + i;
    if (geo.rows) return ld(work + (ly == 0 ? wl.y1 : wl.y2) + e);
    const int NC = plan(ly).NC;
    return ordered_sum<kSum>(work + (ly == 0 ? wl.y1p : wl.y2p) + e, NC,
                             (size_t)B * H);
  }

  // Layer 1's inputs for chunk rows [b0, b0 + nb) of tile t into X: the
  // tanh of the features the tile reads (inline: a warp a row; rows: from
  // the buffer), then a thread a (b, c): the mixer (x, phi, s1 kept in the
  // m block for the backward), silu(phi) and the 8 bases.
  template <class UF>
  __device__ __forceinline__ void inputs1(const UF& uf, const Tile& t, int b0,
                                          int nb, float* X) const {
    const Plan& p = plan(0);
    const int d0 = t.c0 / K, nf = cdiv(t.cols, K);
    const int stride = round4(max(D, 2 * kC));
    float* ths = sm + geo.u_off;  // (kChunk, nf) after the rows below
    if (geo.rows) {
      for (int i = threadIdx.x; i < nb * nf; i += blockDim.x) {
        const int b = i / nf, f = i - b * nf;
        ths[b * stride + f] = ld(work + wl.th + (size_t)(b0 + b) * D + d0 + f);
      }
    } else {
      // A warp a row: the row's stage input into its own row of the u
      // block, then the tanh of the tile's features over it.
      for (int b = threadIdx.x >> 5; b < nb; b += kWarps) {
        float* buf = sm + geo.u_off + b * stride;
        float mu, r;
        row_norm(uf, b0 + b, buf, mu, r);
        __syncwarp();
        float tv[2];
        const int lane = lane_id();
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int f = lane + 32 * k;
          tv[k] = f < nf ? tanh_of(buf[d0 + f], mu, r, d0 + f) : 0.0f;
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (lane + 32 * k < nf) buf[lane + 32 * k] = tv[k];
      }
    }
    __syncthreads();
    float* mx = sm + geo.m_off;
    const int C4 = geo.CG4;
    for (int i = threadIdx.x; i < nb * p.CG; i += blockDim.x) {
      const int b = i / p.CG, c = i - b * p.CG;
      float* xr = X + b * p.KP + c * kF;
      if (c >= t.cols) {
#pragma unroll
        for (int k = 0; k < kF; ++k) xr[k] = 0.0f;
        continue;
      }
      const float x = hbound * ths[b * stride + c / K];
      const float s = sigmoid(t.ma[c] * (x - t.mb[c]));
      const float ph = sigmoid(2.0f * s);
      mx[b * C4 + c] = x;
      mx[(kChunk + b) * C4 + c] = ph;
      mx[(2 * kChunk + b) * C4 + c] = s;
      spline_inputs(ph, t.kn + c * kNK, xr);
    }
    for (int i = threadIdx.x; i < nb * (p.KP - p.CG * kF); i += blockDim.x) {
      const int w = p.KP - p.CG * kF, b = i / w;
      X[b * p.KP + p.CG * kF + i - b * w] = 0.0f;
    }
    __syncthreads();
  }

  // silu(x) and the 8 bases of x on the knots gk into xr[0..8].
  __device__ __forceinline__ static void spline_inputs(float x, const float* gk,
                                                       float* xr) {
    float v[4], dv[4];
    const int m = cubic<false>(x, gk, v, dv);
    xr[0] = silu(x);
#pragma unroll
    for (int k = 0; k < kC; ++k) xr[1 + k] = 0.0f;
    if (m >= 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = m - 3 + r;
        if (j >= 0 && j < kC) xr[1 + j] = v[r];
      }
  }

  // Layer 2's (ly 1) or the output layer's (ly 2) inputs for chunk rows
  // [b0, b0 + nb) of tile t into X; with ycache, the inputs' y (b, c) too.
  __device__ __forceinline__ void inputs23(int ly, const Tile& t, int b0,
                                           int nb, float* X,
                                           float* ycache = nullptr) const {
    const Plan& p = plan(ly);
    for (int i = threadIdx.x; i < nb * p.CG; i += blockDim.x) {
      const int b = i / p.CG, c = i - b * p.CG;
      float* xr = X + b * p.KP + c * p.F;
      if (c >= t.cols) {
        for (int k = 0; k < p.F; ++k) xr[k] = 0.0f;
        continue;
      }
      const float y = y_at(ly - 1, b0 + b, t.c0 + c);
      if (ycache) ycache[b * geo.MS + c] = y;
      if (ly == 1)
        spline_inputs(y, t.kn + c * kNK, xr);
      else
        xr[0] = silu(y);
    }
    for (int i = threadIdx.x; i < nb * (p.KP - p.CG * p.F); i += blockDim.x) {
      const int w = p.KP - p.CG * p.F, b = i / w;
      X[b * p.KP + p.CG * p.F + i - b * w] = 0.0f;
    }
    __syncthreads();
  }

  // One layer's forward over the block's tiles: each tile's rows' sums over
  // its columns, for every row of the batch, into the layer's partials
  // (cc, b, o), tile-major: a tile's stores and a consumer's loads both
  // run over consecutive o.  In the chunk form replica 0 takes the batch
  // 16 rows at a time, the block's threads forming the inputs; in the rows
  // form each warp takes its own groups of 4 rows, the replicas of a tile
  // sharing them, and forms and multiplies them with no block barrier.
  template <class UF>
  __device__ __forceinline__ void layer_fwd(int ly, const UF& uf) const {
    const Plan& p = plan(ly);
    float* X = sm + geo.x_off;
    float* part = work + (ly == 0 ? wl.y1p : ly == 1 ? wl.y2p : wl.fp);
    const int O = p.O, Bn = B;
    for (int s = 0; s < slots(ly); ++s) {
      const Tile t = tile(ly, s);
      const int o0 = t.o0, cc = t.cc;
      if (!geo.rows) {
        if (t.k != 0) continue;
        for (int b0 = 0; b0 < B; b0 += kChunk) {
          const int nb = min(kChunk, B - b0);
          if (ly == 0) inputs1(uf, t, b0, nb, X);
          else inputs23(ly, t, b0, nb, X);
          product_rows(X, p.KP, nb, t.w, Padded{p.SW}, p.KP, t.rows,
                       [=](int b, int r, float v) {
            part[((size_t)cc * Bn + b0 + b) * O + o0 + r] = v;
          });
        }
        continue;
      }
      const int warp = threadIdx.x >> 5, NG = cdiv(t.rows, 8);
      float* Xw = X + warp * kGroup * p.KP;
      for (int gi = t.k + p.rep * warp; gi * kGroup < B; gi += p.rep * kWarps) {
        const int b0 = gi * kGroup, nb = min(kGroup, B - b0);
        warp_inputs(ly, t, b0, nb, Xw);
        __syncwarp();
        for (int og = 0; og < NG; ++og)
          rows_item(Xw, p.KP, nb, t.w, Padded{p.SW}, p.KP, t.rows, og, 0,
                    [=](int b, int r, float v) {
            part[((size_t)cc * Bn + b0 + b) * O + o0 + r] = v;
          });
        __syncwarp();
      }
    }
  }

  // The rows form's inputs of one warp's nb <= 4 rows b0 .. of tile t
  // into Xw (4, KP): layer 1's from the layer norm's tanh in its buffer.
  __device__ __forceinline__ void warp_inputs(int ly, const Tile& t, int b0,
                                              int nb, float* Xw) const {
    const Plan& p = plan(ly);
    const int lane = lane_id(), d0 = t.c0 / K;
    for (int i = lane; i < kGroup * p.CG; i += 32) {
      const int b = i / p.CG, c = i - b * p.CG;
      float* xr = Xw + b * p.KP + c * p.F;
      if (b >= nb || c >= t.cols) {
        for (int k = 0; k < p.F; ++k) xr[k] = 0.0f;
        continue;
      }
      const int row = b0 + b;
      if (ly == 0) {
        const float x =
            hbound * ld(work + wl.th + (size_t)row * D + d0 + c / K);
        const float sg = sigmoid(t.ma[c] * (x - t.mb[c]));
        spline_inputs(sigmoid(2.0f * sg), t.kn + c * kNK, xr);
      } else {
        const float y = y_at(ly - 1, row, t.c0 + c);
        if (ly == 1) spline_inputs(y, t.kn + c * kNK, xr);
        else xr[0] = silu(y);
      }
    }
    for (int i = lane; i < kGroup * (p.KP - p.CG * p.F); i += 32) {
      const int w = p.KP - p.CG * p.F, b = i / w;
      Xw[b * p.KP + p.CG * p.F + i - b * w] = 0.0f;
    }
  }

  // f(u) of the stage, left pending in the output layer's partials.  The
  // scaffold calls it from three places: one copy of the field's forward
  // (the field is in shared memory, so the call costs nothing).
  __device__ __noinline__ void stage(const StageIn& in) const {
    if (in.pending >= 0)
      for (int e = grid_tid(); e < in.N; e += grid_threads())
        in.ks[(size_t)in.pending * in.N + e] = pend(e);
    const auto uf = [&](int e) {
      return stage_input(in, e, [&](int i) { return pend(i); });
    };
    forward(uf);
  }

  // Layers 1 and 2 (through_out: and the output layer) of the stage
  // input uf, a grid barrier after each but the last.
  template <class UF>
  __device__ void forward(const UF& uf, bool through_out = true) const {
    cg::grid_group grid = cg::this_grid();
    if (geo.rows) {
      ln_phase(uf);
      grid.sync();
    }
    layer_fwd(0, uf);
    grid.sync();
    if (geo.rows) {
      fin_phase(0);
      grid.sync();
    }
    layer_fwd(1, uf);
    if (!through_out) return;
    grid.sync();
    if (geo.rows) {
      fin_phase(1);
      grid.sync();
    }
    layer_fwd(2, uf);
  }

  __device__ __forceinline__ float take(int e, float* dst) const {
    const float v = pend(e);
    dst[e] = v;
    return v;
  }

  // Gr[r][ck] += scale sum_b Y[b][r] X[b][ck] over the chunk's nb rows in
  // order (Y rows RG floats apart): a thread a 4 x 4 block of the tile's
  // gradients.
  __device__ __forceinline__ void grad_tile(const Plan& p, float* Gr,
                                            const float* Y, const float* X,
                                            int nb, float scale) const {
    const int nq = p.KP / 4, items = (p.RG / 4) * nq;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int rq = it / nq, cq = it - rq * nq;
      float acc[4][4] = {};
      for (int b = 0; b < nb; ++b) {
        const float4 y = *reinterpret_cast<const float4*>(Y + b * p.RG
                                                          + 4 * rq);
        const float4 x =
            *reinterpret_cast<const float4*>(X + b * p.KP + 4 * cq);
        const float yv[4] = {y.x, y.y, y.z, y.w};
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(yv[a], xv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Gr[(4 * rq + a) * p.SW + 4 * cq + c] += scale * acc[a][c];
    }
  }

  // S[b][ck] = sum_r Y[b][r] W[r][ck]: the cotangent of the tile's inputs'
  // coefficients, for the chunk's rows (row_products.cuh: product_cols).
  __device__ __forceinline__ void input_bar(const Plan& p, const Tile& t,
                                            const float* Y, int nb,
                                            float* S) const {
    const int KP = p.KP;
    product_cols(Y, p.RG, nb, t.w, Padded{p.SW}, p.RG, KP,
                 sm + geo.p_off,
                 [=](int b, int ck, float v) { S[b * KP + ck] = v; });
  }

  // The cotangent of a KAN input x from its coefficients' S row sr (9):
  // silu'(x) S_0 + sum_c B'_c(x) S_{1+c}, the window's terms in column
  // order.
  __device__ __forceinline__ static float kan_bar(float x, const float* gk,
                                                  const float* sr) {
    float v[4], dv[4];
    const int m = cubic<true>(x, gk, v, dv);
    float s = sr[0] * dsilu(x);
    if (m >= 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = m - 3 + r;
        if (j >= 0 && j < kC) s += sr[1 + j] * dv[r];
      }
    return s;
  }

  // Layer 2's backward over the block's tiles, with the output layer's in
  // its prologue: y2bar = eff (w W) silu'(y2) for the tile's rows, its
  // gradients, and the partials of y1's cotangent (b, i, rg); the output
  // layer's tiles: gW += eff sum_b w z, gbo += eff sum_b w; geff's
  // sum_b,j z (w W) a row group, by each row group's first tile.
  __device__ void back2(const float* w) const {
    const Plan& p = plan(1);
    float* X = sm + geo.x_off;
    float* S = sm + geo.s_off;
    float* Y = sm + geo.y_off;
    float* y1bp = work + wl.y1bp;
    const int ws = round4(max(D, 2 * kC));
    float* wc = sm + geo.u_off;  // (nb, ws) the chunk's cotangent rows
    for (int s = 0; s < slots(1); ++s) {
      const Tile t = tile(1, s);
      if (t.k != 0) continue;
      float* gef = sm + geo.gef_off + 4 * s;
      const int RG = p.RG;
      const float* oc = sm + geo.owc_off + s * RG * geo.OCS;
      for (int b0 = 0; b0 < B; b0 += kChunk) {
        const int nb = min(kChunk, B - b0);
        for (int i = threadIdx.x; i < nb * D; i += blockDim.x) {
          const int b = i / D, d = i - b * D;
          wc[b * ws + d] = ld(w + (size_t)(b0 + b) * D + d);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < nb * RG; i += blockDim.x) {
          const int b = i / RG, r = i - b * RG;
          float yb = 0.0f, zt = 0.0f;
          if (r < t.rows) {
            const int j = t.o0 + r;
            const float* wr = wc + b * ws;
            const float* orow = oc + r * geo.OCS;
            float tv = 0.0f;
            for (int d = 0; d < D; ++d) tv += wr[d] * orow[d];
            const float y2 = y_at(1, b0 + b, j);
            yb = eff * tv * dsilu(y2);
            zt = silu(y2) * tv;
          }
          Y[i] = yb;
          S[i] = zt;  // z t, for geff below
        }
        __syncthreads();
        if (t.cc == 0 && threadIdx.x < 32) {
          // the chunk's z t in a fixed order: lane-strided, then a tree
          float acc = 0.0f;
          for (int i = threadIdx.x; i < nb * RG; i += 32) acc += S[i];
          acc = warp_sum(acc);
          if (threadIdx.x == 0) gef[0] += acc;
        }
        float* y1c = sm + geo.m_off;  // the chunk's y1 (b, c), MS apart
        inputs23(1, t, b0, nb, X, y1c);  // its barrier orders S's reads
        grad_tile(p, t.gr, Y, X, nb, 1.0f);
        input_bar(p, t, Y, nb, S);
        const int rg = t.rg;
        for (int i = threadIdx.x; i < nb * t.cols; i += blockDim.x) {
          const int b = i / t.cols, c = i - b * t.cols, col = t.c0 + c;
          const float v = kan_bar(y1c[b * geo.MS + c], t.kn + c * kNK,
                                  S + b * p.KP + c * kF);
          y1bp[((size_t)rg * B + b0 + b) * H + col] = v;
        }
        __syncthreads();
      }
    }
    const Plan& p3 = plan(2);
    for (int s = 0; s < slots(2); ++s) {
      const Tile t = tile(2, s);
      if (t.k != 0) continue;
      float* gbo = sm + geo.gbo_off + p3.RG * s;
      for (int b0 = 0; b0 < B; b0 += kChunk) {
        const int nb = min(kChunk, B - b0);
        for (int i = threadIdx.x; i < nb * p3.RG; i += blockDim.x) {
          const int b = i / p3.RG, r = i - b * p3.RG;
          Y[i] = r < t.rows ? ld(w + (size_t)(b0 + b) * D + t.o0 + r) : 0.0f;
        }
        inputs23(2, t, b0, nb, X);
        grad_tile(p3, t.gr, Y, X, nb, eff);
        if (t.cc == 0 && threadIdx.x < t.rows) {
          float acc = 0.0f;
          for (int b = 0; b < nb; ++b) acc += Y[b * p3.RG + threadIdx.x];
          gbo[threadIdx.x] += eff * acc;
        }
        __syncthreads();
      }
    }
  }

  // Layer 1's backward over the block's tiles: y1bar of the tile's rows
  // (its NR2 partials in order), the gradients, and, through the mixer,
  // zb = phibar 2 phi (1 - phi) s1 (1 - s1): ga += zb (x - b), gb += -zb a
  // (running sums a column), and each feature's sum over its K bases
  // sum_k zb a, a partial a row group (b, d, rg).
  template <class UF>
  __device__ void back1(const UF& uf) const {
    const Plan& p = plan(0);
    float* X = sm + geo.x_off;
    float* S = sm + geo.s_off;
    float* Y = sm + geo.y_off;
    float* mx = sm + geo.m_off;
    const int C4 = geo.CG4, NR2 = plan(1).NR;
    for (int s = 0; s < slots(0); ++s) {
      const Tile t = tile(0, s);
      if (t.k != 0) continue;
      float* ga = sm + geo.ab_off + 2 * C4 * s;
      float* gb = ga + C4;
      for (int b0 = 0; b0 < B; b0 += kChunk) {
        const int nb = min(kChunk, B - b0);
        for (int i = threadIdx.x; i < nb * p.RG; i += blockDim.x) {
          const int b = i / p.RG, r = i - b * p.RG;
          Y[i] = r < t.rows
                     ? ordered_sum<kSum>(work + wl.y1bp +
                                             (size_t)(b0 + b) * H + t.o0 + r,
                                         NR2, (size_t)B * H)
                     : 0.0f;
        }
        inputs1(uf, t, b0, nb, X);  // its barriers order Y's writes
        grad_tile(p, t.gr, Y, X, nb, 1.0f);
        input_bar(p, t, Y, nb, S);
        // zb into the mixer's phi slot (x stays for ga).
        for (int i = threadIdx.x; i < nb * t.cols; i += blockDim.x) {
          const int b = i / t.cols, c = i - b * t.cols;
          const float ph = mx[(kChunk + b) * C4 + c];
          const float s1 = mx[(2 * kChunk + b) * C4 + c];
          const float pb = kan_bar(ph, t.kn + c * kNK, S + b * p.KP + c * kF);
          mx[(kChunk + b) * C4 + c] =
              pb * (2.0f * ph * (1.0f - ph)) * (s1 * (1.0f - s1));
        }
        __syncthreads();
        for (int c = threadIdx.x; c < t.cols; c += blockDim.x) {
          float sa = 0.0f, sb = 0.0f;
          for (int b = 0; b < nb; ++b) {
            const float zv = mx[(kChunk + b) * C4 + c];
            sa += zv * (mx[b * C4 + c] - t.mb[c]);
            sb += -zv * t.ma[c];
          }
          ga[c] += sa;
          gb[c] += sb;
        }
        const int nf = cdiv(t.cols, K), d0 = t.c0 / K, rg = t.rg;
        for (int i = threadIdx.x; i < nb * nf; i += blockDim.x) {
          const int b = i / nf, f = i - b * nf;
          float hs = 0.0f;
          for (int k = 0; k < K; ++k)
            hs += mx[(kChunk + b) * C4 + f * K + k] * t.ma[f * K + k];
          work[wl.hp + ((size_t)rg * B + b0 + b) * D + d0 + f] = hs;
        }
        __syncthreads();
      }
    }
  }

  // The layer norm's backward, a warp a row over the grid: hln = (its NR1
  // partials) (1 - th^2), then ubar = rstd (xb - mean(xb) - xn mean(xb
  // xn)), xb = hln scale; the layer norm's gradients and sum_d w bo, as
  // running sums of the row.
  template <class UF>
  __device__ void back0(const UF& uf, const float* w) const {
    const int lane = lane_id(), NR1 = plan(0).NR;
    float* buf = sm + geo.u_off + (threadIdx.x >> 5) * round4(max(D, 2 * kC));
    const float inv_d = 1.0f / (float)D;
    float* glp = work + wl.glp;
    for (int b = grid_warp(); b < B; b += grid_warps()) {
      float mu, r;
      row_norm(uf, b, buf, mu, r);
      float m1 = 0.0f, m2 = 0.0f, wb = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float xn = (buf[d] - mu) * r;
        const float th = tanhf((xn * lns[d] + lnb[d]) / hbound);
        const float hl =
            ordered_sum<kSum>(work + wl.hp + (size_t)b * D + d, NR1,
                              (size_t)B * D) *
            (1.0f - th * th);
        const float xb = hl * lns[d];
        m1 += xb;
        m2 += xb * xn;
        glp[b * D + d] += hl * xn;
        glp[(size_t)B * D + b * D + d] += hl;
        wb += ld(w + (size_t)b * D + d) * ob[d];
        buf[d] = xn;
      }
      m1 = warp_sum(m1) * inv_d;
      m2 = warp_sum(m2) * inv_d;
      wb = warp_sum(wb);
      if (lane == 0) work[wl.wbo + b] += wb;
      for (int d = lane; d < D; d += 32) {
        const float hl = ordered_sum<kSum>(work + wl.hp + (size_t)b * D + d,
                                           NR1, (size_t)B * D);
        const float xn = buf[d];
        const float th = tanhf((xn * lns[d] + lnb[d]) / hbound);
        const float xb = hl * (1.0f - th * th) * lns[d];
        work[wl.ubar + b * D + d] = r * (xb - m1 - xn * m2);
      }
    }
  }

  // The VJP of stage j at its recorded input, cotangent in.w; ubar left in
  // its buffer for take_ub.
  __device__ void vjp_stage(const VjpIn& in) const {
    const auto uf = [&](int e) { return record_input(in, e); };
    cg::grid_group grid = cg::this_grid();
    forward(uf, false);
    grid.sync();
    if (geo.rows) {
      fin_phase(1);
      grid.sync();
    }
    back2(in.w);
    grid.sync();
    back1(uf);
    grid.sync();
    back0(uf, in.w);
  }

  __device__ __forceinline__ float take_ub(int e, const VjpIn&) const {
    return ld(work + wl.ubar + e);
  }

  // The end of the backward: each tile's gradients from shared memory to
  // their outputs, the running sums to their partials; then, after a grid
  // barrier, ga, gb, the layer norm's gradients and geff, each the sum of
  // its partials in order.
  __device__ void store() const {
    for (int ly = 0; ly < 3; ++ly) {
      const Plan& p = plan(ly);
      for (int s = 0; s < slots(ly); ++s) {
        const Tile t = tile(ly, s);
        if (t.k != 0) continue;
        for (int e = threadIdx.x; e < geo.tsz[ly]; e += blockDim.x) {
          const int r = e / p.SW, ck = e - r * p.SW;
          const int c = ck / p.F, k = ck - c * p.F;
          float* dst = ck < p.CG * p.F ? gparam(ly, t, r, c, k) : nullptr;
          if (dst) *dst = t.gr[e];
        }
      }
    }
    const int C4 = geo.CG4;
    for (int s = 0; s < slots(0); ++s) {
      const Tile t = tile(0, s);
      if (t.k != 0) continue;
      const float* ga = sm + geo.ab_off + 2 * C4 * s;
      float* abp = work + wl.abp;
      for (int c = threadIdx.x; c < t.cols; c += blockDim.x) {
        abp[(size_t)t.rg * L + t.c0 + c] = ga[c];
        abp[((size_t)plan(0).NR + t.rg) * L + t.c0 + c] = ga[C4 + c];
      }
    }
    for (int s = 0; s < slots(1); ++s) {
      const Tile t = tile(1, s);
      if (t.k == 0 && t.cc == 0 && threadIdx.x == 0)
        work[wl.gep + t.rg] = sm[geo.gef_off + 4 * s];
    }
    for (int s = 0; s < slots(2); ++s) {
      const Tile t = tile(2, s);
      if (t.k == 0 && t.cc == 0 && threadIdx.x < t.rows)
        g[9][t.o0 + threadIdx.x] = sm[geo.gbo_off + plan(2).RG * s +
                                      threadIdx.x];
    }
    cg::this_grid().sync();
    const int NR1 = plan(0).NR, NR2 = plan(1).NR;
    const float* abp = work + wl.abp;
    const float* glp = work + wl.glp;
    for (int e = grid_tid(); e < 2 * L + 2 * D + 1; e += grid_threads()) {
      float s = 0.0f;
      if (e < 2 * L) {
        const int which = e / L, l = e - which * L;
        for (int rg = 0; rg < NR1; ++rg)
          s += ld(abp + ((size_t)which * NR1 + rg) * L + l);
        g[2 + which][l] = s;
      } else if (e < 2 * L + 2 * D) {
        const int which = (e - 2 * L) / D, d = e - 2 * L - which * D;
        for (int b = 0; b < B; ++b)
          s += ld(glp + (size_t)which * B * D + b * D + d);
        g[which][d] = s;
      } else {
        for (int rg = 0; rg < NR2; ++rg) s += ld(work + wl.gep + rg);
        for (int b = 0; b < B; ++b) s += ld(work + wl.wbo + b);
        g[10][0] = s;
      }
    }
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

// The field lives in the block's shared memory, not in each thread's
// registers and stack: its calls that do not inline (the scaffold calls
// stage() and vjp_stage() from several places) take its address, and a
// thread's copy would then sit in local memory and be read from there in
// every loop.
__device__ __forceinline__ void bind_field(MlpField& f, const MlpField& a,
                                           float* smem) {
  if (threadIdx.x == 0) {
    f = a;
    f.sm = smem;
    f.eff = __ldg(a.effp);
  }
  __syncthreads();
}

template <bool kRecord>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    mlp_node_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ MlpField f;
  bind_field(f, a.f, smem);
  f.load();
  __syncthreads();
  adaptive_solve_final<kRecord>(f, a.s);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    mlp_node_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ MlpField f;
  bind_field(f, a.f, smem);
  f.load();
  float* glp = f.work + f.wl.glp;
  for (size_t i = grid_tid(); i < 2 * (size_t)f.B * f.D + f.B;
       i += grid_threads())
    glp[i] = 0.0f;  // the layer-norm partials and sum_d w bo, a row each
  cg::this_grid().sync();
  adjoint_replay(f, a.r);
  cg::this_grid().sync();
  f.store();
}

MlpField make_field(const float* const* w, float* work, int B, int D, int K,
                    int H, float hbound, bool bwd, int form) {
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
  f.effp = w[12];
  f.B = B;
  f.D = D;
  f.K = K;
  f.L = D * K;
  f.H = H;
  f.hbound = hbound;
  f.work = work;
  f.wl = work_layout(B, D, K, H, bwd, form);
  return f;
}

template <class Args>
int launch_mlp(void (*kernel)(Args), Args& args, bool bwd, int form,
               cudaStream_t stream) {
  const MlpField& f = args.f;
  return launch_grid(kernel, args, [&](int G) {
    args.f.geo = make_geo(G, f.D, f.K, f.H, bwd, form);
    return (size_t)args.f.geo.smem_floats * sizeof(float);
  }, kMaxDynamicSmem, stream);
}

}  // namespace

// The tile plan of one layer (O outputs, I inputs, F coefficients, CG
// columns a tile) for G blocks: out[0..8] = RG, CG, NR, NC, tiles, copies
// a block holds at most, KP, SW, replicas.
extern "C" void mlp_node_slice_plan(int G, int O, int I, int F, int RG,
                                    int CG, long long* out) {
  const Plan p = layer_plan(G, O, I, F, RG, CG);
  out[0] = p.RG;
  out[1] = p.CG;
  out[2] = p.NR;
  out[3] = p.NC;
  out[4] = p.tiles;
  out[5] = p.slots;
  out[6] = p.KP;
  out[7] = p.SW;
  out[8] = p.rep;
}

// The dynamic shared memory (floats) a block takes for G blocks.
extern "C" long long mlp_node_smem_floats(int G, int D, int K, int H, int bwd,
                                          int form) {
  return make_geo(G, D, K, H, bwd != 0, form).smem_floats;
}

// The grid the kernels take on this card, at most (SMs x kBlocksPerSM).
extern "C" int mlp_node_grid() {
  int G = 0;
  if (grid_blocks(&G, kBlocksPerSM) != 0) return -1;
  return G > kMaxBlocks ? kMaxBlocks : G;
}

extern "C" long long mlp_node_work_floats(int B, int D, int K, int H,
                                          int form) {
  return (long long)work_layout(B, D, K, H, true, form).total;
}

// h0 (B, D) and the 13 operands w (lns, lnb, a, b, g1, bw1, sw1, g2, bw2,
// sw2, W, bo, eff; shapes in MlpField) -> out (B, D) and, when record is
// nonzero, tda (M, 4), yrec (M, B, D), krec (M, 7, B, D), misc (4).  form:
// 0 the chunk form, 1 the rows form with phases.
extern "C" int mlp_node_fwd(const float* h0, const float* const* w,
                            float* out, float* tda, float* yrec, float* krec,
                            float* misc, float* work, int B, int D, int K,
                            int H, int max_steps, float rtol, float atol,
                            float h_bound, int record, int form,
                            void* stream) {
  if (B <= 0) return 0;
  FwdArgs a{};
  a.f = make_field(w, work, B, D, K, H, h_bound, false, form);
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
  a.s.part = work + a.f.wl.part;
  a.s.N = (int)N;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_mlp(mlp_node_fwd_kernel<true>, a, false, form, s)
                : launch_mlp(mlp_node_fwd_kernel<false>, a, false, form, s);
}

// hbar (B, D), the forward's records and the 13 operands -> the 11
// gradients g (of all operands but the two grids, shaped as they are) and
// h0bar (B, D).
extern "C" int mlp_node_bwd(const float* hbar, const float* tda,
                            const float* yrec, const float* krec,
                            const float* misc, const float* const* w,
                            float* const* g, float* h0bar, float* work,
                            int B, int D, int K, int H, float h_bound,
                            int form, void* stream) {
  if (B <= 0) return 0;
  BwdArgs a{};
  a.f = make_field(w, work, B, D, K, H, h_bound, true, form);
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
  return launch_mlp(mlp_node_bwd_kernel, a, true, form,
                    static_cast<cudaStream_t>(stream));
}
