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
// at theta = 1 is y1).
//
// The field never mixes rows: row b of f reads row b of z and the table
// rows i0 B + b and (i0 + 1) B + b alone.  So the solve runs under
// node_common.cuh's row policy (RowSync), as B.7's csrc/ode_dyn.cu: up to
// 64 rows one thread-block cluster of G <= 16 CTAs of 512 threads, CTA g
// owning the batch rows [g R, min(B, (g + 1) R)), R = ceil(B / 16); past
// them a cooperative grid of G = ceil(B / R) such CTAs, R = max(4,
// ceil(B / 128)), their error-norm partials meeting in device memory
// behind one grid barrier (ops/node_enc.py: row_plan).  16 CTAs owning 12
// or 16 rows each would keep those rows in device memory and most SMs
// idle; more SMs, each with 4 rows beside its weights, take those batches
// in about the time of 64.  An evaluation or a VJP synchronises only the
// CTA; the one exchange is the error norm's sum, once an attempt.
//
// The weights do not fit one CTA: w1z, w1x, W2 and W3 are 4 x 128 x 128
// floats, 256 KB, against 227 KB.  w1z and W2 stay in each CTA's shared
// memory for the whole launch, and W3 too in the forward and where the
// backward's rows fit beside it (no pad columns: each row's float4 groups
// are permuted by the row mod 8, the Swizzled layout of row_products.cuh,
// so the products' loads still cover the 32 banks once); the backward
// otherwise reads W3, once a VJP, down its columns from device memory.
// w1x is read through L2 from the CTA's own copies in device memory: the
// forward's x(t) product down the columns of its transpose (a warp's
// lanes on consecutive outputs, 128-byte loads; a row-major w1x read by
// rows cost twice a shared-memory product), the VJP's x(t) cotangent
// down the columns of w1x, 64 KB each a CTA.  The rows (state, stages,
// the row records below) sit beside the weights at every batch the
// conditional-diffusion path gives (row_plan says where they go past 4 a
// CTA: with the weights, to device memory the CTA owns).
//
// Products: row_products.cuh's product_rows / product_cols, B.7's, 4 rows
// a pass, each weight read once for the 4, every sum in a fixed order set
// by the widths, so a row gives the same bits alone and in any batch.
// Field evaluation: a warp a row forms LN(z) (two passes, a fixed shuffle
// tree) and x(t); then h1 (the two blocks' sums added, then b1), h2, f.
// VJP with cotangent w (B, C): the hidden layers again, keeping the
// pre-activations, then
//   g2 = (w W3) silu'(h2p),  g1 = (g2 W2) silu'(h1p),
//   gxt = g1 w1x, added as (1 - w) gxt to table row i0 B + b and w gxt to
//   row (i0 + 1) B + b by the CTA that owns b, in replay order,
//   gzn = g1 w1z, then the layer norm's backward a warp a row:
//   gh = gzn scale, ubar = rstd (gh - mean(gh) - yhat mean(gh yhat)),
// and the parameter gradients, outer products summed over rows and VJPs:
//   [gW3 | gb3] += w^T [h2, 1],  [gW2 | gb2] += g2^T [h1, 1],
//   [gw1z | gw1x | gb1] += g1^T [zn, x(t), 1],
// held as 4 x 4 tiles, 5 a thread in registers and the rest in the CTA's
// own partial array in device memory, and g_scale += sum_b gzn yhat,
// g_bias += sum_b gzn, a thread a column.  At the end each CTA writes its
// partials, and after one cluster (or grid) barrier every gradient is the
// sum of the G partials in rank order.  No atomics: every output, record and
// gradient is the same bits on every run.
//
// What bounds it on this card: at the encoder's widths (C = P = H = 128,
// B = 64 in training, up to 256 in serving) an evaluation is 2 B (C H +
// P H + H H + H C) = 8.4 M FLOP at B = 64, about 0.13 us of the card's
// FP32 rate; the solve takes 6 evaluations for each of its attempts.  A
// CTA's products pass its weights through the shared-memory port once an
// evaluation for each 4 of its rows (each float4 of a weight a 128-byte
// wavefront for 16 FMAs a lane: about 5 times the FMA time), and w1x
// through L2; that, the CTA barriers between the products and the
// scaffold's passes set the pace, about the same at every batch.

#include "node_common.cuh"
#include "row_products.cuh"

namespace {

using namespace node_common;
using namespace row_products;

constexpr int kRowThreads = 512;  // threads a CTA
constexpr int kTileSlots = 5;     // gradient tiles a thread holds
constexpr int kClusterRows = 4;   // rows a CTA owns, at most, in the cluster
constexpr int kMaxGrid = 128;     // CTAs of the grid form, at most
constexpr int kFwdChunks = 2;     // chunks of the forward's x(t) product
// Dynamic shared memory a CTA may take: the card's 227 KB less the static
// arrays of the scaffold's reductions.
constexpr size_t kSmemBudget = 232448 - 2048;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// The launch's geometry, the same on the host and the device.  Up to
// kMaxCluster x kClusterRows rows, one cluster of G <= 16 CTAs owning R =
// ceil(B / 16) rows each; past them (`grid`), a cooperative grid of G =
// ceil(B / R) CTAs, R = max(kClusterRows, ceil(B / kMaxGrid)).  The
// placement (w_smem: w1z, W2 and the biases; w3_smem: W3; rows_smem: the
// rows) is the first of: everything in shared memory; W3 in device memory;
// everything in device memory (past 512 rows at the encoder's widths).
struct Geo {
  int B, C, P, H, R, G, bwd, grid;
  int C4, P4, H4, SC, SH, Q;     // padded lengths, swizzled row lengths
  // Row record: [zn | x(t) 1 | a1 1 | a2 1] and, backward, [h1p | h2p | w |
  // g2 | g1 | gzn | yhat]; then [rstd].
  int off_xt, off_a1, off_a2, off_h1p, off_h2p, off_w, off_g2, off_g1,
      off_gzn, off_yh, off_sc, RS;
  int nq0, nq2, t0, t1, ntiles;  // gradient tiles (see tile())
  int w_floats, w3_floats, wx_floats, p_floats, scaf_floats, row_floats,
      mine_floats;
  int w_smem, w3_smem, rows_smem;
  long long smem_floats, work_floats;
};

Geo make_geo(int B, int C, int P, int H, bool bwd) {
  Geo g{};
  g.B = B;
  g.C = C;
  g.P = P;
  g.H = H;
  g.bwd = bwd;
  g.grid = B > kMaxCluster * kClusterRows;
  g.R = g.grid ? max(kClusterRows, cdiv(B, kMaxGrid)) : cdiv(B, kMaxCluster);
  g.G = cdiv(B, g.R);
  g.C4 = round4(C);
  g.P4 = round4(P);
  g.H4 = round4(H);
  g.SC = round32(C);
  g.SH = round32(H);
  g.Q = round4(H + 1);
  g.off_xt = g.C4;
  g.off_a1 = g.off_xt + round4(P + 1);
  g.off_a2 = g.off_a1 + g.Q;
  g.off_h1p = g.off_a2 + g.Q;
  if (bwd) {
    g.off_h2p = g.off_h1p + g.H4;
    g.off_w = g.off_h2p + g.H4;
    g.off_g2 = g.off_w + g.C4;
    g.off_g1 = g.off_g2 + g.H4;
    g.off_gzn = g.off_g1 + g.H4;
    g.off_yh = g.off_gzn + g.C4;
    g.off_sc = g.off_yh + g.C4;
  } else {
    g.off_sc = g.off_h1p;
  }
  g.RS = g.off_sc + 4;
  g.nq0 = cdiv(H + 1, 4);
  g.nq2 = cdiv(g.C4 + P + 1, 4);
  g.t0 = cdiv(C, 4) * g.nq0;
  g.t1 = g.t0 + cdiv(H, 4) * g.nq0;
  g.ntiles = g.t1 + cdiv(H, 4) * g.nq2;
  g.w_floats = g.H4 * g.SC + g.H4 * g.SH + 2 * g.H4 + 3 * g.C4;
  g.w3_floats = g.C4 * g.SH;
  g.wx_floats = g.H4 * g.P4;  // w1x and its transpose, each
  const int wide = C > P ? (C > H ? C : H) : (P > H ? P : H);
  g.p_floats = bwd ? cols_partials(wide, kRowThreads)
                   : kGroup * kFwdChunks * g.H4;
  g.scaf_floats = round4((bwd ? 10 : 9) * g.R * C);
  g.row_floats = g.scaf_floats + g.R * g.RS;
  g.mine_floats = bwd ? 16 * g.ntiles + 2 * g.C4 : 0;
  const long long budget = (long long)(kSmemBudget / sizeof(float));
  const long long w = g.w_floats, w3 = g.w3_floats;
  const long long pr = (long long)g.p_floats + g.row_floats;
  g.w_smem = g.w3_smem = g.rows_smem = 1;
  if (w + w3 + pr > budget) {
    g.w3_smem = 0;
    if (w + pr > budget) g.w_smem = g.rows_smem = 0;
  }
  g.smem_floats = g.p_floats + (g.w_smem ? g.w_floats : 0) +
                  (g.w3_smem ? g.w3_floats : 0) +
                  (g.rows_smem ? g.row_floats : 0);
  g.work_floats = (long long)g.G *
                      ((long long)2 * g.wx_floats +
                       (g.w_smem ? 0 : g.w_floats) +
                       (g.w3_smem ? 0 : g.w3_floats) +
                       (g.rows_smem ? 0 : g.row_floats) + g.mine_floats) +
                  (g.grid ? kPartFloats : 0);
  return g;
}

struct EncField {
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
  // gradients, backward only, shaped as their tensors
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
  float* work;   // device scratch: w1x's copies, owned weights / rows, partials
  Geo g;
  int L;
  // This CTA's, set by bind().
  float* WZ;    // (H4, SC) w1z, Swizzled
  float* W2s;   // (H4, SH) W2, Swizzled
  float* W3s;   // (C4, SH) W3, Swizzled
  float* WX;    // (H4, P4) w1x, Padded, in device memory
  float* WXT;   // (P4, H4) its transpose, Padded, in device memory
  float* part;  // the grid form's error-norm partials
  float* B1s;
  float* B2s;
  float* B3s;
  float* LNS;
  float* LNB;
  float* P;     // (p_floats) the column products' partial sums
  float* scaf;  // the scaffold's scratch
  float* rows;  // (R, RS) row records
  float* mine;  // (16 ntiles + 2 C4) this CTA's gradient partials
  int rank, nrows, row0;
  mutable float acc[kTileSlots][16];

  // kWS / kW3S / kRS: w1z and W2 / W3 / the rows in shared memory
  // (g.w_smem, g.w3_smem, g.rows_smem), fixed at compile time so that
  // every pointer into shared memory is known as such and its loads are
  // shared-memory loads.
  template <bool kWS, bool kW3S, bool kRS>
  __device__ void bind(float* smem) {
    rank = RowSync::rank();
    nrows = tile_rows(rank, g.R, g.B);
    row0 = tile_first(rank, g.R);
    float* s = smem;
    P = s;
    s += g.p_floats;
    float* dev = work;
    part = dev;
    dev += g.grid ? kPartFloats : 0;
    WX = dev + (size_t)rank * 2 * g.wx_floats;
    WXT = WX + g.wx_floats;
    dev += (size_t)g.G * 2 * g.wx_floats;
    float* w;
    if constexpr (kWS) {
      w = s;
      s += g.w_floats;
    } else {
      w = dev + (size_t)rank * g.w_floats;
      dev += (size_t)g.G * g.w_floats;
    }
    if constexpr (kW3S) {
      W3s = s;
      s += g.w3_floats;
    } else {
      W3s = dev + (size_t)rank * g.w3_floats;
      dev += (size_t)g.G * g.w3_floats;
    }
    WZ = w;
    W2s = WZ + g.H4 * g.SC;
    B1s = W2s + g.H4 * g.SH;
    B2s = B1s + g.H4;
    B3s = B2s + g.H4;
    LNS = B3s + g.C4;
    LNB = LNS + g.C4;
    float* r;
    if constexpr (kRS) {
      r = s;
    } else {
      r = dev + (size_t)rank * g.row_floats;
      dev += (size_t)g.G * g.row_floats;
    }
    scaf = r;
    rows = r + g.scaf_floats;
    mine = dev + (size_t)rank * g.mine_floats;
  }

  // The weights into their places and the rows' constant entries.
  __device__ void load() const {
    const int t = threadIdx.x, nth = blockDim.x, C = g.C, P_ = g.P, H = g.H;
    pad_copy(WZ, Swizzled{g.SC}, w1z, g.H4, H, C, g.SC);
    pad_copy(W2s, Swizzled{g.SH}, w2, g.H4, H, H, g.SH);
    pad_copy(W3s, Swizzled{g.SH}, w3, g.C4, C, H, g.SH);
    pad_copy(WX, Padded{g.P4}, w1x, g.H4, H, P_, g.P4);
    for (int i = t; i < g.P4 * g.H4; i += nth) {
      const int p = i / g.H4, h = i - p * g.H4;
      WXT[i] = p < P_ && h < H ? __ldg(w1x + (size_t)h * P_ + p) : 0.0f;
    }
    for (int i = t; i < g.H4; i += nth) {
      B1s[i] = i < H ? b1[i] : 0.0f;
      B2s[i] = i < H ? b2[i] : 0.0f;
    }
    for (int i = t; i < g.C4; i += nth) {
      B3s[i] = i < C ? b3[i] : 0.0f;
      LNS[i] = i < C ? lns[i] : 0.0f;
      LNB[i] = i < C ? lnb[i] : 0.0f;
    }
    for (int i = t; i < g.R * g.RS; i += nth) {
      const int c = i % g.RS;
      rows[i] = (c == g.off_xt + P_ || c == g.off_a1 + H ||
                 c == g.off_a2 + H) ? 1.0f : 0.0f;
    }
  }

  // The first bracketing table row and the lerp weight of time t.
  __device__ void signal_rows(float t, int& i0, float& w) const {
    const float tf = fminf(fmaxf(t, 0.0f), 1.0f) * (float)(L - 1);
    int i = (int)floorf(tf);
    i = i < 0 ? 0 : (i > L - 2 ? L - 2 : i);
    i0 = i;
    w = tf - (float)i;
  }

  // zn (and, backward, yhat and rstd) and x(t) of the rows' states u at
  // time t, then h1 and h2 (backward: with their pre-activations).
  __device__ __forceinline__ void hidden(const float* u, float t) const {
    const int C = g.C, P_ = g.P, RS = g.RS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const bool bwd = g.bwd;
    int i0;
    float wl;
    signal_rows(t, i0, wl);
    const float inv_c = 1.0f / (float)C;
    for (int b = warp; b < nrows; b += nw) {
      const float* urow = u + b * C;
      float* rec = rows + b * RS;
      float s = 0.0f;
      for (int c = lane; c < C; c += 32) s += urow[c];
      const float mu = warp_sum(s) * inv_c;
      float v = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float d = urow[c] - mu;
        v += d * d;
      }
      const float r = 1.0f / sqrtf(warp_sum(v) * inv_c + kLnEps);
      for (int c = lane; c < C; c += 32) {
        const float yh = (urow[c] - mu) * r;
        rec[c] = yh * LNS[c] + LNB[c];
        if (bwd) rec[g.off_yh + c] = yh;
      }
      if (bwd && lane == 0) rec[g.off_sc] = r;
      const float* x0 = xtab + ((size_t)i0 * g.B + row0 + b) * P_;
      const float* x1 = x0 + (size_t)g.B * P_;
      for (int p = lane; p < P_; p += 32)
        rec[g.off_xt + p] = x0[p] + wl * (x1[p] - x0[p]);
    }
    __syncthreads();
    float* recs = rows;
    const int oa1 = g.off_a1, oa2 = g.off_a2, oh1 = g.off_h1p;
    const int oh2 = g.off_h2p;
    const float* B1_ = B1s;
    const float* B2_ = B2s;
    // h1: the LN(z) block's sums parked in a2's slot, then the x(t)
    // block's added to them, then b1.  The x(t) block reads w1x's
    // transpose in device memory down its columns, a warp's lanes on
    // consecutive outputs (128-byte loads), kFwdChunks chunks in the
    // forward (its partials' room) and every warp's in the backward.
    product_rows(recs, RS, nrows, WZ, Swizzled{g.SC}, g.C4, g.H,
                 [=](int b, int o, float s) { recs[b * RS + oa2 + o] = s; });
    product_cols<4>(recs + g.off_xt, RS, nrows, WXT, Padded{g.H4}, g.P4, g.H,
                    P, [=](int b, int o, float s) {
      const float h = (recs[b * RS + oa2 + o] + s) + B1_[o];
      if (bwd) recs[b * RS + oh1 + o] = h;
      recs[b * RS + oa1 + o] = silu(h);
    }, bwd ? 1 << 30 : kFwdChunks);
    product_rows(recs + oa1, RS, nrows, W2s, Swizzled{g.SH}, g.H4, g.H,
                 [=](int b, int o, float s) {
      const float h = s + B2_[o];
      if (bwd) recs[b * RS + oh2 + o] = h;
      recs[b * RS + oa2 + o] = silu(h);
    });
  }

  __device__ __forceinline__ void eval(const float* u, float t,
                                       float* out) const {
    hidden(u, t);
    const int C = g.C;
    const float* B3_ = B3s;
    product_rows(rows + g.off_a2, g.RS, nrows, W3s, Swizzled{g.SH}, g.H4, C,
                 [=](int b, int o, float s) { out[b * C + o] = s + B3_[o]; });
  }

  __device__ __forceinline__ void vjp(const float* u, float t, const float* w,
                                      float* ubar) const {
    const int C = g.C, P_ = g.P, RS = g.RS, B = g.B;
    float* recs = rows;
    for (int i = threadIdx.x; i < nrows * C; i += blockDim.x) {
      const int b = i / C, o = i - b * C;
      recs[b * RS + g.off_w + o] = w[i];
    }
    hidden(u, t);  // its first barrier orders the copy above
    const int oh1 = g.off_h1p, oh2 = g.off_h2p, og2 = g.off_g2, og1 = g.off_g1;
    const int ogz = g.off_gzn;
    product_cols(recs + g.off_w, RS, nrows, W3s, Swizzled{g.SH}, g.C4, g.H, P,
                 [=](int b, int j, float s) {
      recs[b * RS + og2 + j] = s * dsilu(recs[b * RS + oh2 + j]);
    });
    product_cols(recs + og2, RS, nrows, W2s, Swizzled{g.SH}, g.H4, g.H, P,
                 [=](int b, int k, float s) {
      recs[b * RS + og1 + k] = s * dsilu(recs[b * RS + oh1 + k]);
    });
    int i0;
    float wl;
    signal_rows(t, i0, wl);
    float* gx = gxtab + ((size_t)i0 * B + row0) * P_;
    const size_t next = (size_t)B * P_;
    product_cols<4>(recs + og1, RS, nrows, WX, Padded{g.P4}, g.H4, P_, P,
                    [=](int b, int p, float s) {
      float* r0 = gx + (size_t)b * P_ + p;
      r0[0] += (1.0f - wl) * s;
      r0[next] += wl * s;
    });
    product_cols(recs + og1, RS, nrows, WZ, Swizzled{g.SC}, g.H4, C, P,
                 [=](int b, int c, float s) { recs[b * RS + ogz + c] = s; });
    // The layer norm: its scale and bias gradients, a thread a column;
    // then ubar, a warp a row.
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float ss = 0.0f, sb = 0.0f;
      for (int b = 0; b < nrows; ++b) {
        const float gz = recs[b * RS + ogz + c];
        ss += gz * recs[b * RS + g.off_yh + c];
        sb += gz;
      }
      float* m = mine + 16 * (size_t)g.ntiles;
      m[c] += ss;
      m[g.C4 + c] += sb;
    }
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    const float inv_c = 1.0f / (float)C;
    for (int b = threadIdx.x >> 5; b < nrows; b += nw) {
      const float* rec = recs + b * RS;
      float m1 = 0.0f, m2 = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float gh = rec[ogz + c] * LNS[c];
        m1 += gh;
        m2 += gh * rec[g.off_yh + c];
      }
      m1 = warp_sum(m1) * inv_c;
      m2 = warp_sum(m2) * inv_c;
      const float r = rec[g.off_sc];
      for (int c = lane; c < C; c += 32) {
        const float gh = rec[ogz + c] * LNS[c];
        ubar[b * C + c] = r * (gh - m1 - rec[g.off_yh + c] * m2);
      }
    }
    grad_tiles();
  }

  // The row offsets of tile t's a and c vectors: w (x) [a2, 1], g2 (x)
  // [a1, 1], g1 (x) [zn, x(t), 1], each p-major with q fastest.
  __device__ __forceinline__ void tile_offsets(int t, int& ao, int& co) const {
    int m = 0, nq = g.nq0;
    if (t >= g.t1) {
      m = 2;
      t -= g.t1;
      nq = g.nq2;
    } else if (t >= g.t0) {
      m = 1;
      t -= g.t0;
    }
    const int p = 4 * (t / nq), q = 4 * (t % nq);
    ao = (m == 0 ? g.off_w : m == 1 ? g.off_g2 : g.off_g1) + p;
    co = (m == 0 ? g.off_a2 : m == 1 ? g.off_a1 : 0) + q;
  }

  // acc += a (x) c over the CTA's rows, for each owned tile.
  __device__ __forceinline__ void grad_tiles() const {
    const int nth = blockDim.x, RS = g.RS;
#pragma unroll
    for (int sl = 0; sl < kTileSlots; ++sl) {
      const int t = threadIdx.x + sl * nth;
      if (t >= g.ntiles) break;
      int ao, co;
      tile_offsets(t, ao, co);
      for (int b = 0; b < nrows; ++b) {
        const float4 a = *reinterpret_cast<const float4*>(rows + b * RS + ao);
        const float4 c = *reinterpret_cast<const float4*>(rows + b * RS + co);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[sl][4 * p + q] = fmaf(av[p], cv[q], acc[sl][4 * p + q]);
      }
    }
    for (int t = threadIdx.x + kTileSlots * nth; t < g.ntiles; t += nth) {
      int ao, co;
      tile_offsets(t, ao, co);
      float4* m = reinterpret_cast<float4*>(mine + 16 * (size_t)t);
      float mv[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = m[k];
        mv[4 * k] = v.x;
        mv[4 * k + 1] = v.y;
        mv[4 * k + 2] = v.z;
        mv[4 * k + 3] = v.w;
      }
      for (int b = 0; b < nrows; ++b) {
        const float4 a = *reinterpret_cast<const float4*>(rows + b * RS + ao);
        const float4 c = *reinterpret_cast<const float4*>(rows + b * RS + co);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mv[4 * p + q] = fmaf(av[p], cv[q], mv[4 * p + q]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m[k] = make_float4(mv[4 * k], mv[4 * k + 1], mv[4 * k + 2],
                           mv[4 * k + 3]);
    }
  }

  // The gradients zeroed: the register tiles, this CTA's partial array and
  // its rows of the table's gradient.
  __device__ void zero_grads() const {
#pragma unroll
    for (int sl = 0; sl < kTileSlots; ++sl)
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[sl][k] = 0.0f;
    for (int i = threadIdx.x; i < g.mine_floats; i += blockDim.x)
      mine[i] = 0.0f;
    const int P_ = g.P;
    for (int i = threadIdx.x; i < L * nrows * P_; i += blockDim.x) {
      const int l = i / (nrows * P_), r = i - l * nrows * P_;
      gxtab[((size_t)l * g.B + row0) * P_ + r] = 0.0f;
    }
  }

  // Each CTA's partials to device memory, one cluster barrier, then each
  // gradient the sum of the G partials in rank order.
  __device__ void reduce_grads() const {
    const int nth = blockDim.x, C = g.C, P_ = g.P, H = g.H;
#pragma unroll
    for (int sl = 0; sl < kTileSlots; ++sl) {
      const int t = threadIdx.x + sl * nth;
      if (t >= g.ntiles) break;
#pragma unroll
      for (int k = 0; k < 16; ++k) mine[16 * (size_t)t + k] = acc[sl][k];
    }
    if (g.grid) cg::this_grid().sync(); else cg::this_cluster().sync();
    const float* all = mine - (size_t)rank * g.mine_floats;
    const int n0 = C * (H + 1), n1 = n0 + H * (H + 1);
    const int n2 = n1 + H * (C + P_ + 1), total = n2 + 2 * C;
    for (int e = rank * nth + threadIdx.x; e < total; e += g.G * nth) {
      size_t k;
      if (e < n2) {
        int p, q, nq, t0;
        if (e < n0) {
          p = e / (H + 1);
          q = e - p * (H + 1);
          nq = g.nq0;
          t0 = 0;
        } else if (e < n1) {
          p = (e - n0) / (H + 1);
          q = (e - n0) - p * (H + 1);
          nq = g.nq0;
          t0 = g.t0;
        } else {
          p = (e - n1) / (C + P_ + 1);
          q = (e - n1) - p * (C + P_ + 1);
          if (q >= C) q += g.C4 - C;  // x(t) and the 1 follow zn's pad
          nq = g.nq2;
          t0 = g.t1;
        }
        const int t = t0 + (p >> 2) * nq + (q >> 2);
        k = 16 * (size_t)t + 4 * (p & 3) + (q & 3);
      } else {
        const int c = e - n2;
        k = 16 * (size_t)g.ntiles + (c < C ? c : g.C4 + c - C);
      }
      float s = 0.0f;
      for (int r = 0; r < g.G; ++r)
        s += __ldcg(all + (size_t)r * g.mine_floats + k);
      if (e < n0) {
        const int p = e / (H + 1), q = e - p * (H + 1);
        if (q < H) gw3[p * H + q] = s; else gb3[p] = s;
      } else if (e < n1) {
        const int p = (e - n0) / (H + 1), q = (e - n0) - p * (H + 1);
        if (q < H) gw2[p * H + q] = s; else gb2[p] = s;
      } else if (e < n2) {
        const int p = (e - n1) / (C + P_ + 1), q = (e - n1) - p * (C + P_ + 1);
        if (q < C) gw1z[p * C + q] = s;
        else if (q < C + P_) gw1x[p * P_ + q - C] = s;
        else gb1[p] = s;
      } else {
        const int c = e - n2;
        if (c < C) glns[c] = s; else glnb[c - C] = s;
      }
    }
  }
};

struct FwdArgs {
  EncField f;
  SolveBufs s;
};

struct BwdArgs {
  EncField f;
  ReplayBufs r;
};

template <bool kRecord, bool kWS, bool kW3S, bool kRS>
__global__ void __launch_bounds__(kRowThreads, 1)
    node_enc_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  EncField f = a.f;
  f.bind<kWS, kW3S, kRS>(smem);
  f.load();
  __syncthreads();
  SolveBufs s = a.s;
  s.part = f.part;
  const int n = f.g.R * f.g.C;
  s.y = f.scaf;
  s.ks = f.scaf + n;
  s.u = f.scaf + 8 * n;
  adaptive_solve_traj<kRecord, RowSync>(f, s);
}

template <bool kWS, bool kW3S, bool kRS>
__global__ void __launch_bounds__(kRowThreads, 1)
    node_enc_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  EncField f = a.f;
  f.bind<kWS, kW3S, kRS>(smem);
  f.load();
  f.zero_grads();
  __syncthreads();
  ReplayBufs r = a.r;
  const int n = f.g.R * f.g.C;
  r.lam = f.scaf;
  r.kbar = f.scaf + n;
  r.u = f.scaf + 8 * n;
  r.ub = f.scaf + 9 * n;
  adjoint_replay_traj<RowSync>(f, r);
  __syncthreads();
  f.reduce_grads();
}

EncField make_field(const float* xtab, const float* const* w, float* work,
                    const Geo& g, int L) {
  EncField f{};
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
  f.work = work;
  f.g = g;
  f.L = L;
  return f;
}

// Launches kernel(args) as one cluster of g.G CTAs of kRowThreads threads
// with g.smem_floats floats of dynamic shared memory each, or as the grid
// form's cooperative grid.
template <class Args>
int launch_rows(void (*kernel)(Args), Args& args, const Geo& g,
                cudaStream_t stream) {
  const size_t bytes = (size_t)g.smem_floats * sizeof(float);
  if (g.grid)
    return launch_row_grid(kernel, args, g.G, kRowThreads, bytes,
                           kSmemBudget, stream);
  return launch_cluster(kernel, args, g.G, kRowThreads, bytes, kSmemBudget,
                        stream);
}

// The kernel of the plan's placement: (w_smem, w3_smem, rows_smem) =
// (1, 1, 1), (1, 0, 1) or (0, 0, 0).
template <template <bool, bool, bool> class K, class Args>
int launch_placed(Args& args, const Geo& g, cudaStream_t stream) {
  if (g.w3_smem) return launch_rows(K<true, true, true>::get(), args, g, stream);
  if (g.rows_smem)
    return launch_rows(K<true, false, true>::get(), args, g, stream);
  return launch_rows(K<false, false, false>::get(), args, g, stream);
}

template <bool kRecord>
struct Fwd {
  template <bool kWS, bool kW3S, bool kRS>
  struct K {
    static void (*get())(FwdArgs) {
      return node_enc_fwd_kernel<kRecord, kWS, kW3S, kRS>;
    }
  };
};

template <bool kWS, bool kW3S, bool kRS>
struct Bwd {
  static void (*get())(BwdArgs) { return node_enc_bwd_kernel<kWS, kW3S, kRS>; }
};

}  // namespace

// The plan of a launch at batch B, widths C, P, H (bwd: the backward's):
// out[0..12] = G, R, dynamic shared-memory bytes, rows in shared memory
// (0/1), w1z and W2 in shared memory (0/1), device scratch floats,
// gradient tiles, threads a CTA, tiles a thread holds in registers, the
// row record's floats, w1x's floats a CTA in device memory (and its
// transpose's), W3 in shared memory (0/1), the grid form (0/1).
extern "C" void node_enc_plan(int B, int C, int P, int H, int bwd,
                              long long* out) {
  const Geo g = make_geo(B, C, P, H, bwd != 0);
  out[0] = g.G;
  out[1] = g.R;
  out[2] = g.smem_floats * (long long)sizeof(float);
  out[3] = g.rows_smem;
  out[4] = g.w_smem;
  out[5] = g.work_floats;
  out[6] = g.ntiles;
  out[7] = kRowThreads;
  out[8] = kTileSlots;
  out[9] = g.RS;
  out[10] = g.wx_floats;
  out[11] = g.w3_smem;
  out[12] = g.grid;
}

extern "C" long long node_enc_work_floats(int B, int C, int P, int H) {
  const long long f = make_geo(B, C, P, H, false).work_floats;
  const long long b = make_geo(B, C, P, H, true).work_floats;
  return f > b ? f : b;
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
  const Geo g = make_geo(B, C, P, H, false);
  FwdArgs a{};
  a.f = make_field(xtab, w, work, g, L);
  a.s.h0 = z0;
  a.s.out = out;
  a.s.ts = ts;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.part = nullptr;
  a.s.N = B * C;
  a.s.T = 2;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  a.s.D = C;
  a.s.R = g.R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_placed<Fwd<true>::K>(a, g, s)
                : launch_placed<Fwd<false>::K>(a, g, s);
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
  const Geo g = make_geo(B, C, P, H, true);
  BwdArgs a{};
  a.f = make_field(xtab, w, work, g, L);
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
  a.r.hbar = ybar;
  a.r.ts = ts;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = z0bar;
  a.r.N = B * C;
  a.r.T = 2;
  a.r.D = C;
  a.r.R = g.R;
  return launch_placed<Bwd>(a, g, static_cast<cudaStream_t>(stream));
}
