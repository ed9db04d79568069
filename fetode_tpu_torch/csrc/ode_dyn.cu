// Whole-solve kernels of the forecasters' latent ODE field for Hopper
// (sm_90a): the forward dopri5 trajectory solve over [ts[0], ts[T-1]]
// with CONTD5 dense output at the T requested times (with or without
// per-attempt records) and the reverse replay, the discrete adjoint on
// the recorded step mesh with the dense-output cotangents injected.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_ode_dyn.py:143
// (make_ode_dyn_solver; forward _make_fwd_kernel :50, backward
// _make_bwd_kernel :78).  The field, with the first layer's weight W0
// (H, D+1) holding the state block and then the time column (:130-139):
//
//   h1  = tanh([z, t] W0^T + b0)      (B, H)
//   h2  = tanh(h1 W1^T + b1)          (B, H)
//   f   = h2 W2^T + b2                (B, D)
//
// The field never mixes rows: row b of f reads row b of z alone.  So the
// solve runs under node_common.cuh's row policy (RowSync): one
// thread-block cluster of C <= 16 CTAs, CTA c owning the batch rows
// [c R, min(B, (c + 1) R)), R = ceil(B / 16) (ops/ode_dyn.py: row_plan).
// Each CTA holds the weights in its shared memory for the whole launch,
// padded (below), and its rows' state, stages and activations; an
// evaluation or a VJP synchronises only the CTA.  The one exchange is the
// error norm's sum, once an attempt (twice in Hairer's initial step): the
// CTAs' partials meet through distributed shared memory in rank order.
// The backward has no exchange until its end.
//
// Products.  Each layer is a product of the CTA's rows with a weight in
// shared memory, in FP32 FMAs (no tensor cores, no TF32), 4 rows a pass,
// each weight read once for the 4.  The forward's products read W
// row-major (a weight row's 16-byte loads, the row stride 4 mod 32 words,
// so 8 rows' loads hit distinct banks): a quarter-warp holds 8 outputs
// and the 4 quarters 4 chunks of the contraction, added in a fixed
// shuffle tree (row_products.cuh: product_rows, shared with B.8).  The
// VJP's transposed products read the same arrays down a column, lanes on
// consecutive outputs, 2 a lane; their chunks are split over warps and
// added in order through shared memory (product_cols).  Every sum thus
// has a fixed owner and a fixed order, set by the widths alone, so a row
// gives the same bits alone and in any batch.  The VJP with cotangent w (B, D):
//   g2 = (w W2) (1 - h2^2),  g1 = (g2 W1) (1 - h1^2),  ubar = g1 W0[:, :D]
// and the parameter gradients, outer products summed over rows and VJPs:
//   [gW2 | gb2] += w^T [h2, 1],  [gW1 | gb1] += g2^T [h1, 1],
//   [gW0 | gb0] += g1^T [z, t, 1]
// held as 4 x 4 tiles in each thread's registers for the whole replay
// (kTileSlots a thread; tiles past them, at widths above the preset's,
// accumulate in the CTA's own partial array in device memory).  At the
// end each CTA writes its partials, and after one cluster barrier every
// output gradient is the sum of the C partials in rank order.  No
// atomics: the gradients are the same bits on every run.
//
// Placement (row_plan): the padded weights, the VJP's partial-sum buffer
// and the rows live in shared memory while they fit 227 KB; else the
// rows, and past that the weights too, in device memory the CTA owns.
//
// What bounds it on this card: at the forecaster's widths (D = 64, H =
// 128, B = 64 in training, up to 297 in evaluation) an evaluation is
// 2 B (D H + H H + H D) = 4.2 M FLOP at B = 64, under 0.1 us of the
// card's FP32 rate.  On 16 SMs a CTA's 4 rows are 133 K FMAs, and its
// 134 KB of weights pass the shared-memory port once: about 0.55 us
// each an evaluation.  The products' loops run at about a quarter of
// the FMA rate with 4 warps a scheduler (clock counters, PERF.md), and
// the barriers between them, the scaffold's passes and one cluster
// exchange an attempt add about as much again.

#include "node_common.cuh"
#include "row_products.cuh"

namespace {

using namespace node_common;
using namespace row_products;

constexpr int kRowThreads = 512;   // threads a CTA
constexpr int kTileSlots = 5;      // gradient tiles a thread holds
// Dynamic shared memory a CTA may take: the card's 227 KB less the static
// arrays of the scaffold's reductions.
constexpr size_t kSmemBudget = 232448 - 2048;

// The launch's geometry, the same on the host and the device.
struct Geo {
  int B, D, H, R, C;
  int K0, S0, Q1, S1, S2, H4, D4;  // padded lengths and weight strides
  int off_h1, off_h2, off_w, off_g2, off_g1, RS;  // row record
  int t0, t1, ntiles;              // gradient tile counts (see tile())
  int w_floats, p_floats, scaf_floats, row_floats;
  int w_smem, rows_smem;
  long long smem_floats, work_floats;
};

Geo make_geo(int B, int D, int H, bool bwd) {
  Geo g{};
  g.B = B;
  g.D = D;
  g.H = H;
  g.R = cdiv(B, kMaxCluster);
  g.C = cdiv(B, g.R);
  g.K0 = round4(D + 2);             // [z, t, 1]
  g.Q1 = round4(H + 1);             // [h, 1]
  g.S0 = row_stride(g.K0);
  g.S1 = row_stride(g.Q1);
  g.S2 = row_stride(g.Q1);
  g.H4 = round4(H);
  g.D4 = round4(D);
  g.off_h1 = g.K0;
  g.off_h2 = g.off_h1 + g.Q1;
  g.off_w = g.off_h2 + g.Q1;
  g.off_g2 = g.off_w + g.D4;
  g.off_g1 = g.off_g2 + g.H4;
  g.RS = bwd ? g.off_g1 + g.H4 : g.off_w;
  const int qh = cdiv(H + 1, 4), ph = cdiv(H, 4);
  g.t0 = cdiv(D, 4) * qh;
  g.t1 = g.t0 + ph * qh;
  g.ntiles = g.t1 + ph * cdiv(D + 2, 4);
  g.w_floats = g.H4 * g.S0 + g.H4 * g.S1 + g.D4 * g.S2 + 2 * g.H4 + g.D4;
  // The VJP's products' partials (product_cols): KS chunks x 4 rows x O
  // outputs, KS O at most the warps x the outputs a warp covers, or O.
  g.p_floats = bwd ? cols_partials(H > D ? H : D, kRowThreads) : 0;
  g.scaf_floats = round4((bwd ? 10 : 9) * g.R * D);
  g.row_floats = g.scaf_floats + g.R * g.RS;
  const long long all = (long long)g.w_floats + g.p_floats + g.row_floats;
  const long long budget = (long long)(kSmemBudget / sizeof(float));
  g.rows_smem = all <= budget;
  g.w_smem = g.rows_smem || (long long)g.w_floats + g.p_floats <= budget;
  g.smem_floats = g.p_floats + (g.w_smem ? g.w_floats : 0) +
                  (g.rows_smem ? g.row_floats : 0);
  g.work_floats = (long long)g.C *
                  ((g.w_smem ? 0 : g.w_floats) +
                   (g.rows_smem ? 0 : g.row_floats) +
                   (bwd ? 16LL * g.ntiles : 0));
  return g;
}

// 4 x 4 gradient tile `t` as (a offset, c offset) in the row record: the
// outer products w (x) [h2, 1], g2 (x) [h1, 1], g1 (x) [z, t, 1], tiles
// in that order, each p-major with q fastest.
struct Tile {
  int m, p, q;  // block, first p, first q
};

__host__ __device__ inline Tile tile(const Geo& g, int t) {
  const int qh = cdiv(g.H + 1, 4);
  Tile r;
  if (t < g.t0) {
    r.m = 0;
  } else if (t < g.t1) {
    r.m = 1;
    t -= g.t0;
  } else {
    r.m = 2;
    t -= g.t1;
  }
  const int nq = r.m == 2 ? cdiv(g.D + 2, 4) : qh;
  r.p = 4 * (t / nq);
  r.q = 4 * (t % nq);
  return r;
}

struct RowField {
  const float* w0;  // (H, D + 1): state block, then the time column
  const float* b0;  // (H)
  const float* w1;  // (H, H)
  const float* b1;  // (H)
  const float* w2;  // (D, H)
  const float* b2;  // (D)
  float* gw0;       // gradients, shaped as their parameters (backward)
  float* gb0;
  float* gw1;
  float* gb1;
  float* gw2;
  float* gb2;
  float* work;      // device scratch: owned weights / rows, tile partials
  Geo g;
  // This CTA's, set by bind().
  float* W0;        // (H4, S0) W0 with zero pad columns and rows
  float* W1;        // (H4, S1)
  float* W2;        // (D4, S2)
  float* B0;
  float* B1;
  float* B2;
  float* P;         // (p_floats) the VJP products' partial sums
  float* scaf;      // the scaffold's scratch
  float* rows;      // (R, RS) row records: [z t 1 | h1 1 | h2 1 | w | g2 | g1]
  float* mine;      // (ntiles, 16) this CTA's gradient partials
  int rank, nrows;
  mutable float acc[kTileSlots][16];

  // kWS / kRS: the weights / the rows in shared memory (g.w_smem,
  // g.rows_smem), fixed at compile time so that every pointer into shared
  // memory is known as such and its loads are shared-memory loads.
  template <bool kWS, bool kRS>
  __device__ void bind(float* smem) {
    rank = (int)cg::this_cluster().block_rank();
    nrows = tile_rows(rank, g.R, g.B);
    float* s = smem;
    P = s;
    s += g.p_floats;
    float* dev = work;
    float* w;
    if constexpr (kWS) {
      w = s;
      s += g.w_floats;
    } else {
      w = dev + (size_t)rank * g.w_floats;
      dev += (size_t)g.C * g.w_floats;
    }
    W0 = w;
    W1 = W0 + g.H4 * g.S0;
    W2 = W1 + g.H4 * g.S1;
    B0 = W2 + g.D4 * g.S2;
    B1 = B0 + g.H4;
    B2 = B1 + g.H4;
    float* r;
    if constexpr (kRS) {
      r = s;
    } else {
      r = dev + (size_t)rank * g.row_floats;
      dev += (size_t)g.C * g.row_floats;
    }
    scaf = r;
    rows = r + g.scaf_floats;
    mine = dev + (size_t)rank * 16 * g.ntiles;
  }

  // The padded weights and the rows' constant entries.
  __device__ void load() const {
    const int t = threadIdx.x, nth = blockDim.x, D = g.D, H = g.H;
    pad_copy(W0, Padded{g.S0}, w0, g.H4, H, D + 1, g.S0);
    pad_copy(W1, Padded{g.S1}, w1, g.H4, H, H, g.S1);
    pad_copy(W2, Padded{g.S2}, w2, g.D4, D, H, g.S2);
    for (int i = t; i < g.H4; i += nth) {
      B0[i] = i < H ? b0[i] : 0.0f;
      B1[i] = i < H ? b1[i] : 0.0f;
    }
    for (int i = t; i < g.D4; i += nth) B2[i] = i < D ? b2[i] : 0.0f;
    for (int i = t; i < g.R * g.RS; i += nth) {
      const int c = i % g.RS;
      rows[i] = (c == D + 1 || c == g.off_h1 + H || c == g.off_h2 + H)
                    ? 1.0f : 0.0f;
    }
  }

  // h1 and h2 of the rows' inputs u at time t (the row records' [z, t, 1]
  // written first).
  __device__ __forceinline__ void hidden(const float* u, float t) const {
    const int D = g.D, RS = g.RS;
    for (int i = threadIdx.x; i < nrows * (D + 1); i += blockDim.x) {
      const int b = i / (D + 1), d = i - b * (D + 1);
      rows[b * RS + d] = d < D ? u[b * D + d] : t;
    }
    __syncthreads();
    float* h1 = rows + g.off_h1;
    float* h2 = rows + g.off_h2;
    const float* B0_ = B0;
    const float* B1_ = B1;
    product_rows(rows, RS, nrows, W0, Padded{g.S0}, g.K0, g.H,
                 [=](int b, int o, float s) {
      h1[b * RS + o] = tanhf(s + B0_[o]);
    });
    product_rows(h1, RS, nrows, W1, Padded{g.S1}, g.Q1, g.H,
                 [=](int b, int o, float s) {
      h2[b * RS + o] = tanhf(s + B1_[o]);
    });
  }

  __device__ __forceinline__ void eval(const float* u, float t,
                                       float* out) const {
    hidden(u, t);
    const int D = g.D;
    const float* B2_ = B2;
    product_rows(rows + g.off_h2, g.RS, nrows, W2, Padded{g.S2}, g.Q1, D,
                 [=](int b, int o, float s) { out[b * D + o] = s + B2_[o]; });
  }

  __device__ __forceinline__ void vjp(const float* u, float t,
                                      const float* w, float* ubar) const {
    const int D = g.D, RS = g.RS;
    float* wr = rows + g.off_w;
    for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
      const int b = i / D, o = i - b * D;
      wr[b * RS + o] = w[i];
    }
    hidden(u, t);  // its first barrier orders the copy above
    const float* h1 = rows + g.off_h1;
    const float* h2 = rows + g.off_h2;
    float* g2 = rows + g.off_g2;
    float* g1 = rows + g.off_g1;
    product_cols(wr, RS, nrows, W2, Padded{g.S2}, g.D4, g.H, P,
                 [=](int b, int j, float s) {
      const float z = h2[b * RS + j];
      g2[b * RS + j] = s * (1.0f - z * z);
    });
    product_cols(g2, RS, nrows, W1, Padded{g.S1}, g.H4, g.H, P,
                 [=](int b, int k, float s) {
      const float z = h1[b * RS + k];
      g1[b * RS + k] = s * (1.0f - z * z);
    });
    product_cols(g1, RS, nrows, W0, Padded{g.S0}, g.H4, D, P,
                 [=](int b, int d, float s) { ubar[b * D + d] = s; });
    grad_tiles();
  }

  // The row offsets of tile t's a and c vectors.
  __device__ __forceinline__ void tile_offsets(int t, int& ao, int& co) const {
    const Tile tl = tile(g, t);
    ao = (tl.m == 0 ? g.off_w : tl.m == 1 ? g.off_g2 : g.off_g1) + tl.p;
    co = (tl.m == 0 ? g.off_h2 : tl.m == 1 ? g.off_h1 : 0) + tl.q;
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
      float* m = mine + 16 * (size_t)t;
      for (int b = 0; b < nrows; ++b) {
        const float* a = rows + b * RS + ao;
        const float* c = rows + b * RS + co;
        for (int p = 0; p < 4; ++p)
          for (int q = 0; q < 4; ++q)
            m[4 * p + q] = fmaf(a[p], c[q], m[4 * p + q]);
      }
    }
  }

  __device__ void zero_grads() const {
#pragma unroll
    for (int sl = 0; sl < kTileSlots; ++sl)
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[sl][k] = 0.0f;
    for (int i = threadIdx.x + 16 * kTileSlots * blockDim.x;
         i < 16 * g.ntiles; i += blockDim.x)
      mine[i] = 0.0f;
  }

  // Each CTA's partials to device memory, one cluster barrier, then each
  // gradient the sum of the C partials in rank order.
  __device__ void reduce_grads() const {
    const int nth = blockDim.x, D = g.D, H = g.H;
#pragma unroll
    for (int sl = 0; sl < kTileSlots; ++sl) {
      const int t = threadIdx.x + sl * nth;
      if (t >= g.ntiles) break;
#pragma unroll
      for (int k = 0; k < 16; ++k) mine[16 * (size_t)t + k] = acc[sl][k];
    }
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    const float* all = mine - (size_t)rank * 16 * g.ntiles;
    const int n0 = D * (H + 1), n1 = n0 + H * (H + 1);
    const int total = n1 + H * (D + 2);
    for (int e = rank * nth + threadIdx.x; e < total; e += g.C * nth) {
      int m, p, q, nq, t0;
      if (e < n0) {
        m = 0; p = e / (H + 1); q = e - p * (H + 1); nq = cdiv(H + 1, 4);
        t0 = 0;
      } else if (e < n1) {
        m = 1; p = (e - n0) / (H + 1); q = (e - n0) - p * (H + 1);
        nq = cdiv(H + 1, 4); t0 = g.t0;
      } else {
        m = 2; p = (e - n1) / (D + 2); q = (e - n1) - p * (D + 2);
        nq = cdiv(D + 2, 4); t0 = g.t1;
      }
      const int t = t0 + (p >> 2) * nq + (q >> 2);
      const size_t k = 16 * (size_t)t + 4 * (p & 3) + (q & 3);
      float s = 0.0f;
      for (int r = 0; r < g.C; ++r) s += __ldcg(all + (size_t)r * 16 * g.ntiles + k);
      if (m == 0) {
        if (q < H) gw2[p * H + q] = s; else gb2[p] = s;
      } else if (m == 1) {
        if (q < H) gw1[p * H + q] = s; else gb1[p] = s;
      } else {
        if (q <= D) gw0[p * (D + 1) + q] = s; else gb0[p] = s;
      }
    }
  }
};

struct FwdArgs {
  RowField f;
  SolveBufs s;
};

struct BwdArgs {
  RowField f;
  ReplayBufs r;
};

template <bool kRecord, bool kWS, bool kRS>
__global__ void __launch_bounds__(kRowThreads, 1)
    ode_dyn_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  RowField f = a.f;
  f.bind<kWS, kRS>(smem);
  f.load();
  __syncthreads();
  SolveBufs s = a.s;
  const int n = f.g.R * f.g.D;
  s.y = f.scaf;
  s.ks = f.scaf + n;
  s.u = f.scaf + 8 * n;
  adaptive_solve_traj<kRecord, RowSync>(f, s);
}

template <bool kWS, bool kRS>
__global__ void __launch_bounds__(kRowThreads, 1)
    ode_dyn_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  RowField f = a.f;
  f.bind<kWS, kRS>(smem);
  f.load();
  f.zero_grads();
  __syncthreads();
  ReplayBufs r = a.r;
  const int n = f.g.R * f.g.D;
  r.lam = f.scaf;
  r.kbar = f.scaf + n;
  r.u = f.scaf + 8 * n;
  r.ub = f.scaf + 9 * n;
  adjoint_replay_traj<RowSync>(f, r);
  __syncthreads();
  f.reduce_grads();
}

RowField make_field(const float* w0, const float* b0, const float* w1,
                    const float* b1, const float* w2, const float* b2,
                    float* work, const Geo& g) {
  RowField f{};
  f.w0 = w0;
  f.b0 = b0;
  f.w1 = w1;
  f.b1 = b1;
  f.w2 = w2;
  f.b2 = b2;
  f.work = work;
  f.g = g;
  return f;
}

// Launches kernel(args) as one cluster of g.C CTAs of kRowThreads threads
// with g.smem_floats floats of dynamic shared memory each
// (row_products.cuh: launch_cluster).
template <class Args>
int launch_rows(void (*kernel)(Args), Args& args, const Geo& g,
                cudaStream_t stream) {
  return launch_cluster(kernel, args, g.C, kRowThreads,
                        (size_t)g.smem_floats * sizeof(float), kSmemBudget,
                        stream);
}

}  // namespace

// The plan of a launch at batch B, widths D, H (bwd: the backward's):
// out[0..8] = C, R, dynamic shared-memory bytes, rows in shared memory
// (0/1), weights in shared memory (0/1), device scratch floats, gradient
// tiles, threads a CTA, tiles a thread holds in registers.
extern "C" void ode_dyn_plan(int B, int D, int H, int bwd, long long* out) {
  const Geo g = make_geo(B, D, H, bwd != 0);
  out[0] = g.C;
  out[1] = g.R;
  out[2] = g.smem_floats * (long long)sizeof(float);
  out[3] = g.rows_smem;
  out[4] = g.w_smem;
  out[5] = g.work_floats;
  out[6] = g.ntiles;
  out[7] = kRowThreads;
  out[8] = kTileSlots;
}

extern "C" long long ode_dyn_work_floats(int B, int D, int H) {
  const long long f = make_geo(B, D, H, false).work_floats;
  const long long b = make_geo(B, D, H, true).work_floats;
  return f > b ? f : b;
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
  const Geo g = make_geo(B, D, H, false);
  FwdArgs a{};
  a.f = make_field(w0, b0, w1, b1, w2, b2, work, g);
  a.s.h0 = z0;
  a.s.out = out;
  a.s.ts = ts;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.part = nullptr;
  a.s.N = B * D;
  a.s.T = T;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  a.s.D = D;
  a.s.R = g.R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.rows_smem)
    return record ? launch_rows(ode_dyn_fwd_kernel<true, true, true>, a, g, s)
                  : launch_rows(ode_dyn_fwd_kernel<false, true, true>, a, g,
                                s);
  if (g.w_smem)
    return record ? launch_rows(ode_dyn_fwd_kernel<true, true, false>, a, g, s)
                  : launch_rows(ode_dyn_fwd_kernel<false, true, false>, a, g,
                                s);
  return record ? launch_rows(ode_dyn_fwd_kernel<true, false, false>, a, g, s)
                : launch_rows(ode_dyn_fwd_kernel<false, false, false>, a, g,
                              s);
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
  const Geo g = make_geo(B, D, H, true);
  BwdArgs a{};
  a.f = make_field(w0, b0, w1, b1, w2, b2, work, g);
  a.f.gw0 = gw0;
  a.f.gb0 = gb0;
  a.f.gw1 = gw1;
  a.f.gb1 = gb1;
  a.f.gw2 = gw2;
  a.f.gb2 = gb2;
  a.r.hbar = ct;
  a.r.ts = ts;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = z0bar;
  a.r.N = B * D;
  a.r.T = T;
  a.r.D = D;
  a.r.R = g.R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.rows_smem) return launch_rows(ode_dyn_bwd_kernel<true, true>, a, g, s);
  if (g.w_smem) return launch_rows(ode_dyn_bwd_kernel<true, false>, a, g, s);
  return launch_rows(ode_dyn_bwd_kernel<false, false>, a, g, s);
}
