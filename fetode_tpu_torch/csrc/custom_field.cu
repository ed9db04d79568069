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
// What a field supplies.  The scaffold (node_common.cuh) runs the solve
// under one of three barrier policies, and the field's two device methods
// follow the policy:
//
//   void eval(const float* u, float* out) const;    // out = f(u)
//   void vjp(const float* u, const float* w, float* ubar) const;
//
// This example runs under the row policy (RowSync), the one for a field
// that never mixes rows (row b of f reads row b of u alone): each CTA
// owns a contiguous block of batch rows, and u, w, out and ubar are the
// CTA's own rows only, (nrows, D) row-major, in its own memory.  eval and
// vjp synchronise only the CTA (__syncthreads) and keep any state of
// their own per CTA; the scaffold's one exchange between CTAs is the
// error norm's sum, once an attempt.  A field that mixes rows (a batch
// norm, attention over the batch) cannot run so: it takes the grid
// policy (GridSync), where eval / vjp see all B rows, run on the whole
// cooperative grid and synchronise it with cg::this_grid().sync(), as
// csrc/ferro_node.cu and csrc/mlp_node.cu do.
//
// Launch (ops plan: fetode_tpu_torch/examples/custom_field_kernel.py:
// row_plan, checked against custom_field_plan below once a shape).  Up to
// 64 rows one thread-block cluster of C <= 16 CTAs of 512 threads, CTA c
// owning the rows [c R, min(B, (c + 1) R)), R = ceil(B / 16); past them a
// cooperative grid of C = ceil(B / R) such CTAs, R = max(4, ceil(B /
// 128)), their error-norm partials meeting in device memory behind one
// grid barrier (RowSync::grid(), as B.5 and B.8).  Each CTA holds w1 and
// w2 in its shared memory for the whole launch (rows 4 mod 32 floats
// apart, row_products.cuh's Padded layout: 68 KB at D = 64, H = 128),
// and its rows' state, stages and row records beside them.
//
// Products: row_products.cuh's, B.7's.  The evaluation's two products
// (z = tanh(u w1^T), then z w2^T) read the weights by rows
// (product_rows: a quarter-warp holds 8 outputs, the 4 quarters 4 chunks
// of the contraction, 4 rows a pass, each weight read once for the 4);
// the VJP's transposed ones (zbar = (w w2) (1 - z^2), ubar = zbar w1)
// read the same arrays down their columns (product_cols).  The
// parameter gradients, outer products summed over rows and VJPs, are 4 x
// 4 tiles in each thread's registers for the whole replay (kTileSlots a
// thread; tiles past them accumulate in the CTA's own partial array in
// device memory).  At the end each CTA writes its partials and, after one
// cluster (or grid) barrier, every gradient element is the sum of the C
// partials in rank order.  Every sum has a fixed owner and a fixed order
// set by the widths alone: no atomics, the same bits on every run, and a
// row's state the same bits alone and in any batch.  FP32 throughout
// (FMAs, no tensor cores, no TF32), tanhf (no fast math).
//
// Placement (make_geo): the weights, the VJP's partial-sum buffer and
// the rows in shared memory while they fit 227 KB; else the weights and
// the rows in device memory the CTA owns (w1 and w2 past about 200 KB).
//
// What bounds it on this card: at D = 64, H = 128, B = 64 an evaluation
// is 4 B H D = 2.1 M FLOP and B H tanhs, under 0.1 us of the card's FP32
// rate; a CTA's 4 rows are 65 K FMAs, its 68 KB of weights once through
// the shared-memory port.  The solve is a chain of such evaluations (6
// an attempt), each with a few CTA barriers, and one cluster exchange an
// attempt: latency, not work.

#include "node_common.cuh"
#include "row_products.cuh"

namespace {

using namespace node_common;
using namespace row_products;

constexpr int kRowThreads = 512;  // threads a CTA
constexpr int kTileSlots = 4;     // gradient tiles a thread holds
constexpr int kClusterRows = 4;   // rows a CTA owns, at most, in the cluster
constexpr int kMaxGrid = 128;     // CTAs of the grid form, at most
// Dynamic shared memory a CTA may take: the card's 227 KB less the static
// arrays of the scaffold's reductions.
constexpr size_t kSmemBudget = 232448 - 2048;

#ifdef CUSTOM_FIELD_CLOCKS
// Cycles of CTA b's thread 0 in the weights' load, the evaluations (of
// them: the copy of u and its barrier, the first product with its tanh,
// the tanhs alone, the second product), the VJPs (of them: the three
// products, the gradient tiles), the gradients' sums at the end and the
// whole kernel (a clock build: tools/node_field_times.py --breakdown).
constexpr int kClockSlots = 11;
__device__ long long custom_field_clocks[kClockSlots * 1024];
#define CCLOCK(v) v = clock64()
#define CADD(slot, t0) clk[slot] += clock64() - (t0)
#else
#define CCLOCK(v) (void)0
#define CADD(slot, t0) (void)0
#endif

// The launch's geometry, the same on the host and the device.
struct Geo {
  int B, D, H, R, C, grid, bwd;
  int D4, H4, S1, S2;              // padded lengths, the weights' strides
  int off_z, off_w, off_zb, RS;    // row record [u | z | w | zb]
  int nqh, nqd, t0, ntiles;        // gradient tiles (see tile_offsets)
  int w_floats, p_floats, scaf_floats, row_floats;
  int smem;                        // weights and rows in shared memory
  long long smem_floats, work_floats;
};

Geo make_geo(int B, int D, int H, bool bwd) {
  Geo g{};
  g.B = B;
  g.D = D;
  g.H = H;
  g.bwd = bwd;
  g.grid = B > kMaxCluster * kClusterRows;
  g.R = g.grid ? max(kClusterRows, cdiv(B, kMaxGrid)) : cdiv(B, kMaxCluster);
  g.C = cdiv(B, g.R);
  g.D4 = round4(D);
  g.H4 = round4(H);
  g.S1 = row_stride(D);  // W1: H4 rows of the D4 columns
  g.S2 = row_stride(H);  // W2: D4 rows of the H4 columns
  g.off_z = g.D4;
  g.off_w = g.off_z + g.H4;
  g.off_zb = g.off_w + g.D4;
  g.RS = bwd ? g.off_zb + g.H4 : g.off_w;
  g.nqh = cdiv(H, 4);
  g.nqd = cdiv(D, 4);
  g.t0 = cdiv(D, 4) * g.nqh;
  g.ntiles = 2 * g.t0;
  g.w_floats = g.H4 * g.S1 + g.D4 * g.S2;
  g.p_floats = bwd ? cols_partials(H > D ? H : D, kRowThreads) : 0;
  g.scaf_floats = round4(9 * g.R * D);
  g.row_floats = g.scaf_floats + g.R * g.RS;
  const long long budget = (long long)(kSmemBudget / sizeof(float));
  g.smem = (long long)g.w_floats + g.p_floats + g.row_floats <= budget;
  g.smem_floats = g.p_floats + (g.smem ? g.w_floats + g.row_floats : 0);
  g.work_floats = (g.grid ? kPartFloats : 0) +
                  (long long)g.C *
                      ((g.smem ? 0 : g.w_floats + g.row_floats) +
                       (bwd ? 16LL * g.ntiles : 0));
  return g;
}

struct TanhMlpRows {
  const float* w1;  // (H, D)
  const float* w2;  // (D, H)
  float* gw1;       // (H, D) gradients, backward only
  float* gw2;       // (D, H)
  float* work;      // device scratch (make_geo: work_floats)
  Geo g;
  // This CTA's, set by bind().
  float* W1;        // (H4, S1) w1 with zero pad columns and rows
  float* W2;        // (D4, S2)
  float* P;         // (p_floats) the column products' partial sums
  float* part;      // the grid form's error-norm partials
  float* scaf;      // the scaffold's scratch
  float* rows;      // (R, RS) row records
  float* mine;      // (ntiles, 16) this CTA's gradient partials
  int rank, nrows;
  mutable float acc[kTileSlots][16];
#ifdef CUSTOM_FIELD_CLOCKS
  mutable long long clk[kClockSlots];
#endif

  // kS: the weights and rows in shared memory (g.smem), fixed at compile
  // time so that every pointer into shared memory is known as such and
  // its loads are shared-memory loads.
  template <bool kS>
  __device__ void bind(float* smem) {
    rank = RowSync::rank();
    nrows = tile_rows(rank, g.R, g.B);
    P = smem;
    float* dev = work;
    part = dev;
    dev += g.grid ? kPartFloats : 0;
    const size_t own = (size_t)g.w_floats + g.row_floats;
    float* const w = kS ? smem + g.p_floats : dev + rank * own;
    if constexpr (!kS) dev += g.C * own;
    W1 = w;
    W2 = W1 + g.H4 * g.S1;
    scaf = w + g.w_floats;
    rows = scaf + g.scaf_floats;
    mine = dev + (size_t)rank * 16 * g.ntiles;
  }

  // The padded weights; the row records zeroed (their pad columns stay 0).
  __device__ void load() const {
    pad_copy(W1, Padded{g.S1}, w1, g.H4, g.H, g.D, g.S1);
    pad_copy(W2, Padded{g.S2}, w2, g.D4, g.D, g.H, g.S2);
    for (int i = threadIdx.x; i < g.R * g.RS; i += blockDim.x) rows[i] = 0.0f;
  }

  // rows[b, off + c] = x[b, c] for the CTA's rows, c < D: a warp a row.
  __device__ __forceinline__ void put_rows(const float* x, int off) const {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int b = threadIdx.x >> 5; b < nrows; b += nw)
      for (int c = lane; c < g.D; c += 32)
        rows[b * g.RS + off + c] = x[b * g.D + c];
  }

  // z = tanh(u w1^T) of the rows in the record (u written first).
  __device__ __forceinline__ void hidden() const {
    float* z = rows + g.off_z;
    const int RS = g.RS;
#ifdef CUSTOM_FIELD_CLOCKS
    long long* const ck = clk;
    long long t0;
    CCLOCK(t0);
    product_rows(rows, RS, nrows, W1, Padded{g.S1}, g.D4, g.H,
                 [=](int b, int o, float s) {
      const long long c0 = clock64();
      z[b * RS + o] = tanhf(s);
      if (threadIdx.x == 0) ck[4] += clock64() - c0;
    });
    CADD(3, t0);
#else
    product_rows(rows, RS, nrows, W1, Padded{g.S1}, g.D4, g.H,
                 [=](int b, int o, float s) { z[b * RS + o] = tanhf(s); });
#endif
  }

  __device__ __forceinline__ void eval(const float* u, float* out) const {
    long long t0 = 0, t1 = 0;
    (void)t0;
    (void)t1;
    CCLOCK(t0);
    CCLOCK(t1);
    put_rows(u, 0);
    __syncthreads();
    CADD(2, t1);
    hidden();
    CCLOCK(t1);
    const int D = g.D;
    product_rows(rows + g.off_z, g.RS, nrows, W2, Padded{g.S2}, g.H4, D,
                 [=](int b, int o, float s) { out[b * D + o] = s; });
    CADD(5, t1);
    CADD(1, t0);
  }

  __device__ __forceinline__ void vjp(const float* u, const float* w,
                                      float* ubar) const {
    long long t0 = 0, t1 = 0;
    (void)t0;
    (void)t1;
    CCLOCK(t0);
    put_rows(u, 0);
    put_rows(w, g.off_w);
    __syncthreads();
    CCLOCK(t1);
    hidden();
    const int D = g.D, RS = g.RS;
    const float* z = rows + g.off_z;
    float* zb = rows + g.off_zb;
    product_cols(rows + g.off_w, RS, nrows, W2, Padded{g.S2}, g.D4, g.H, P,
                 [=](int b, int h, float s) {
      const float zz = z[b * RS + h];
      zb[b * RS + h] = s * (1.0f - zz * zz);
    });
    product_cols(zb, RS, nrows, W1, Padded{g.S1}, g.H4, D, P,
                 [=](int b, int d, float s) { ubar[b * D + d] = s; });
    CADD(7, t1);
    CCLOCK(t1);
    grad_tiles();
    CADD(8, t1);
    CADD(6, t0);
  }

  // The row offsets of tile t's a and c vectors: w (x) z for gw2 (D x H),
  // then zbar (x) u for gw1 (H x D), each p-major with q fastest.
  __device__ __forceinline__ void tile_offsets(int t, int& ao, int& co) const {
    if (t < g.t0) {
      ao = g.off_w + 4 * (t / g.nqh);
      co = g.off_z + 4 * (t % g.nqh);
    } else {
      t -= g.t0;
      ao = g.off_zb + 4 * (t / g.nqd);
      co = 4 * (t % g.nqd);
    }
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

  // Each CTA's partials to device memory, one cluster (or grid) barrier,
  // then each gradient element the sum of the C partials in rank order.
  __device__ void reduce_grads() const {
    const int nth = blockDim.x, D = g.D, H = g.H;
#pragma unroll
    for (int sl = 0; sl < kTileSlots; ++sl) {
      const int t = threadIdx.x + sl * nth;
      if (t >= g.ntiles) break;
#pragma unroll
      for (int k = 0; k < 16; ++k) mine[16 * (size_t)t + k] = acc[sl][k];
    }
    if (g.grid) cg::this_grid().sync(); else cg::this_cluster().sync();
    const float* all = mine - (size_t)rank * 16 * g.ntiles;
    const int n = D * H;
    for (int e = rank * nth + threadIdx.x; e < 2 * n; e += g.C * nth) {
      int p, q, t;
      if (e < n) {  // gw2[d, h]
        p = e / H;
        q = e - p * H;
        t = (p >> 2) * g.nqh + (q >> 2);
      } else {      // gw1[h, d]
        p = (e - n) / D;
        q = (e - n) - p * D;
        t = g.t0 + (p >> 2) * g.nqd + (q >> 2);
      }
      const size_t k = 16 * (size_t)t + 4 * (p & 3) + (q & 3);
      float s = 0.0f;
      for (int r = 0; r < g.C; ++r)
        s += __ldcg(all + (size_t)r * 16 * g.ntiles + k);
      if (e < n) gw2[e] = s; else gw1[e - n] = s;
    }
  }

  __device__ void clear_clocks() const {
#ifdef CUSTOM_FIELD_CLOCKS
    for (int k = 0; k < kClockSlots; ++k) clk[k] = 0;
#endif
  }

  __device__ void store_clocks() const {
#ifdef CUSTOM_FIELD_CLOCKS
    if (threadIdx.x == 0)
      for (int k = 0; k < kClockSlots; ++k)
        custom_field_clocks[kClockSlots * blockIdx.x + k] = clk[k];
#endif
  }
};

struct FwdArgs {
  TanhMlpRows f;
  SolveBufs s;
};

struct BwdArgs {
  TanhMlpRows f;
  ReplayBufs r;
};

template <bool kRecord, bool kS>
__global__ void __launch_bounds__(kRowThreads, 1)
    custom_field_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  TanhMlpRows f = a.f;
#ifdef CUSTOM_FIELD_CLOCKS
  long long* const clk = f.clk;
#endif
  long long t0 = 0, t_all = 0;
  (void)t0;
  (void)t_all;
  f.bind<kS>(smem);
  f.clear_clocks();
  CCLOCK(t_all);
  CCLOCK(t0);
  f.load();
  __syncthreads();
  CADD(0, t0);
  SolveBufs s = a.s;
  s.part = f.part;
  const int n = f.g.R * f.g.D;
  s.y = f.scaf;
  s.ks = f.scaf + n;
  s.u = f.scaf + 8 * n;
  adaptive_solve<kRecord, false, TanhMlpRows, RowSync>(f, s);
  CADD(kClockSlots - 1, t_all);
  f.store_clocks();
}

template <bool kS>
__global__ void __launch_bounds__(kRowThreads, 1)
    custom_field_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  TanhMlpRows f = a.f;
#ifdef CUSTOM_FIELD_CLOCKS
  long long* const clk = f.clk;
#endif
  long long t0 = 0, t_all = 0;
  (void)t0;
  (void)t_all;
  f.bind<kS>(smem);
  f.clear_clocks();
  CCLOCK(t_all);
  CCLOCK(t0);
  f.load();
  f.zero_grads();
  __syncthreads();
  CADD(0, t0);
  ReplayBufs r = a.r;
  const int n = f.g.R * f.g.D;
  r.lam = f.scaf;
  r.kbar = f.scaf + n;
  r.u = f.scaf + 7 * n;
  r.ub = f.scaf + 8 * n;
  adjoint_replay_impl<false, TanhMlpRows, RowSync>(f, r);
  __syncthreads();
  CCLOCK(t0);
  f.reduce_grads();
  CADD(9, t0);
  CADD(kClockSlots - 1, t_all);
  f.store_clocks();
}

TanhMlpRows make_field(const float* w1, const float* w2, float* work,
                       const Geo& g) {
  TanhMlpRows f{};
  f.w1 = w1;
  f.w2 = w2;
  f.work = work;
  f.g = g;
  return f;
}

// Launches kernel(args) as one cluster of g.C CTAs of kRowThreads threads
// with g.smem_floats floats of dynamic shared memory each, or as the grid
// form's cooperative grid.
template <class Args>
int launch_rows(void (*kernel)(Args), Args& args, const Geo& g,
                cudaStream_t stream) {
  const size_t bytes = (size_t)g.smem_floats * sizeof(float);
  if (g.grid)
    return launch_row_grid(kernel, args, g.C, kRowThreads, bytes, kSmemBudget,
                           stream);
  return launch_cluster(kernel, args, g.C, kRowThreads, bytes, kSmemBudget,
                        stream);
}

}  // namespace

// The plan of a launch at batch B, widths D, H (bwd: the backward's):
// out[0..9] = C, R, dynamic shared-memory bytes, weights and rows in
// shared memory (0/1), device scratch floats, gradient tiles, threads a
// CTA, tiles a thread holds in registers, the grid form (0/1), the row
// record's floats.
extern "C" void custom_field_plan(int B, int D, int H, int bwd,
                                  long long* out) {
  const Geo g = make_geo(B, D, H, bwd != 0);
  out[0] = g.C;
  out[1] = g.R;
  out[2] = g.smem_floats * (long long)sizeof(float);
  out[3] = g.smem;
  out[4] = g.work_floats;
  out[5] = g.ntiles;
  out[6] = kRowThreads;
  out[7] = kTileSlots;
  out[8] = g.grid;
  out[9] = g.RS;
}

extern "C" long long custom_field_work_floats(int B, int D, int H) {
  const long long f = make_geo(B, D, H, false).work_floats;
  const long long b = make_geo(B, D, H, true).work_floats;
  return f > b ? f : b;
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
  const Geo g = make_geo(B, D, H, false);
  FwdArgs a{};
  a.f = make_field(w1, w2, work, g);
  a.s.h0 = h0;
  a.s.out = out;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.part = nullptr;
  a.s.N = B * D;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  a.s.D = D;
  a.s.R = g.R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.smem)
    return record ? launch_rows(custom_field_fwd_kernel<true, true>, a, g, s)
                  : launch_rows(custom_field_fwd_kernel<false, true>, a, g, s);
  return record ? launch_rows(custom_field_fwd_kernel<true, false>, a, g, s)
                : launch_rows(custom_field_fwd_kernel<false, false>, a, g, s);
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
  const Geo g = make_geo(B, D, H, true);
  BwdArgs a{};
  a.f = make_field(w1, w2, work, g);
  a.f.gw1 = gw1;
  a.f.gw2 = gw2;
  a.r.hbar = hbar;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = h0bar;
  a.r.N = B * D;
  a.r.D = D;
  a.r.R = g.R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g.smem ? launch_rows(custom_field_bwd_kernel<true>, a, g, s)
                : launch_rows(custom_field_bwd_kernel<false>, a, g, s);
}
