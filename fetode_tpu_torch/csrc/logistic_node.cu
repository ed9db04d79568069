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
// no torch.matmul inside the solve).  All arithmetic is FP32 (no TF32, no
// tensor cores).
//
// The field never mixes rows: row b of dh reads row b of y alone.  So the
// solve runs under node_common.cuh's row policy (RowSync), as B.7's and
// B.8's: up to 64 rows one thread-block cluster of C <= 16 CTAs of 512
// threads, CTA c owning the batch rows [c R, min(B, (c + 1) R)), R =
// ceil(B / 16); past them a cooperative grid of ceil(B / R) such CTAs, R =
// max(4, ceil(B / 128)), their error-norm partials meeting in device
// memory behind one grid barrier (ops/logistic_node.py: row_plan).  An
// evaluation or a VJP synchronises only the CTA; the one exchange is the
// error norm's sum, once an attempt (twice in Hairer's initial step).
//
// Placement.  W (196 KB at D = 64, K = 12) stays in each CTA's shared
// memory for the whole launch as its (DP, WSL) rows, DP = D rounded up to
// 32 and WSL = LP rounded up to 4 mod 32 floats (row_products.cuh:
// row_stride, LP = 16 LC): a quarter-warp's 16-byte loads of 8 rows (the
// forward, lanes on consecutive o) and a warp's loads along a row (the
// VJP, lanes on consecutive l) both cover the 32 banks once.  It arrives
// by 16-byte cp.async copies of its rows, all in flight at once (4-byte
// copies cost about a transaction an element: three times the time), a,
// b and bp (6 KB) beside it.  Beside them the
// rows' state, stages and scratch (9 x 64 floats a row) and the field's
// buffer for GR <= 4 rows.  Where they do not fit, the rows, and past that
// W too, go to device memory the CTA owns (row_plan says where); the code
// is the same, the placement a template argument.
//
// Evaluation, GR rows a pass (each W element read from shared memory once
// a pass, into a register, for all of the pass's rows): warp w owns the
// contraction chunk l in [w LC, (w + 1) LC), LC = L / 16 rounded up to 4.
// Its lanes form phi for the chunk and the pass's rows into the warp's
// own buffer (no barrier but the warp's; the feature index l / K by a
// float reciprocal, no integer division), then each lane runs the chunk
// for the outputs o = lane and lane + 32, 4 l's a 16-byte load, FMAs in l
// order, and writes its partials; after one CTA barrier each (row, o) is
// the 16 warps' partials added in warp order, plus bp.  phi never goes to
// device memory.
//
// VJP with cotangent w (B, D), GR rows a pass: thread t owns the l = t + i
// 512, and forms pbar[b, l] = sum_o w[b, o] W[o, l] down W's column l (o
// in order), s1, phi and zb = pbar 2 phi (1 - phi) s1 (1 - s1); ga[l] += zb
// (x - b[l]) and gb[l] += -zb a[l] in its registers, over the rows and the
// VJPs in replay order; zb goes to the buffer, and after one CTA barrier
// ubar[b, d] = sum_k zb[b, dK + k] a[dK + k], k in order.  gW is deferred:
// each VJP v writes its rows' (w, phi), D + L floats a row, to device
// memory (rec[v][b]), and after the replay and one cluster (or grid)
// barrier every CTA owns a slice of L + 1 columns of [gW | gbp] =
// sum_{v, b} w[v, b]^T [phi[v, b], 1]: each element a thread's, the sum
// over (v, b) in index order (in KS fixed interleaved splits added in
// split order where the CTA has more threads than 4 x 4 output tiles),
// the records staged by 16-byte cp.async in two buffers, a tile row
// stored as one 16-byte store.
// ga, gb are each CTA's register partials, added in rank order after the
// same barrier.  No atomics: every output, record and gradient is the
// same bits on every run, and a row's output and records are the same
// bits alone and in any batch (the sums' orders depend on D and K only).
//
// What bounds it on this card: at the ECG widths (D = 64, K = 12, B = 8)
// an evaluation is 0.4 M multiply-adds and 12 k sigmoids, microseconds of
// work for one SM, so the solve is latency-bound.  A CTA's pass reads its
// 196 KB of W through the shared-memory port once (1,536 wavefronts,
// about 0.8 us): with one row a CTA that, the barriers between the
// scaffold's passes and the one cluster exchange an attempt set the pace.
// The backward's deferred gW is 49,152 (V B) FMAs, V the VJPs (6 an
// accepted attempt), spread over the cluster.

#include "knot_quotient.cuh"
#include "node_common.cuh"
#include "row_products.cuh"

namespace {

using namespace node_common;
using namespace row_products;

constexpr int kRowThreads = 512;  // threads a CTA
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kGroupRows = 4;     // rows of a pass, at most
constexpr int kClusterRows = 4;   // rows a CTA owns, at most, in the cluster
constexpr int kMaxGrid = 128;     // CTAs of the grid form, at most
constexpr int kOwnRegs = 2;       // rounds of owned l's whose ga / gb sit
                                  // in registers (2 x 512 l's a round)
constexpr int kChunk = 128;       // (v, b) records a stage of the gW pass
// Dynamic shared memory a CTA may take: the card's 227 KB less the static
// arrays of the scaffold's reductions.
constexpr size_t kSmemBudget = 232448 - 2048;

// l / K for 0 <= l < 2^20 and K < 2^10: (l + 1/2) / K lies at least 1/(2K)
// inside (d, d + 1), far beyond the float product's rounding, so this
// takes no integer division (rk = 1 / K).
__device__ __forceinline__ int div_k(int l, float rk) {
  return (int)(((float)l + 0.5f) * rk);
}

// sigmoid(z) with the IEEE quotient's fast path (knot_quotient.cuh).
__device__ __forceinline__ float sig(float z) {
  return rcp_sigmoid(1.0f + expf(-z));
}

// 4- and 16-byte asynchronous copies from device to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

#ifdef LOGISTIC_NODE_CLOCKS
// Cycles of CTA b's thread 0 in the parameters' load, the evaluations (of
// them: phi, the product, the partials' sums), the VJPs (of them: the
// transposed product, the rest of the columns' work, ubar), the deferred
// gradients (of them: the barrier and ga / gb, the waits for the records,
// the products) and the whole kernel (a clock build:
// tools/node_field_times.py --breakdown).
constexpr int kClockSlots = 14;
__device__ long long logistic_node_clocks[kClockSlots * 1024];
#define LCLOCK(v) v = clock64()
#define LADD(slot, t0) clk[slot] += clock64() - (t0)
#define LADD_F(slot, t0) f.clk[slot] += clock64() - (t0)
#else
#define LADD_F(slot, t0) (void)0
#define LCLOCK(v) (void)0
#define LADD(slot, t0) (void)0
#endif

// The launch's geometry, the same on the host and the device.  grid_past:
// the largest batch one cluster takes (64, ops/logistic_node.py:
// GRID_PAST; a tool may move it to time the other form).
struct Geo {
  int B, D, K, L, M, bwd, grid, R, C;
  int DP, NO, LC, LP, WSL;   // padded widths: D, 32-output blocks, l chunk,
                             // W's row length and stride
  int GR, PB, poff;          // rows a pass; the per-warp per-row buffer and
                             // the partials' offset in it (fwd)
  int w_floats, buf_floats, scaf_floats;
  int w_smem, rows_smem;
  // Backward: the deferred gW pass.
  int LS, NOG, T, TT, KS, MC, gw_floats, rec_row;
  long long V, smem_floats, work_floats;
};

__host__ __device__ inline int buf_for(const Geo& g, int GR) {
  if (g.bwd) return GR * (g.DP + g.L);  // w rows (padded), zb rows
  return kRowWarps * GR * g.PB;
}

Geo make_geo(int B, int D, int K, int M, bool bwd, int grid_past) {
  Geo g{};
  g.B = B;
  g.D = D;
  g.K = K;
  g.L = D * K;
  g.M = M;
  g.bwd = bwd;
  g.grid = B > grid_past;
  g.R = g.grid ? max(kClusterRows, cdiv(B, kMaxGrid)) : cdiv(B, kMaxCluster);
  g.C = cdiv(B, g.R);
  g.DP = round32(D);
  g.NO = g.DP / 32;
  g.LC = round4(cdiv(g.L, kRowWarps));
  g.LP = kRowWarps * g.LC;
  g.WSL = row_stride(g.LP);
  g.PB = g.NO <= 2 ? max(g.LC, g.DP) : g.LC + g.DP;
  g.poff = g.NO <= 2 ? 0 : g.LC;
  g.w_floats = g.DP * g.WSL + 2 * g.LP + g.DP;
  g.scaf_floats = round4(9 * g.R * D);
  const long long budget = (long long)(kSmemBudget / sizeof(float));
  // The first of: everything in shared memory; the rows in device memory;
  // the parameters too; each with the most rows a pass that fits.
  g.GR = 0;
  for (int form = 0; form < 3 && g.GR == 0; ++form)
    for (int GR = kGroupRows; GR >= 1 && g.GR == 0; GR /= 2) {
      const long long need = (long long)buf_for(g, GR) +
                             (form < 2 ? g.w_floats : 0) +
                             (form == 0 ? g.scaf_floats : 0);
      if (need <= budget) {
        g.GR = GR;
        g.rows_smem = form == 0;
        g.w_smem = form < 2;
      }
    }
  if (g.GR == 0) g.GR = 1;  // too wide for any placement: the launch refuses
  g.buf_floats = round4(buf_for(g, g.GR));
  g.smem_floats = g.buf_floats + (g.w_smem ? g.w_floats : 0) +
                  (g.rows_smem ? g.scaf_floats : 0);
  g.work_floats = kPartFloats +
                  (long long)g.C * ((g.w_smem ? 0 : g.w_floats) +
                                    (g.rows_smem ? 0 : g.scaf_floats));
  if (bwd) {
    // [gW | gbp]: D x (L + 1) over the C CTAs by column slices of LS; a
    // CTA's 4 x 4 tiles, TT at once, KS interleaved splits of the records.
    g.LS = round4(cdiv(g.L + 1, g.C));
    g.NOG = cdiv(D, 4);
    g.T = g.NOG * (g.LS / 4);
    g.TT = min(g.T, kRowThreads);
    g.KS = g.T >= kRowThreads ? 1 : kRowThreads / g.T;
    const long long parts = g.KS > 1 ? 16LL * g.KS * g.TT : 0;
    const long long room = max(g.smem_floats, budget) - parts;
    g.MC = (int)min((long long)kChunk, room / (2 * (4 * g.NOG + g.LS)));
    if (g.MC < 1) g.MC = 1;
    g.gw_floats = (int)(2 * g.MC * (4 * g.NOG + g.LS) + parts);
    if (g.gw_floats > g.smem_floats) g.smem_floats = g.gw_floats;
    g.rec_row = D + g.L;
    g.V = 6LL * M;
    g.work_floats += (long long)g.C * 2 * g.L + g.V * B * g.rec_row;
  }
  return g;
}

struct LogisticRows {
  const float* av;  // (L)
  const float* bv;  // (L)
  const float* pw;  // (D, L)
  const float* pb;  // (D)
  float* gav;       // (L) gradients, backward only
  float* gbv;       // (L)
  float* gpw;       // (D, L)
  float* gpb;       // (D)
  float* work;      // device scratch (make_geo: work_floats)
  Geo g;
  // This CTA's, set by bind().
  float* Ws;        // (DP, WSL): W's rows, zero past D and L
  float* A;         // (LP) a, zero past L
  float* Bv;        // (LP) b
  float* Bp;        // (DP) bp
  float* buf;       // the field's buffer (buf_floats)
  float* scaf;      // the scaffold's rows
  float* gpart;     // (C, 2L) every CTA's ga / gb partials (backward)
  float* rec;       // (V, B, D + L) the VJPs' (w, phi) rows (backward)
  int rank, row0, nrows;
  mutable int nv;   // VJPs so far
  mutable float ga[2 * kOwnRegs], gb[2 * kOwnRegs];
#ifdef LOGISTIC_NODE_CLOCKS
  mutable long long clk[kClockSlots];
#endif

  template <bool kWS, bool kRS>
  __device__ void bind(float* smem) {
    rank = RowSync::rank();
    row0 = tile_first(rank, g.R);
    nrows = tile_rows(rank, g.R, g.B);
    nv = 0;
    float* s = smem;
    buf = s;
    s += g.buf_floats;
    float* dev = work + kPartFloats;
    float* w;
    if constexpr (kWS) {
      w = s;
      s += g.w_floats;
    } else {
      w = dev + (size_t)rank * g.w_floats;
      dev += (size_t)g.C * g.w_floats;
    }
    Ws = w;
    A = Ws + (size_t)g.DP * g.WSL;
    Bv = A + g.LP;
    Bp = Bv + g.LP;
    if constexpr (kRS) {
      scaf = s;
    } else {
      scaf = dev + (size_t)rank * g.scaf_floats;
      dev += (size_t)g.C * g.scaf_floats;
    }
    gpart = dev;
    rec = gpart + (size_t)g.C * 2 * g.L;
  }

  // W's rows into Ws: in shared memory by 16-byte cp.async copies where
  // its rows allow them, else 4-byte ones, all in flight at once; into the
  // CTA's device copy by plain copies; the padding stored as zeros.
  template <bool kWS>
  __device__ void load() const {
    const int t = threadIdx.x, nth = blockDim.x;
    const int D = g.D, L = g.L, WSL = g.WSL;
    const bool wide = (L & 3) == 0 && ((size_t)pw & 15) == 0;
    const int n = wide ? L / 4 : L;       // copies a row
    for (int i = t; i < D * n; i += nth) {
      const int o = i / n, c = i - o * n;
      float* dst = Ws + (size_t)o * WSL;
      const float* src = pw + (size_t)o * L;
      if constexpr (kWS) {
        if (wide) cp_async16(dst + 4 * c, src + 4 * c);
        else cp_async4(dst + c, src + c);
      } else if (wide) {
        *reinterpret_cast<float4*>(dst + 4 * c) =
            __ldg(reinterpret_cast<const float4*>(src) + c);
      } else {
        dst[c] = __ldg(src + c);
      }
    }
    const int pad = WSL - L;  // each row's columns past L, then rows past D
    for (int i = t; i < D * pad; i += nth) {
      const int o = i / pad;
      Ws[(size_t)o * WSL + L + (i - o * pad)] = 0.0f;
    }
    for (int i = t; i < (g.DP - D) * WSL; i += nth)
      Ws[(size_t)D * WSL + i] = 0.0f;
    for (int i = t; i < g.LP; i += nth) {
      A[i] = i < L ? __ldg(av + i) : 0.0f;
      Bv[i] = i < L ? __ldg(bv + i) : 0.0f;
    }
    for (int i = t; i < g.DP; i += nth) Bp[i] = i < D ? __ldg(pb + i) : 0.0f;
    if constexpr (kWS) asm volatile("cp.async.wait_all;" ::: "memory");
  }

  // One pass of the evaluation over rows g0 .. g0 + ng - 1 (ng <= kG).
  template <int kG>
  __device__ __forceinline__ void eval_pass(const float* u, float* out,
                                            int g0, int ng) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int D = g.D, K = g.K, L = g.L, LC = g.LC, PB = g.PB;
    const int l0 = warp * LC;
    float* const wb = buf + (size_t)warp * g.GR * PB;
    long long t0 = 0;
    (void)t0;
    LCLOCK(t0);
    const float rk = 1.0f / (float)K;
    for (int c = lane; c < LC; c += 32) {
      const int l = l0 + c;
      const int d = div_k(l, rk);
      const float al = A[l], bl = Bv[l];
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        const float x = u[(g0 + min(r, ng - 1)) * D + min(d, D - 1)];
        const float v = sig(2.0f * sig(al * (x - bl)));
        wb[r * PB + c] = (r < ng && l < L) ? v : 0.0f;
      }
    }
    __syncwarp();
    LADD(2, t0);
    LCLOCK(t0);
    for (int q = 0; q < g.NO; q += 2) {
      const bool two = q + 1 < g.NO;
      const int o0 = 32 * q + lane;
      float a0[kG], a1[kG];
#pragma unroll
      for (int r = 0; r < kG; ++r) a0[r] = a1[r] = 0.0f;
      // Rows o0 and o0 + 32 of W from column l0 (o0 + 32 < DP when two).
      const float* w0p = Ws + (size_t)o0 * g.WSL + l0;
      const float* w1p = two ? w0p + 32 * (size_t)g.WSL : w0p;
#pragma unroll 2
      for (int c = 0; c < LC; c += 4) {
        float4 ph[kG];
#pragma unroll
        for (int r = 0; r < kG; ++r)
          ph[r] = *reinterpret_cast<const float4*>(wb + r * PB + c);
        const float4 w4 = *reinterpret_cast<const float4*>(w0p + c);
        const float4 v4 = *reinterpret_cast<const float4*>(w1p + c);
        const float w0[4] = {w4.x, w4.y, w4.z, w4.w};
        const float w1[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int r = 0; r < kG; ++r) {
            const float p = e == 0 ? ph[r].x : e == 1 ? ph[r].y
                          : e == 2 ? ph[r].z : ph[r].w;
            a0[r] = fmaf(p, w0[e], a0[r]);
            a1[r] = fmaf(p, w1[e], a1[r]);
          }
        }
      }
      __syncwarp();  // the chunk's phi read before the partials replace it
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        wb[r * PB + g.poff + o0] = a0[r];
        if (two) wb[r * PB + g.poff + o0 + 32] = a1[r];
      }
    }
    __syncthreads();
    LADD(3, t0);
    LCLOCK(t0);
    for (int i = threadIdx.x; i < ng * D; i += blockDim.x) {
      const int r = i / D, o = i - r * D;
      float v[kRowWarps];
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w)
        v[w] = buf[((size_t)w * g.GR + r) * PB + g.poff + o];
      float s = v[0];
#pragma unroll
      for (int w = 1; w < kRowWarps; ++w) s += v[w];
      out[(g0 + r) * D + o] = s + Bp[o];
    }
    LADD(4, t0);
  }

  // out = f(u) for the CTA's rows (u, out: the CTA's nrows x D).
  __device__ __forceinline__ void eval(const float* u, float* out) const {
    long long t0 = 0;
    (void)t0;
    LCLOCK(t0);
    for (int g0 = 0; g0 < nrows; g0 += g.GR) {
      if (g0 > 0) __syncthreads();  // the last pass's sums read the buffer
      const int ng = min(g.GR, nrows - g0);
      if (ng == 1) eval_pass<1>(u, out, g0, ng);
      else if (ng == 2) eval_pass<2>(u, out, g0, ng);
      else eval_pass<kGroupRows>(u, out, g0, ng);
    }
    LADD(1, t0);
  }

  // The VJP of owned columns l0 and l1 (l1 < L or not live) for a pass's
  // rows: pbar, zb into the buffer, ga / gb into (g0a, g1a), (g0b, g1b),
  // phi into the records of VJP v.
  template <int kG>
  __device__ __forceinline__ void vjp_cols(const float* u, int g0, int ng,
                                           int v, int l0, int l1,
                                           float& ga0, float& gb0,
                                           float& ga1, float& gb1) const {
    const int D = g.D, K = g.K, L = g.L, DP = g.DP;
    const float* const wrow = buf;          // (GR, DP) the rows' w
    float* const zb = buf + g.GR * DP;      // (GR, L)
    const bool live0 = l0 < L, live1 = l1 < L;
    const int la = live0 ? l0 : 0, lb = live1 ? l1 : la;
    long long t0c = 0;
    (void)t0c;
    LCLOCK(t0c);
    const float rk = 1.0f / (float)K;
    const size_t WSL = g.WSL;
    const float* ta = Ws + la;            // W's columns l0 and l1
    const float* tb = Ws + lb;
    float p0[kG], p1[kG];
#pragma unroll
    for (int r = 0; r < kG; ++r) p0[r] = p1[r] = 0.0f;
#pragma unroll 2
    for (int o = 0; o < DP; o += 4, ta += 4 * WSL, tb += 4 * WSL) {
      float4 wv[kG];
#pragma unroll
      for (int r = 0; r < kG; ++r)
        wv[r] = *reinterpret_cast<const float4*>(wrow + r * DP + o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t0 = ta[e * WSL], t1 = tb[e * WSL];
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          const float w = e == 0 ? wv[r].x : e == 1 ? wv[r].y
                        : e == 2 ? wv[r].z : wv[r].w;
          p0[r] = fmaf(w, t0, p0[r]);
          p1[r] = fmaf(w, t1, p1[r]);
        }
      }
    }
    LADD(6, t0c);
    LCLOCK(t0c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = h == 0 ? live0 : live1;
      if (!live) continue;
      const int l = h == 0 ? l0 : l1;
      const float al = A[l], bl = Bv[l];
      const int dl = div_k(l, rk);
      float sa = h == 0 ? ga0 : ga1, sb = h == 0 ? gb0 : gb1;
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        if (r >= ng) break;
        const float x = u[(g0 + r) * D + dl];
        const float s1 = sig(al * (x - bl));
        const float ph = sig(2.0f * s1);
        const float z = (h == 0 ? p0[r] : p1[r]) *
                        (2.0f * ph * (1.0f - ph)) * (s1 * (1.0f - s1));
        sa += z * (x - bl);
        sb += -z * al;
        zb[r * L + l] = z;
        rec[((size_t)v * g.B + row0 + g0 + r) * g.rec_row + D + l] = ph;
      }
      if (h == 0) {
        ga0 = sa;
        gb0 = sb;
      } else {
        ga1 = sa;
        gb1 = sb;
      }
    }
    LADD(7, t0c);
  }

  template <int kG>
  __device__ __forceinline__ void vjp_pass(const float* u, const float* w,
                                           float* ubar, int g0, int ng,
                                           int v) const {
    const int t = threadIdx.x, nth = blockDim.x;
    const int D = g.D, K = g.K, L = g.L, DP = g.DP;
    float* const wrow = buf;
    float* const zb = buf + g.GR * DP;
    for (int i = t; i < kG * DP; i += nth) {
      const int r = i / DP, o = i - r * DP;
      const float x = (r < ng && o < D) ? w[(g0 + r) * D + o] : 0.0f;
      wrow[i] = x;
      if (r < ng && o < D)
        rec[((size_t)v * g.B + row0 + g0 + r) * g.rec_row + o] = x;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOwnRegs; ++k) {
      const int l0 = 2 * k * nth + t;
      if (2 * k * nth < L)
        vjp_cols<kG>(u, g0, ng, v, l0, l0 + nth, ga[2 * k], gb[2 * k],
                     ga[2 * k + 1], gb[2 * k + 1]);
    }
    // Columns past the registers' rounds: their partials in this CTA's
    // row of gpart (read and written by the owning thread alone).
    for (int l0 = 2 * kOwnRegs * nth + t; l0 < L; l0 += 2 * nth) {
      float* const ra = gpart + (size_t)rank * 2 * L;
      const int l1 = l0 + nth;
      float a0 = ra[l0], b0 = ra[L + l0];
      float a1 = l1 < L ? ra[l1] : 0.0f, b1 = l1 < L ? ra[L + l1] : 0.0f;
      vjp_cols<kG>(u, g0, ng, v, l0, l1, a0, b0, a1, b1);
      ra[l0] = a0;
      ra[L + l0] = b0;
      if (l1 < L) {
        ra[l1] = a1;
        ra[L + l1] = b1;
      }
    }
    long long t0u = 0;
    (void)t0u;
    LCLOCK(t0u);
    __syncthreads();
    for (int i = t; i < ng * D; i += nth) {
      const int r = i / D, d = i - r * D;
      const float* zr = zb + r * L + d * K;
      float s = 0.0f;
      for (int k = 0; k < K; ++k) s += zr[k] * A[d * K + k];
      ubar[(g0 + r) * D + d] = s;
    }
    LADD(8, t0u);
  }

  // ubar = w^T df/du(u) for the CTA's rows; the parameter gradients as
  // above.
  __device__ __forceinline__ void vjp(const float* u, const float* w,
                                      float* ubar) const {
    const int v = nv++;
    long long t0 = 0;
    (void)t0;
    LCLOCK(t0);
    for (int g0 = 0; g0 < nrows; g0 += g.GR) {
      if (g0 > 0) __syncthreads();
      const int ng = min(g.GR, nrows - g0);
      if (ng == 1) vjp_pass<1>(u, w, ubar, g0, ng, v);
      else if (ng == 2) vjp_pass<2>(u, w, ubar, g0, ng, v);
      else vjp_pass<kGroupRows>(u, w, ubar, g0, ng, v);
    }
    LADD(5, t0);
  }

  __device__ void clear_clocks() const {
#ifdef LOGISTIC_NODE_CLOCKS
    for (int k = 0; k < kClockSlots; ++k) clk[k] = 0;
#endif
  }

  __device__ void store_clocks() const {
#ifdef LOGISTIC_NODE_CLOCKS
    if (threadIdx.x == 0)
      for (int k = 0; k < kClockSlots; ++k)
        logistic_node_clocks[kClockSlots * blockIdx.x + k] = clk[k];
#endif
  }

  __device__ void zero_grads() const {
#pragma unroll
    for (int k = 0; k < 2 * kOwnRegs; ++k) ga[k] = gb[k] = 0.0f;
    const int L = g.L, nth = blockDim.x;
    float* const ra = gpart + (size_t)rank * 2 * L;
    for (int l = 2 * kOwnRegs * nth + threadIdx.x; l < L; l += nth)
      ra[l] = ra[L + l] = 0.0f;
  }

  // After the replay: the partials of ga / gb to gpart, one cluster (or
  // grid) barrier, ga / gb the sum of the C partials in rank order, and
  // this CTA's slice of [gW | gbp] from the records.
  __device__ void finish_grads() const {
    long long t0 = 0;
    (void)t0;
    LCLOCK(t0);
    const int t = threadIdx.x, nth = blockDim.x, L = g.L, D = g.D;
    float* const ra = gpart + (size_t)rank * 2 * L;
#pragma unroll
    for (int k = 0; k < 2 * kOwnRegs; ++k) {
      const int l = k * nth + t;
      if (l < L) {
        ra[l] = ga[k];
        ra[L + l] = gb[k];
      }
    }
    if (g.grid) cg::this_grid().sync(); else cg::this_cluster().sync();
    for (int e = rank * nth + t; e < 2 * L; e += g.C * nth) {
      const float s = ordered_sum(gpart + e, g.C, (size_t)2 * L);
      if (e < L) gav[e] = s; else gbv[e - L] = s;
    }
    LADD(10, t0);
    // [gW | gbp] columns [c0, c0 + LS) of this CTA: tile tt (4 outputs x 4
    // columns), split ks over the records m = ks, ks + KS, ... of each
    // stage, m = v B + b in index order.
    const int c0 = rank * g.LS, LS = g.LS, AS = 4 * g.NOG, MC = g.MC;
    if (c0 >= L + 1) return;
    const long long Mrec = (long long)nv * g.B;
    const int SW = MC * (AS + LS);    // a stage: MC records' w, then phi
    float* const part = buf + 2 * SW; // two stages; the whole dynamic smem
                                      // is free now
    const int TT = g.TT, KS = g.KS;
    const int rounds = cdiv(g.T, nth);
    const int stages = (int)((Mrec + MC - 1) / MC);
    // Stage s's records into buffer s & 1, by cp.async (zeros and gbp's
    // ones stored directly).
    // 16-byte copies where every record row allows them (D and L multiples
    // of 4): a stage's element quads (m, q) stepped, not divided.
    const bool wide = (D & 3) == 0 && (L & 3) == 0 && (g.rec_row & 3) == 0;
    const int E = wide ? 4 : 1, RW = (AS + LS) / E;
    const int dm = nth / RW, dc = nth - dm * RW;
    auto fetch = [&](int st) {
      float* const As = buf + (st & 1) * SW;
      float* const Ps = As + MC * AS;
      const long long m0 = (long long)st * MC;
      const int mc = (int)min((long long)MC, Mrec - m0);
      for (int m = t / RW, q = t - (t / RW) * RW; m < mc;
           m += dm, q += dc) {
        if (q >= RW) {
          q -= RW;
          if (++m >= mc) break;
        }
        const float* row = rec + (size_t)(m0 + m) * g.rec_row;
        const int c = q * E;
        float* dst;
        const float* src;
        bool live;
        int l = 0;
        if (c < AS) {
          dst = As + m * AS + c;
          src = row + c;
          live = c < D;
        } else {
          l = c0 + c - AS;
          dst = Ps + m * LS + c - AS;
          src = row + D + l;
          live = l < L;
        }
        if (live) {
          if (wide) cp_async16(dst, src); else cp_async4(dst, src);
        } else {
          for (int k = 0; k < E; ++k)
            dst[k] = (c >= AS && l + k == L) ? 1.0f : 0.0f;
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    const int NLG = LS / 4;  // tiles: column groups fastest, so a warp's
                             // stores of a tile row are contiguous
    for (int rd = 0; rd < rounds; ++rd) {
      const int tt = rd * nth + t % TT, ks = t / TT;
      const bool live = ks < KS && tt < g.T;
      const int og = tt / NLG, lg = tt % NLG;
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
      __syncthreads();  // the last round's reads of the buffers are done
      if (stages > 0) fetch(0);
      for (int st = 0; st < stages; ++st) {
        LCLOCK(t0);
        if (st + 1 < stages) {
          fetch(st + 1);
          asm volatile("cp.async.wait_group 1;" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;" ::: "memory");
        }
        __syncthreads();
        LADD(11, t0);
        LCLOCK(t0);
        const float* const As = buf + (st & 1) * SW + 4 * og;
        const float* const Ps = buf + (st & 1) * SW + MC * AS + 4 * lg;
        const int mc = (int)min((long long)MC, Mrec - (long long)st * MC);
        if (live) {
#pragma unroll 4
          for (int m = ks; m < mc; m += KS) {
            const float4 a = *reinterpret_cast<const float4*>(As + m * AS);
            const float4 p = *reinterpret_cast<const float4*>(Ps + m * LS);
            const float av4[4] = {a.x, a.y, a.z, a.w};
            const float pv4[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[4 * i + j] = fmaf(av4[i], pv4[j], acc[4 * i + j]);
          }
        }
        __syncthreads();  // stage st read before st + 2 overwrites it
        LADD(12, t0);
      }
      if (KS == 1) {
        if (live)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            put_row(c0, og, lg, i, acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                    acc[4 * i + 3]);
        continue;
      }
      // The KS splits' partials, added in split order (one round: T < nth),
      // a thread a tile row.
      __syncthreads();
      if (live)
#pragma unroll
        for (int k = 0; k < 16; ++k)
          part[((size_t)ks * TT + tt) * 16 + k] = acc[k];
      __syncthreads();
      for (int i = t; i < TT * 4; i += nth) {
        const int tile = i / 4, row = i - tile * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = tile * 16 + 4 * row + j;
          float s = part[e];
          for (int q = 1; q < KS; ++q) s += part[(size_t)q * TT * 16 + e];
          v[j] = s;
        }
        put_row(c0, tile / NLG, tile % NLG, row, v[0], v[1], v[2], v[3]);
      }
    }
  }

  // Row i of [gW | gbp]'s tile (og, lg) in the slice from column c0: the
  // four columns 4 lg .. 4 lg + 3 of output 4 og + i, one 16-byte store
  // where they are all gW's and aligned.
  __device__ __forceinline__ void put_row(int c0, int og, int lg, int i,
                                          float s0, float s1, float s2,
                                          float s3) const {
    const int o = 4 * og + i, l = c0 + 4 * lg, L = g.L;
    if (o >= g.D) return;
    float* const dst = gpw + (size_t)o * L + l;
    if ((L & 3) == 0 && l + 3 < L && l + 3 < c0 + g.LS) {
      *reinterpret_cast<float4*>(dst) = make_float4(s0, s1, s2, s3);
      return;
    }
    const float s[4] = {s0, s1, s2, s3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (l + j > L || l + j >= c0 + g.LS) break;
      if (l + j < L) dst[j] = s[j]; else gpb[o] = s[j];
    }
  }

};

struct FwdArgs {
  LogisticRows f;
  SolveBufs s;
};

struct BwdArgs {
  LogisticRows f;
  ReplayBufs r;
};

template <bool kRecord, bool kWS, bool kRS>
__global__ void __launch_bounds__(kRowThreads, 1)
    logistic_node_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  LogisticRows f = a.f;
  long long t0 = 0, t_all = 0;
  (void)t0;
  (void)t_all;
  f.bind<kWS, kRS>(smem);
  f.clear_clocks();
  LCLOCK(t_all);
  LCLOCK(t0);
  f.load<kWS>();
  __syncthreads();
  LADD_F(0, t0);
  SolveBufs s = a.s;
  const int n = f.g.R * f.g.D;
  s.y = f.scaf;
  s.ks = f.scaf + n;
  s.u = f.scaf + 8 * n;
  adaptive_solve<kRecord, false, LogisticRows, RowSync>(f, s);
  LADD_F(kClockSlots - 1, t_all);
  f.store_clocks();
}

template <bool kWS, bool kRS>
__global__ void __launch_bounds__(kRowThreads, 1)
    logistic_node_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  LogisticRows f = a.f;
  long long t0 = 0, t_all = 0;
  (void)t0;
  (void)t_all;
  f.bind<kWS, kRS>(smem);
  f.clear_clocks();
  LCLOCK(t_all);
  LCLOCK(t0);
  f.load<kWS>();
  f.zero_grads();
  __syncthreads();
  LADD_F(0, t0);
  ReplayBufs r = a.r;
  const int n = f.g.R * f.g.D;
  r.lam = f.scaf;
  r.kbar = f.scaf + n;
  r.u = f.scaf + 7 * n;
  r.ub = f.scaf + 8 * n;
  adjoint_replay_impl<false, LogisticRows, RowSync>(f, r);
  __syncthreads();
  LCLOCK(t0);
  f.finish_grads();
  LADD_F(9, t0);
  LADD_F(kClockSlots - 1, t_all);
  f.store_clocks();
}

LogisticRows make_field(const float* av, const float* bv, const float* pw,
                        const float* pb, float* work, const Geo& g) {
  LogisticRows f{};
  f.av = av;
  f.bv = bv;
  f.pw = pw;
  f.pb = pb;
  f.work = work;
  f.g = g;
  return f;
}

// Launches kernel(args) as one cluster of g.C CTAs, or past grid_past rows
// as a cooperative grid of g.C CTAs (row_products.cuh).
template <class Args>
int launch_rows(void (*kernel)(Args), Args& args, const Geo& g,
                cudaStream_t stream) {
  const size_t bytes = (size_t)g.smem_floats * sizeof(float);
  if (g.grid)
    return launch_row_grid(kernel, args, g.C, kRowThreads, bytes,
                           kSmemBudget, stream);
  return launch_cluster(kernel, args, g.C, kRowThreads, bytes, kSmemBudget,
                        stream);
}

}  // namespace

// The plan of a launch at batch B, widths D, K, record length M (bwd: the
// backward's), one cluster up to grid_past rows: out[0..13] = grid form
// (0/1), C, R, rows a pass, dynamic shared-memory bytes, rows in shared
// memory (0/1), parameters in shared memory (0/1), device scratch floats,
// threads a CTA, and (backward) the gW pass's column slice, its tiles,
// its splits, its records a stage, the floats of a record row.
extern "C" void logistic_node_plan(int B, int D, int K, int M, int bwd,
                                   int grid_past, long long* out) {
  const Geo g = make_geo(B, D, K, M, bwd != 0, grid_past);
  out[0] = g.grid;
  out[1] = g.C;
  out[2] = g.R;
  out[3] = g.GR;
  out[4] = g.smem_floats * (long long)sizeof(float);
  out[5] = g.rows_smem;
  out[6] = g.w_smem;
  out[7] = g.work_floats;
  out[8] = kRowThreads;
  out[9] = g.LS;
  out[10] = g.T;
  out[11] = g.KS;
  out[12] = g.MC;
  out[13] = g.rec_row;
}

// h0 (B, D); a, b (L); W (D, L); bp (D) -> out (B, D) and, when record is
// nonzero, tda (M, 4), yrec (M, B, D), krec (M, 7, B, D), misc (4).
extern "C" int logistic_node_fwd(const float* h0, const float* av,
                                 const float* bv, const float* pw,
                                 const float* pb, float* out, float* tda,
                                 float* yrec, float* krec, float* misc,
                                 float* work, int B, int D, int K,
                                 int max_steps, float rtol, float atol,
                                 int record, int grid_past, void* stream) {
  if (B <= 0) return 0;
  const Geo g = make_geo(B, D, K, max_steps, false, grid_past);
  FwdArgs a{};
  a.f = make_field(av, bv, pw, pb, work, g);
  a.s.h0 = h0;
  a.s.out = out;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.part = work;
  a.s.N = B * D;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  a.s.D = D;
  a.s.R = g.R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.rows_smem)
    return record
               ? launch_rows(logistic_node_fwd_kernel<true, true, true>, a, g, s)
               : launch_rows(logistic_node_fwd_kernel<false, true, true>, a, g,
                             s);
  if (g.w_smem)
    return record
               ? launch_rows(logistic_node_fwd_kernel<true, true, false>, a, g,
                             s)
               : launch_rows(logistic_node_fwd_kernel<false, true, false>, a,
                             g, s);
  return record
             ? launch_rows(logistic_node_fwd_kernel<true, false, false>, a, g, s)
             : launch_rows(logistic_node_fwd_kernel<false, false, false>, a, g,
                           s);
}

// hbar (B, D) and the forward's records (M attempts' room) -> ga, gb (L),
// gW (D, L), gbp (D), h0bar (B, D).
extern "C" int logistic_node_bwd(const float* hbar, const float* tda,
                                 const float* yrec, const float* krec,
                                 const float* misc, const float* av,
                                 const float* bv, const float* pw,
                                 const float* pb, float* gav, float* gbv,
                                 float* gpw, float* gpb, float* h0bar,
                                 float* work, int B, int D, int K, int M,
                                 int grid_past, void* stream) {
  if (B <= 0) return 0;
  const Geo g = make_geo(B, D, K, M, true, grid_past);
  BwdArgs a{};
  a.f = make_field(av, bv, pw, pb, work, g);
  a.f.gav = gav;
  a.f.gbv = gbv;
  a.f.gpw = gpw;
  a.f.gpb = gpb;
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
  if (g.rows_smem)
    return launch_rows(logistic_node_bwd_kernel<true, true>, a, g, s);
  if (g.w_smem)
    return launch_rows(logistic_node_bwd_kernel<true, false>, a, g, s);
  return launch_rows(logistic_node_bwd_kernel<false, false>, a, g, s);
}
