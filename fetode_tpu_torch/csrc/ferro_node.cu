// Whole-solve kernels of the ECG ferro MLP-NODE latent field for Hopper
// (sm_90a): the forward dopri5 solve over [0, 1] (with or without
// per-attempt records) and the reverse replay, the discrete adjoint on
// the recorded step mesh, with optional frozen device noise, for P
// independent members (P = 1: the single solve) in one launch.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_ferro_node.py:416
// (make_ferro_node_solver: forward _make_fwd_kernel :87, backward
// _make_bwd_kernel :150; the batch-vectorized pair :259 / :309 is another
// TPU layout of the same function and maps to these kernels too), and the
// vmap of it over a population's members (fetode_tpu/train/ecg_driver.py:
// train_ecg_population with solver_mode "pallas"), where each member has
// its own weights, h0 batch, pre-scaled frozen noise and step control.
// The field, D -> H -> D with two ferro layers whose parameters are
// (out, L), L = in*K, l = i*K + k:
//
//   hb = h_bound tanh(y / h_bound)
//   z  = tanh(sum_l fb1[b, o, l] coef1[o, l])          (B, H)
//   dh = clip(sum_l fb2[b, o, l] coef2[o, l], -c, c)    (B, D)
//
// with the ferro term of the fresh frozen state (_ferro_rows :70):
// mu = sigmoid(g x), cn = sigmoid(g (-x - ec)), beta = alpha + (1 - alpha)
// (1 - 2 (1 - mu) cn), th = tanh(k (x + ec beta)), fb = ps th + bias
// (+ the frozen noise nz[b, o, l] when noisy, which reaches only the coef
// gradient).  Unlike the eager model field there is no nan_to_num, and the
// clip passes the gradient strictly inside (-c, c), as in the TPU kernel.
//
// The parameters stay put (parameter-stationary tiles).  Each layer's
// (o, l) elements are cut into tiles of RG output rows by CG input
// columns, RG * CG = 32 (every k of each column: l = i*K + k), RG chosen
// so that a row's sum and a column's sum cross about as few tiles each
// (slice_plan; ops/ferro_node.py mirrors it; 16 and 16 at the ECG
// widths).  Member m's tile q is the layer's tile Q = m * tiles + q, on
// block Q mod G, which keeps its five parameter arrays (and, in the
// backward, their five gradients) for the whole launch: in shared memory
// while the block's first tiles fit kSliceSmem, past that in device
// memory, each element still read and written by its one owner.  A work
// unit is an element of the block's tiles and a run of samples (8 samples
// a pass, the inputs of 64 formed at once): the backward's thread owns its
// elements and sums their gradients over the samples in order, the
// forward cuts the run to 4 samples so the units spread evenly over the
// threads; either way a parameter is read once for several samples.  The
// terms go to a shared buffer, where a warp a sample gives each (row,
// column) of the tile a lane that sums its K terms in order.  The forward
// adds a row's lanes in a fixed shuffle tree into the tile's partial of
// that row, and the consumer adds a row's partials in tile order; the
// backward adds a column's lanes the same way into the tile's partial of
// the input cotangent, added over the row groups in order.  No (B, out, L)
// staging tensor, no atomics: every output and gradient is the same bits
// on every run, and each gradient is written once, at the end.
//
// The solve takes node_common.cuh's fused-stage hook in its member form
// (adaptive_solve_members, adjoint_replay_members): the stage input u = y
// + dt sum_l a_jl k_l, the tanh bound and the sigmoid of the input are
// formed in layer 1's prologue, each block for the (m, b, i) its tiles
// read, straight from y, the stages and the partials of the stage still
// pending.  So an evaluation is two grid phases (layer 1, layer 2) and two
// barriers, and a VJP four: the two forward layers, layer 2's backward,
// layer 1's backward (the previous layer's partials form the input
// cotangent in each prologue).  Every consumer's sum starts all its loads
// at once and adds them in order.  The sigmoid's quotient is rcp_sigmoid
// (knot_quotient.cuh): IEEE's bits without the branch that serialised a
// lane's terms.
//
// The member form is one cooperative launch in lockstep, the simple one of
// the two possible: each grid phase runs the current stage for every member
// still stepping, a finished member's tiles skip their work while its
// blocks keep passing the barriers, and each member's error norm is its own
// reduction (node_common.cuh's member section).  Blocks split by member,
// with per-member barriers on counters in device memory, would let a
// finished member's blocks go idle sooner but need a second barrier
// mechanism; at the study's P = 12 every member starts together and the
// attempt counts differ by a few.  Since a member's tile sums run in tile
// order and its norm over a virtual grid that depends on N alone, member
// m's output, records, attempts and gradients are the bits of the P = 1
// launch on member m, wherever its tiles and elements land.
//
// What bounds it on this card: the special-function unit, by count.  At
// the ECG widths (D = 64, H = 128, K = 12, B = 8) an evaluation is 2 x 8
// x 98,304 ferro terms a member, each an expf, a reciprocal and a tanhf
// (about 4 SFU results), 0.75 us of the 132 SMs' SFUs a layer; a VJP
// evaluates the terms twice.  In practice the terms' instruction rate
// (about 60 a term in plain's rounding) sets the pace, then the barriers
// (two an evaluation, four a VJP, shared by all members) and the
// prologues' loads; with noise, each member's (B, out, L) noise read once
// an evaluation.

#include "knot_quotient.cuh"
#include "node_common.cuh"

namespace {

using namespace node_common;

constexpr int kMaxRow = 512;       // the latent and hidden widths, at most
constexpr int kChunk = kWarps;     // samples a term pass takes at once
constexpr int kRun = 4;            // samples a forward work unit takes
constexpr int kPro = 64;           // samples a prologue forms at once
constexpr int kLanes = 32;         // (row, column) pairs a tile holds
// Bytes of parameter (and gradient) tiles a block keeps in shared memory,
// so that two blocks of the largest layout still fit an SM; past it they
// stay in device memory, each element still read by its one owner.
constexpr long long kSliceSmem = 72 * 1024;
// Dynamic shared memory a block may take: the card's 227 KB less the
// static arrays of the scaffold's reductions and member scalars.
constexpr size_t kMaxDynamicSmem = 232448 - 2048;

// The block's dynamic shared memory and the members' scalars, read by the
// field's methods directly, so the field holds nothing set per block.
extern __shared__ __align__(16) float ferro_smem[];
__shared__ MemberCtl ferro_ctl;

__device__ __forceinline__ float ferro_sigmoid(float z) {
  return rcp_sigmoid(1.0f + expf(-z));
}

// floor(n / d) for 0 <= n < 2^16 and 1 <= d < 2^16 as one multiply-high
// by m = magic(d) (exact there: n (m d - 2^32) < d 2^16 <= 2^32).
__host__ __device__ inline unsigned magic(unsigned d) {
  return (unsigned)(0x100000000ULL / d) + 1u;
}
__device__ __forceinline__ int div_m(int n, unsigned m) {
  return (int)__umulhi((unsigned)n, m);
}

// How one layer (O outputs, I inputs, K bases) is cut into tiles.
struct SlicePlan {
  int O, I, K, L;
  int RG, CG;   // rows and columns of a tile, RG * CG = 32
  int NR, NC;   // row groups and column chunks
  int nsl;      // NR * NC tiles; tile q = rg * NC + cc
  int ns;       // tiles a block holds, at most, of one member
};

// RG the power of two that makes max(NR, NC) least (the partials a
// column's and a row's sum add), the smaller RG on a tie.
__host__ __device__ inline SlicePlan slice_plan(int G, int O, int I, int K) {
  SlicePlan p;
  p.O = O;
  p.I = I;
  p.K = K;
  p.L = I * K;
  int best = -1;
  for (int rg = 1; rg <= kLanes; rg *= 2) {
    const int cg = kLanes / rg;
    const int nr = (O + rg - 1) / rg, nc = (I + cg - 1) / cg;
    const int cost = nr > nc ? nr : nc;
    if (best < 0 || cost < best) {
      best = cost;
      p.RG = rg;
      p.CG = cg;
      p.NR = nr;
      p.NC = nc;
    }
  }
  p.nsl = p.NR * p.NC;
  p.ns = (p.nsl + G - 1) / G;
  return p;
}

// The block's shared-memory layout (floats) for G blocks and P members.
struct FerroGeo {
  SlicePlan p1, p2;  // layer 1 (H, D, K1), layer 2 (D, H, K2)
  int G, P, bwd;
  int SL1, SL2;      // floats of one parameter array of a tile
  int ns1, ns2;      // tiles of each layer a block holds, at most
  int sm1, sm2;      // of those, the first ones in shared memory
  int g_off, buf_off, xs_off, ms_off, wc_off, BS;
  long long smem_floats;
};

FerroGeo make_geo(int G, int P, int D, int H, int K1, int K2, bool bwd) {
  FerroGeo g{};
  g.G = G;
  g.P = P;
  g.bwd = bwd;
  g.p1 = slice_plan(G, H, D, K1);
  g.p2 = slice_plan(G, D, H, K2);
  g.ns1 = (P * g.p1.nsl + G - 1) / G;
  g.ns2 = (P * g.p2.nsl + G - 1) / G;
  g.SL1 = kLanes * K1;
  g.SL2 = kLanes * K2;
  // Tiles of both layers in equal numbers while they fit, then the rest.
  const long long f = bwd ? 2 : 1;
  const long long per1 = f * 5 * g.SL1, per2 = f * 5 * g.SL2;
  long long room = kSliceSmem / (long long)sizeof(float);
  const long long both = room / (per1 + per2);
  g.sm1 = (int)(both < g.ns1 ? both : g.ns1);
  g.sm2 = (int)(both < g.ns2 ? both : g.ns2);
  room -= g.sm1 * per1 + g.sm2 * per2;
  const long long more1 = room / per1;
  const int add1 = (int)(more1 < g.ns1 - g.sm1 ? more1 : g.ns1 - g.sm1);
  g.sm1 += add1;
  room -= add1 * per1;
  const long long more2 = room / per2;
  g.sm2 += (int)(more2 < g.ns2 - g.sm2 ? more2 : g.ns2 - g.sm2);
  const long long prm = 5LL * (g.sm1 * g.SL1 + g.sm2 * g.SL2);
  const int Km = K1 > K2 ? K1 : K2;
  g.BS = kLanes * (Km + 1);
  g.g_off = (int)prm;
  g.buf_off = (int)(f * prm);
  g.xs_off = g.buf_off + kChunk * g.BS;
  g.ms_off = g.xs_off + kPro * kLanes;
  g.wc_off = g.ms_off + kPro * kLanes;
  g.smem_floats = g.wc_off + kPro * kLanes;
  return g;
}

struct FerroLayer {
  const float* prm;  // (P, 5, out, L): k, ec, ps, bias, coef
  const float* nz;   // (P, B, out, L) frozen noise, or null
  float* grd;        // (P, 5, out, L) gradients, VJP only
  int out, K, L;
};

// One tile of a layer as this block holds it: member m's rows o0 .. o0 +
// RG - 1 and columns c0 .. c0 + CG - 1 (those inside the layer); element
// e = (r CG + c) K + k; parameter a of element e at prm[a * astride +
// off(e)], its gradient at grd[a * astride + off(e)], off(e) = e in shared
// memory and r L + c K + k in device memory.
struct Slice {
  const float* prm;
  float* grd;
  int astride, m, rg, cc, o0, c0, rows, cols;
  bool dev;
};

struct FerroField {
  FerroLayer l1, l2;
  int P, B, D, H, N;
  float gate, alpha, oma, c2;  // c2 = 2 gate (1 - alpha)
  float h_bound, inv_hb, dh_clip;
  float* part1;  // (P, B, H, NC1) layer 1's row partials
  float* part2;  // (P, B, D, NC2) layer 2's row partials
  float* px2;    // (P, B, H, NR2) layer 2's input-cotangent partials
  float* px1;    // (P, B, D, NR1) layer 1's input-cotangent partials
  FerroGeo geo;

  __device__ __forceinline__ Slice slice(int layer, int slot) const {
    const FerroLayer& P_ = layer == 1 ? l1 : l2;
    const SlicePlan& pl = layer == 1 ? geo.p1 : geo.p2;
    const int Q = blockIdx.x + slot * geo.G;
    Slice sl;
    sl.m = Q / pl.nsl;
    const int q = Q - sl.m * pl.nsl;
    sl.rg = q / pl.NC;
    sl.cc = q - sl.rg * pl.NC;
    sl.o0 = sl.rg * pl.RG;
    sl.c0 = sl.cc * pl.CG;
    sl.rows = min(pl.RG, pl.O - sl.o0);
    sl.cols = min(pl.CG, pl.I - sl.c0);
    sl.dev = slot >= (layer == 1 ? geo.sm1 : geo.sm2);
    if (!sl.dev) {
      const int SL = layer == 1 ? geo.SL1 : geo.SL2;
      const int off = layer == 1 ? slot * 5 * SL
                                 : 5 * geo.sm1 * geo.SL1 + slot * 5 * SL;
      sl.prm = ferro_smem + off;
      sl.grd = ferro_smem + geo.g_off + off;
      sl.astride = SL;
    } else {
      const size_t at = (size_t)sl.m * 5 * P_.out * P_.L +
                        (size_t)sl.o0 * P_.L + sl.c0 * P_.K;
      sl.prm = P_.prm + at;
      sl.grd = P_.grd ? P_.grd + at : nullptr;
      sl.astride = P_.out * P_.L;
    }
    return sl;
  }

  __device__ __forceinline__ int slots(int layer) const {
    const SlicePlan& pl = layer == 1 ? geo.p1 : geo.p2;
    return (P * pl.nsl - (int)blockIdx.x + geo.G - 1) / geo.G;
  }

  // Element e of a tile: its lane q, row r and column c, whether it lies
  // inside the layer, and its offset in the device arrays from the tile's
  // corner.  mK = magic(K); CG is a power of two, 2^lcg.
  __device__ __forceinline__ bool element(const Slice& sl, const SlicePlan& pl,
                                          unsigned mK, int lcg, int e, int& q,
                                          int& r, int& c, int& dev_off) const {
    q = div_m(e, mK);
    const int k = e - q * pl.K;
    r = q >> lcg;
    c = q - (r << lcg);
    dev_off = r * pl.L + c * pl.K + k;
    return r < sl.rows && c < sl.cols;
  }

  // The tiles held in shared memory loaded, and the gradients zeroed.
  __device__ void load() const {
    for (int layer = 1; layer <= 2; ++layer) {
      const FerroLayer& P_ = layer == 1 ? l1 : l2;
      const SlicePlan& pl = layer == 1 ? geo.p1 : geo.p2;
      const size_t n = (size_t)P_.out * P_.L;
      for (int k = 0; k < slots(layer); ++k) {
        const Slice sl = slice(layer, k);
        const float* src = P_.prm + (size_t)sl.m * 5 * n +
                           (size_t)sl.o0 * P_.L + sl.c0 * P_.K;
        const unsigned mK = magic(P_.K);
        const int lcg = __ffs(pl.CG) - 1;
        for (int e = threadIdx.x; e < kLanes * P_.K; e += blockDim.x) {
          int q, r, c, off;
          if (!element(sl, pl, mK, lcg, e, q, r, c, off)) continue;
          const int i = sl.dev ? off : e;
#pragma unroll
          for (int a = 0; a < 5; ++a) {
            if (!sl.dev)
              const_cast<float*>(sl.prm)[a * sl.astride + e] = src[a * n + off];
            if (geo.bwd) sl.grd[a * sl.astride + i] = 0.0f;
          }
        }
      }
    }
  }

  // The gradients held in shared memory to the outputs, by their owners.
  __device__ void store() const {
    for (int layer = 1; layer <= 2; ++layer) {
      const FerroLayer& P_ = layer == 1 ? l1 : l2;
      const SlicePlan& pl = layer == 1 ? geo.p1 : geo.p2;
      const size_t n = (size_t)P_.out * P_.L;
      for (int k = 0; k < slots(layer); ++k) {
        const Slice sl = slice(layer, k);
        if (sl.dev) continue;
        float* dst = P_.grd + (size_t)sl.m * 5 * n + (size_t)sl.o0 * P_.L +
                     sl.c0 * P_.K;
        const unsigned mK = magic(P_.K);
        const int lcg = __ffs(pl.CG) - 1;
        for (int e = threadIdx.x; e < kLanes * P_.K; e += blockDim.x) {
          int q, r, c, off;
          if (!element(sl, pl, mK, lcg, e, q, r, c, off)) continue;
#pragma unroll
          for (int a = 0; a < 5; ++a)
            dst[a * n + off] = sl.grd[a * sl.astride + e];
        }
      }
    }
  }

  // Member m's layer-2 pending output at element e, unclipped and clipped;
  // z of layer 1's row (b, o); each the row's partials added in tile order.
  __device__ __forceinline__ float dh_at(int m, int e) const {
    return ordered_sum(part2 + ((size_t)m * N + e) * geo.p2.NC, geo.p2.NC);
  }
  __device__ __forceinline__ float pend(int m, int e) const {
    return fminf(fmaxf(dh_at(m, e), -dh_clip), dh_clip);
  }
  __device__ __forceinline__ float z_at(int m, int b, int o) const {
    return tanhf(ordered_sum(
        part1 + (((size_t)m * B + b) * H + o) * geo.p1.NC, geo.p1.NC));
  }
  __device__ __forceinline__ float bound(float u) const {
    return h_bound * tanhf(u * inv_hb);
  }

  // One layer over the block's tiles of the members that are on.
  // xf(m, b, i): the layer's input; kBwd: wf(m, b, o) the output
  // cotangent, the five gradients accumulated and each column's partial of
  // the input cotangent written to member m's part of `out` (B, in, NR);
  // else each row's partial to member m's part of `out` (B, out, NC).
  template <bool kBwd, class XF, class WF>
  __device__ __forceinline__ void layer(int which, const XF& xf, const WF& wf,
                                        float* out) const {
    const FerroLayer& P_ = which == 1 ? l1 : l2;
    const SlicePlan& pl = which == 1 ? geo.p1 : geo.p2;
    const int K = P_.K, BS = geo.BS, CG = pl.CG, RG = pl.RG;
    float* buf = ferro_smem + geo.buf_off;
    float* xs = ferro_smem + geo.xs_off;
    float* ms = ferro_smem + geo.ms_off;
    float* wc = ferro_smem + geo.wc_off;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lr = lane / CG, lc = lane - lr * CG;
    const unsigned mK = magic(K), mSL = magic(kLanes * K);
    const int lcg = __ffs(CG) - 1;
    const size_t out_stride =
        (size_t)B * (kBwd ? pl.I * pl.NR : pl.O * pl.NC);
    for (int k = 0; k < slots(which); ++k) {
      const Slice sl = slice(which, k);
      const int m = sl.m;
      if (!ferro_ctl.on[m]) continue;
      const float* nzs =
          P_.nz ? P_.nz + (size_t)m * B * P_.out * P_.L +
                      (size_t)sl.o0 * P_.L + sl.c0 * K
                : nullptr;
      float* om = out + m * out_stride;
      const bool lane_in = lr < sl.rows && lc < sl.cols;
      for (int p0 = 0; p0 < B; p0 += kPro) {
        // The inputs (and cotangents) of up to kPro samples at once, so a
        // prologue's loads are one round trip for all of them.
        const int np = min(kPro, B - p0);
        for (int i = threadIdx.x; i < np * CG; i += blockDim.x) {
          const int bb = i / CG, c = i - bb * CG;
          if (c >= sl.cols) continue;
          const float x = xf(m, p0 + bb, sl.c0 + c);
          xs[bb * CG + c] = x;
          ms[bb * CG + c] = ferro_sigmoid(gate * x);
        }
        if constexpr (kBwd)
          for (int i = threadIdx.x; i < np * RG; i += blockDim.x) {
            const int bb = i / RG, r = i - bb * RG;
            if (r < sl.rows) wc[bb * RG + r] = wf(m, p0 + bb, sl.o0 + r);
          }
        __syncthreads();
        for (int b0 = 0; b0 < np; b0 += kChunk) {
          const int nb = min(kChunk, np - b0);
          // A work unit is an element and a run of the chunk's samples: the
          // backward's run is the whole chunk, whose gradients it sums in
          // order; the forward, which sums nothing per element, cuts the
          // chunk into runs of kRun so the units spread evenly.
          const int run = kBwd ? kChunk : kRun, SLt = kLanes * K;
          const int units = SLt * ((nb + run - 1) / run);
          for (int u = threadIdx.x; u < units; u += blockDim.x) {
            const int h = div_m(u, mSL), e = u - h * SLt;
            int q, r, c, off;
            if (!element(sl, pl, mK, lcg, e, q, r, c, off)) continue;
            const int s0 = h * run, s1 = min(nb, s0 + run);
            const int i = sl.dev ? off : e;
            const int a = sl.astride;
            const float fk = sl.prm[i], ec = sl.prm[a + i];
            const float ps = sl.prm[2 * a + i], bias = sl.prm[3 * a + i];
            const float coef = sl.prm[4 * a + i];
            float nzv[kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              nzv[j] = (nzs && s0 + j < s1)
                  ? nzs[(size_t)(p0 + b0 + s0 + j) * P_.out * P_.L + off] : 0.0f;
            float gk = 0.0f, gec = 0.0f, gps = 0.0f, gbias = 0.0f;
            float gcoef = 0.0f;
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              const int bb = s0 + j;
              if (bb >= s1) break;
              const int sb = b0 + bb;
              const float x = xs[sb * CG + c], mu = ms[sb * CG + c];
              const float cn = ferro_sigmoid(gate * (-x - ec));
              const float beta =
                  alpha + oma * (1.0f - 2.0f * ((1.0f - mu) * cn));
              const float th = tanhf(fk * (x + ec * beta));
              float fb = ps * th + bias;
              if (nzs) fb += nzv[j];
              float v;
              if constexpr (kBwd) {
                const float wv = wc[sb * RG + r];
                gcoef += fb * wv;
                const float fbar = coef * wv;
                const float sech2 = 1.0f - th * th;
                gps += th * fbar;
                gbias += fbar;
                gk += ps * (x + ec * beta) * sech2 * fbar;
                const float common = ps * fk * sech2 * fbar;
                const float dbeta_dec = c2 * (1.0f - mu) * cn * (1.0f - cn);
                const float dbeta_dx =
                    c2 * (1.0f - mu) * cn * (mu + 1.0f - cn);
                gec += common * (beta + ec * dbeta_dec);
                v = common * (1.0f + ec * dbeta_dx);
              } else {
                v = fb * coef;
              }
              buf[bb * BS + e + q] = v;  // lane q's terms at q (K + 1)
            }
            if constexpr (kBwd) {
              sl.grd[i] += gk;
              sl.grd[a + i] += gec;
              sl.grd[2 * a + i] += gps;
              sl.grd[3 * a + i] += gbias;
              sl.grd[4 * a + i] += gcoef;
            }
          }
          __syncthreads();
          for (int w = warp; w < nb; w += kWarps) {
            const int b = p0 + b0 + w;
            float v = 0.0f;
            if (lane_in) {
              const float* t = buf + w * BS + lane * (K + 1);
              v = t[0];
              for (int kk = 1; kk < K; ++kk) v += t[kk];
            }
            if constexpr (kBwd) {
              for (int d = kLanes / 2; d >= CG; d >>= 1)
                v += __shfl_down_sync(0xffffffffu, v, d);
              if (lr == 0 && lc < sl.cols)
                om[((size_t)b * pl.I + sl.c0 + lc) * pl.NR + sl.rg] = v;
            } else {
              for (int d = CG / 2; d >= 1; d >>= 1)
                v += __shfl_down_sync(0xffffffffu, v, d, CG);
              if (lc == 0 && lr < sl.rows)
                om[((size_t)b * pl.O + sl.o0 + lr) * pl.NC + sl.cc] = v;
            }
          }
          __syncthreads();
        }
      }
    }
  }

  // f(u) of the stage for every member on, left pending in part2.
  __device__ void stage(const MemberStageIn& in) const {
    if (in.pending >= 0)
      member_for_each(ferro_ctl, P, N, [&](int m, int e) {
        in.pending_stage(m)[e] = pend(m, e);
      });
    auto none = [](int, int, int) { return 0.0f; };
    layer<false>(1, [&](int m, int b, int i) {
      return bound(stage_input(in.member(m), b * D + i,
                               [&](int q) { return pend(m, q); }));
    }, none, part1);
    cg::this_grid().sync();
    layer<false>(2, [&](int m, int b, int i) { return z_at(m, b, i); }, none,
                 part2);
  }

  __device__ __forceinline__ float take(int m, int e, float* dst) const {
    const float v = pend(m, e);
    dst[e] = v;
    return v;
  }

  // The VJP of stage j at its recorded input, cotangent in.w, for every
  // member on; ubar left pending in px1.  Layer 2's output passes the
  // cotangent strictly inside (-c, c), as the plain field's clip.
  __device__ void vjp_stage(const MemberVjpIn& in) const {
    auto none = [](int, int, int) { return 0.0f; };
    auto hb = [&](int m, int b, int i) {
      return bound(record_input(in.member(m), b * D + i));
    };
    auto zf = [&](int m, int b, int i) { return z_at(m, b, i); };
    cg::grid_group grid = cg::this_grid();
    layer<false>(1, hb, none, part1);
    grid.sync();
    layer<false>(2, zf, none, part2);
    grid.sync();
    layer<true>(2, zf, [&](int m, int b, int o) {
      const float dh = dh_at(m, b * D + o);
      return (dh > -dh_clip && dh < dh_clip)
                 ? ld(in.member(m).w + b * D + o) : 0.0f;
    }, px2);
    grid.sync();
    layer<true>(1, hb, [&](int m, int b, int o) {
      const float s = ordered_sum(
          px2 + (((size_t)m * B + b) * H + o) * geo.p2.NR, geo.p2.NR);
      const float z = z_at(m, b, o);
      return s * (1.0f - z * z);
    }, px1);
  }

  __device__ __forceinline__ float take_ub(int m, int e,
                                           const VjpIn& in) const {
    const float v = bound(record_input(in, e)) * inv_hb;
    const float s =
        ordered_sum(px1 + ((size_t)m * N + e) * geo.p1.NR, geo.p1.NR);
    return s * (1.0f - v * v);
  }
};

struct FwdArgs {
  FerroField f;
  MemberSolveBufs s;
};

struct BwdArgs {
  FerroField f;
  MemberReplayBufs r;
};

// The forward works on a copy of the field; the backward reads it where the
// launch put it (__grid_constant__: no copy a thread).  Each is the faster
// of the two forms on the H100 at B = 8 (PERF.md, the member form's
// findings): the backward 18% faster read in place, the forward 6% slower
// so.
template <bool kRecord>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    ferro_node_fwd_kernel(FwdArgs a) {
  const FerroField f = a.f;
  f.load();
  __syncthreads();
  adaptive_solve_members<kRecord>(f, a.s, ferro_ctl);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    ferro_node_bwd_kernel(const __grid_constant__ BwdArgs a) {
  const FerroField& f = a.f;
  f.load();
  cg::this_grid().sync();  // device-memory gradients zeroed by their owners
  adjoint_replay_members(f, a.r, ferro_ctl);
  f.store();
}

// Scratch layout in `work` (floats), PN = P*B*D: the scaffold's state,
// stages and step input (forward: y PN, ks 7PN, u PN; backward: lam PN,
// kbar 6PN) in 9PN, then its member sums; part1 (P*B*H*NC1) and part2
// (P*B*D*NC2); then, for the backward only, px2 (P*B*H*NR2) and px1
// (P*B*D*NR1).
struct WorkLayout {
  size_t part, part1, part2, px2, px1, total;
};

WorkLayout work_layout(int P, int B, int D, int H, int K1, int K2, bool bwd) {
  const SlicePlan p1 = slice_plan(1, H, D, K1), p2 = slice_plan(1, D, H, K2);
  const size_t N = (size_t)B * D, PN = (size_t)P * N;
  WorkLayout w;
  w.part = 9 * PN;
  w.part1 = w.part + 2 * kMaxSums * (size_t)P * member_vblocks((int)N);
  w.part2 = w.part1 + (size_t)P * B * H * p1.NC;
  w.px2 = w.part2 + (size_t)P * B * D * p2.NC;
  w.px1 = w.px2 + (bwd ? (size_t)P * B * H * p2.NR : 0);
  w.total = w.px1 + (bwd ? (size_t)P * B * D * p1.NR : 0);
  return w;
}

FerroLayer make_layer(const float* prm, const float* nz, float* grads,
                      int out, int in, int K) {
  FerroLayer p{};
  p.prm = prm;
  p.nz = nz;
  p.grd = grads;
  p.out = out;
  p.K = K;
  p.L = in * K;
  return p;
}

FerroField make_field(const float* prm1, const float* prm2, const float* nz1,
                      const float* nz2, float* g1, float* g2, float* work,
                      const WorkLayout& w, int P, int B, int D, int H, int K1,
                      int K2, float gate, float alpha, float oma, float c2,
                      float h_bound, float dh_clip) {
  FerroField f{};
  f.l1 = make_layer(prm1, nz1, g1, H, D, K1);
  f.l2 = make_layer(prm2, nz2, g2, D, H, K2);
  f.P = P;
  f.B = B;
  f.D = D;
  f.H = H;
  f.N = B * D;
  f.gate = gate;
  f.alpha = alpha;
  f.oma = oma;
  f.c2 = c2;
  f.h_bound = h_bound;
  f.inv_hb = 1.0f / h_bound;
  f.dh_clip = dh_clip;
  f.part1 = work + w.part1;
  f.part2 = work + w.part2;
  f.px2 = work + w.px2;
  f.px1 = work + w.px1;
  return f;
}

// Launches kernel(args) on the cooperative grid (node_common.cuh:
// launch_grid), the plan for that grid into args.f.geo.
template <class Args>
int launch_ferro(void (*kernel)(Args), Args& args, bool bwd,
                 cudaStream_t stream) {
  const FerroField& f = args.f;
  return launch_grid(kernel, args, [&](int G) {
    args.f.geo = make_geo(G, f.P, f.D, f.H, f.l1.K, f.l2.K, bwd);
    return (size_t)args.f.geo.smem_floats * sizeof(float);
  }, kMaxDynamicSmem, stream);
}

bool bad_shape(int P, int B, int D, int H) {
  return P < 1 || P > kMaxMembers || B <= 0 || D > kMaxRow || H > kMaxRow;
}

}  // namespace

// The tile plan of one layer (O outputs, I inputs, K bases) for G
// blocks: out[0..5] = RG, CG, NR, NC, tiles, tiles a block holds at most.
extern "C" void ferro_node_slice_plan(int G, int O, int I, int K,
                                      long long* out) {
  const SlicePlan p = slice_plan(G, O, I, K);
  out[0] = p.RG;
  out[1] = p.CG;
  out[2] = p.NR;
  out[3] = p.NC;
  out[4] = p.nsl;
  out[5] = p.ns;
}

// The grid the kernels take on this card, at most (SMs x kBlocksPerSM).
extern "C" int ferro_node_grid() {
  int G = 0;
  if (grid_blocks(&G, kBlocksPerSM) != 0) return -1;
  return G > kMaxBlocks ? kMaxBlocks : G;
}

// The most members one launch takes.
extern "C" int ferro_node_max_members() { return kMaxMembers; }

extern "C" long long ferro_node_work_floats(int P, int B, int D, int H,
                                            int K1, int K2, int bwd) {
  return (long long)work_layout(P, B, D, H, K1, K2, bwd != 0).total;
}

// P members at once.  h0 (P, B, D); prm1 (P, 5, H, D*K1) and prm2 (P, 5,
// D, H*K2), each member's arrays k, ec, ps, bias, coef of each layer; nz1
// (P, B, H, D*K1) and nz2 (P, B, D, H*K2), or null -> out (P, B, D) and,
// when record is nonzero, tda (P, M, 4), yrec (P, M, B, D), krec (P, M, 7,
// B, D), misc (P, 4), M = max_steps.
extern "C" int ferro_node_fwd(const float* h0, const float* prm1,
                              const float* prm2, const float* nz1,
                              const float* nz2, float* out, float* tda,
                              float* yrec, float* krec, float* misc,
                              float* work, int P, int B, int D, int H, int K1,
                              int K2, int max_steps, float rtol, float atol,
                              float gate, float alpha, float oma, float c2,
                              float h_bound, float dh_clip, int record,
                              void* stream) {
  if (bad_shape(P, B, D, H)) return (int)cudaErrorInvalidValue;
  const WorkLayout w = work_layout(P, B, D, H, K1, K2, false);
  FwdArgs a{};
  a.f = make_field(prm1, prm2, nz1, nz2, nullptr, nullptr, work, w, P, B, D,
                   H, K1, K2, gate, alpha, oma, c2, h_bound, dh_clip);
  const size_t PN = (size_t)P * B * D;
  a.s.h0 = h0;
  a.s.out = out;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.y = work;
  a.s.ks = work + PN;
  a.s.u = work + 8 * PN;
  a.s.part = work + w.part;
  a.s.P = P;
  a.s.N = B * D;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_ferro(ferro_node_fwd_kernel<true>, a, false, s)
                : launch_ferro(ferro_node_fwd_kernel<false>, a, false, s);
}

// hbar (P, B, D) and the forward's records (M = max_steps) -> g1 (P, 5,
// H, D*K1), g2 (P, 5, D, H*K2), h0bar (P, B, D).
extern "C" int ferro_node_bwd(const float* hbar, const float* tda,
                              const float* yrec, const float* krec,
                              const float* misc, const float* prm1,
                              const float* prm2, const float* nz1,
                              const float* nz2, float* g1, float* g2,
                              float* h0bar, float* work, int P, int B, int D,
                              int H, int K1, int K2, int max_steps,
                              float gate, float alpha, float oma, float c2,
                              float h_bound, float dh_clip, void* stream) {
  if (bad_shape(P, B, D, H)) return (int)cudaErrorInvalidValue;
  const WorkLayout w = work_layout(P, B, D, H, K1, K2, true);
  BwdArgs a{};
  a.f = make_field(prm1, prm2, nz1, nz2, g1, g2, work, w, P, B, D, H, K1, K2,
                   gate, alpha, oma, c2, h_bound, dh_clip);
  const size_t PN = (size_t)P * B * D;
  a.r.hbar = hbar;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = h0bar;
  a.r.lam = work;
  a.r.kbar = work + PN;
  a.r.P = P;
  a.r.N = B * D;
  a.r.max_steps = max_steps;
  return launch_ferro(ferro_node_bwd_kernel, a, true,
                      static_cast<cudaStream_t>(stream));
}
