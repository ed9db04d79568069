// The KAN layer's spline term for Hopper (sm_90a): the B-spline basis of
// every input and its product with the scaled spline weights, forward
// only.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_spline.py:65
// (spline_matmul_fused, its pallas_call :117, kernel body _kernel :42).
// With x (R, I), the knot rows grid (I, NK) and the scaled spline weight
// w (O, I, C), C = NK - 1 - order:
//
//   y[b, o] = sum_i sum_c B_c(x[b, i]; grid[i]) w[o, i, c]
//
// where B_c is the degree-`order` Cox-de Boor basis on feature i's own
// knots, with half-open intervals: an x outside [grid[i, 0], grid[i,
// NK-1]) and an x on the last knot give zero bases (ops/bsplines.py:48).
// The bases are plain's (ops/bsplines.py: bspline_basis) bit for bit:
// each is rounded as plain rounds it, one IEEE operation at a time in its
// order (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction) and each
// quotient by knot_quotient.cuh's div_knot, IEEE's bits without nvcc's
// branch to its slow path (with the branch each quotient closed a region
// the scheduler could not move work across, and the bases of a pair ran
// one quotient after another: as long as the product).
// For an x inside the knots only the order + 1 bases on its knot interval
// m are nonzero, and at each level of the recursion only the terms j = m
// - k .. m: the kernel computes just those (the terms outside are +0 in
// plain, whose products with +0 leave the sums unchanged), 9 instead of
// 27 at order 3.  A finite x off the knots has +0 bases in plain at every
// level, and the kernel writes zeros.  A NaN or infinite x lies in no
// interval, and plain's first level multiplies a NaN or infinite quotient
// by those zeros: every basis is NaN from order 1 on (zero at order 0),
// and the kernel writes that.  This holds for strictly increasing knots,
// as make_grid gives, and quotients that do not overflow.  Only the
// product's order of summation differs from plain's.
//
// What bounds it on this card: the product's 2 R I C O FP32 operations
// (0.040 ms at R = 2,560, I = O = 256, C = 8, at 67 TFLOP/s) against x,
// the weights and y moved once (2.8 MB there, 0.0008 ms at 3.35 TB/s): the
// FP32 units, at every shape the paths launch.  What holds this form
// above that bound: at R = 2,560 each chunk's weight tile comes from L2
// again for every row tile (40 reads of the 2 MB weight), and the 4 x 16
// tile's shared-memory reads need 1.25 times the FMA rate's cycles (a
// float4 read costs four wavefronts however many threads share it); at
// the small shapes (R = 64-128) a chunk's fixed costs (two barriers, the
// bases' dependent quotients, the load's latency) and the cluster's
// reduction set the time.  PERF.md (Findings, B.12) has the times.
//
// Layout.  256 threads a CTA, a 16 x 16 grid of threads, each with a TM x
// TN register tile: rows ty + 16 i, outputs tx + 16 j.  A warp is 4 rows
// by 8 outputs of that grid, so each float4 read of the bases touches 4
// rows and each of the weights 8 outputs, rows padded to BK + 4 floats:
// every shared-memory read is a bank-conflict-free float4, and a thread
// does 16 TM TN FMAs for TM + TN of them.  A CTA owns BM = 16 TM rows, BN
// = 16 TN outputs and one input group:
//  * TN follows O (the smallest of 1, 2, 4, 8, 16 with 16 TN >= O: one
//    output tile of 256 at O = 256 and 168, 64 at O = 56 and 64, 16 at O =
//    10), so the bases of a row tile are formed once for every output the
//    CTA owns; TM follows R (4 when that makes a CTA for each SM, else 2,
//    else 1; at TM = 1 TN halves down to 4 while the CTAs are fewer than
//    the SMs, as at R = 80).  TM = 1 leaves the shared-memory reads at
//    about half the FMA rate, TM >= 2 below it.
//  * The group's features are walked in chunks of BK columns (BK / C
//    features): BK = 32 for TN >= 8, so the wide CTA needs 95 KB and two
//    fit an SM; 64 / 128 for TN = 4 and 128 / 256 for TN <= 2 (TM >= 2 /
//    TM = 1), so that a narrow tile's few FMAs a chunk do not leave the
//    chunk's fixed costs to set the time (MNIST's head: 7 chunks a CTA, not
//    25).  Each chunk's weight tile (BN rows of BK contiguous floats:
//    16-byte cp.async when the weight's rows are 16-byte aligned, as the
//    serving chain's column slices are, else 4-byte cp.async), its x
//    columns and its knot rows load into a two-stage ring with cp.async
//    while the chunk before forms its bases and runs its FMAs.  The CTA's
//    threads form the chunk's bases once, one (row, feature) pair a
//    thread, into one of two bases tiles (so a chunk takes two barriers,
//    not three), and every thread runs its tile's FMAs over them.  The
//    bases run without branches: the knot interval is a predicated count,
//    the window's knots load at once, each term is kept or dropped by a
//    select, and each quotient is knot_quotient.cuh's div_knot.
//  * Split-K over a thread-block cluster: the G input groups of one
//    output tile are the G CTAs of a cluster (G = 1, 2, 4 or 8, the most
//    that leaves each group at least 64 columns; 8, the portable cluster
//    size, at I = 128 .. 1,568, where a CTA walks its share of the
//    features in a fixed order).  Each CTA leaves its partial tile in its
//    shared memory; after a cluster barrier each CTA owns 1/G of the tile
//    and adds the G partials of each of its outputs through distributed
//    shared memory in order g = 0..G-1, then a second barrier keeps every
//    CTA's memory alive until the others have read it.  No scratch in
//    device memory, no second launch, no atomics.
//
// The order of every sum is set by (I, C) alone: group g holds features
// [g I / G, (g+1) I / G), each thread adds its output's products over the
// group's (feature, basis) columns in order with FP32 FMAs (no TF32, no
// tensor cores), and the groups are added in order g = 0..G-1.  Tiles,
// chunk width and the grid follow R and O, which changes no sum: the
// padding columns of a chunk hold zero bases and zero weights, whose
// products add +0 to a sum that is never -0.  So a row gives the same
// bits alone and inside a batch of 2,560.  x and the grid may be
// row-strided (the cond-diffusion chain passes column slices of a layer's
// weight); their last dimension must be contiguous, and the weight's
// (feature, basis) block too (stride C on the feature dimension).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "knot_quotient.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKnots = 16;
constexpr int kMaxOrder = 5;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMinGroupCols = 64;  // (feature, basis) columns a group

struct Args {
  const float* x;     // (R, I), row stride sx
  const float* grid;  // (I, NK), row stride sg
  const float* w;     // (O, I, C), strides so, C, 1
  float* y;           // (R, O), contiguous
  long long sx, sg, so;
  int R, I, O, NK, order, C, G;
  int vec;            // the weight's rows take 16-byte copies
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The order + 1 bases of an x in the knot interval [g[m], g[m+1]): v[r]
// is B_{m - order + r}, r = 0..order.  Level k holds the terms j = m - k
// + r, r = 0..k, each as plain computes it from the level below, whose
// terms outside the window are +0; a term j outside plain's range (j < 0
// or j > nk - 2 - k) is 0 and never read for a valid basis.  The knots
// g[m - MAXO .. m + MAXO + 1] (clamped to the row) load at once, and each
// term is computed and kept or dropped by a select, so the terms of a
// level overlap (a valid term reads only unclamped knots).
template <int MAXO>
__device__ __forceinline__ void bases_window(float x, const float* g, int nk,
                                             int order, int m,
                                             float (&v)[MAXO + 1]) {
  float gw[2 * MAXO + 2];
#pragma unroll
  for (int o = -MAXO; o <= MAXO + 1; ++o)
    gw[o + MAXO] = g[min(max(m + o, 0), nk - 1)];
  v[0] = 1.0f;
#pragma unroll
  for (int k = 1; k <= MAXO; ++k) {
    if (k > order) break;
#pragma unroll
    for (int r = MAXO; r >= 0; --r) {   // descending: v[r], v[r-1] still old
      if (r > k) continue;
      const int d = r - k;              // j - m
      const float oj = r >= 1 ? v[r - 1] : 0.0f;
      const float oj1 = r <= k - 1 ? v[r] : 0.0f;
      const float gj = gw[MAXO + d], gj1 = gw[MAXO + d + 1];
      const float gjk = gw[MAXO + d + k], gjk1 = gw[MAXO + d + k + 1];
      const float left = div_knot(__fsub_rn(x, gj), __fsub_rn(gjk, gj));
      const float right = div_knot(__fsub_rn(gjk1, x),
                                   __fsub_rn(gjk1, gj1));
      const float nv = __fadd_rn(__fmul_rn(left, oj), __fmul_rn(right, oj1));
      const int j = m + d;
      v[r] = j >= 0 && j <= nk - 2 - k ? nv : 0.0f;
    }
  }
}

// The input groups of a layer (the cluster's CTAs), a function of I and C
// alone: the most of 1, 2, 4, 8 that leaves each at least kMinGroupCols
// columns.
__host__ __device__ inline int groups_of(int I, int C) {
  int g = 1;
  while (g < kMaxCluster && (long long)I * C >= 2LL * g * kMinGroupCols)
    g *= 2;
  return g;
}

template <int TM, int TN>
struct Tile {
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  // columns a chunk, at most: wide chunks where the output tile is narrow,
  // so that its few FMAs a chunk do not leave the chunk's fixed costs
  // (barriers, the bases' latency) to set the time
  static constexpr int BK = TN >= 8 ? 32 : TN == 4 ? (TM >= 2 ? 64 : 128)
                                                   : (TM >= 2 ? 128 : 256);
  static constexpr int LDK = BK + 4;             // padded row of a chunk
  static constexpr int MAXF = BK / 4;            // features a chunk, at most
  // one ring stage: the weight tile (BN, LDK), x (MAXF, BM), the knots
  // (MAXF, kMaxKnots); then two bases tiles (BM, LDK)
  static constexpr int kStage = BN * LDK + MAXF * BM + MAXF * kMaxKnots;
  static constexpr int kFloats = 2 * kStage + 2 * BM * LDK;
  static_assert(BM * BN <= kFloats, "the partial tile reuses the ring");
  static_assert(kFloats * sizeof(float) <= 232448, "a CTA's shared memory");
};

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2) spline_kernel(Args a) {
  using T = Tile<TM, TN>;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDK = T::LDK;
  constexpr int MAXF = T::MAXF, kStage = T::kStage;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const bs0 = smem + 2 * kStage;   // the chunks' bases (2, BM, LDK)
  cg::cluster_group cluster = cg::this_cluster();
  const int G = a.G;
  const int g = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / G) * BM, o0 = blockIdx.y * BN;
  const int C = a.C, NK = a.NK, order = a.order;
  const int FI = min(BK / C, MAXF), KC = FI * C, KCp = (KC + 3) & ~3;
  const int f_lo = static_cast<int>((long long)g * a.I / G);
  const int f_hi = static_cast<int>((long long)(g + 1) * a.I / G);
  const int nch = (f_hi - f_lo + FI - 1) / FI;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);     // outputs tx + 16 j
  const int ty = (warp >> 1) * 4 + (lane >> 3);   // rows ty + 16 i

  // Chunk c's weight tile, x columns and knots into ring stage s.
  auto load = [&](int c, int s) {
    float* const ws = smem + s * kStage;
    float* const xs = ws + BN * LDK;
    float* const gs = xs + MAXF * BM;
    const int i0 = f_lo + c * FI, nf = min(FI, f_hi - i0);
    const int valid = nf * C;
    if (a.vec) {
      const int q4 = KCp / 4;
      for (int q = t; q < BN * q4; q += kThreads) {
        const int n = q / q4, k = 4 * (q - n * q4), o = o0 + n;
        const int bytes = o < a.O ? 4 * max(0, min(4, valid - k)) : 0;
        cp_async16(ws + n * LDK + k,
                   bytes ? a.w + o * a.so + (long long)i0 * C + k : a.w,
                   bytes);
      }
    } else {
      for (int q = t; q < BN * KCp; q += kThreads) {
        const int n = q / KCp, k = q - n * KCp, o = o0 + n;
        const bool in = o < a.O && k < valid;
        cp_async4(ws + n * LDK + k,
                  in ? a.w + o * a.so + (long long)i0 * C + k : a.w,
                  in ? 4 : 0);
      }
    }
    for (int q = t; q < FI * BM; q += kThreads) {
      const int f = q / BM, m = q - f * BM, row = row0 + m;
      const bool in = f < nf && row < a.R;
      cp_async4(xs + f * BM + m, in ? a.x + row * a.sx + i0 + f : a.x,
                in ? 4 : 0);
    }
    for (int q = t; q < FI * NK; q += kThreads) {
      const int f = q / NK, j = q - f * NK;
      const bool in = f < nf;
      cp_async4(gs + f * kMaxKnots + j, in ? a.grid + (i0 + f) * a.sg + j
                                           : a.grid, in ? 4 : 0);
    }
  };

  // Chunk c's bases (ring stage s) into bs: one (row, feature) pair a
  // thread, consecutive threads on consecutive rows.
  auto bases = [&](int c, int s) {
    float* const bs = bs0 + s * BM * LDK;
    const float* const xs = smem + s * kStage + BN * LDK;
    const float* const gs = xs + MAXF * BM;
    const int nf = min(FI, f_hi - (f_lo + c * FI));
#pragma unroll 2
    for (int p = t; p < FI * BM; p += kThreads) {
      const int f = p / BM, m = p - f * BM;
      const bool live = f < nf && row0 + m < a.R;
      const float x = xs[f * BM + m];
      const float* const gk = gs + f * kMaxKnots;
      float* const col = bs + m * LDK + f * C;
      // x's knot interval: the knots at or below x among g[1..NK-2], if x
      // lies in [g[0], g[NK-1]) (never for a NaN), else -1
      int cnt = 0;
#pragma unroll
      for (int j = 1; j < kMaxKnots - 1; ++j)
        cnt += j <= NK - 2 && gk[j] <= x ? 1 : 0;
      const int mi = x >= gk[0] && x < gk[NK - 1] ? cnt : -1;
      // off the knots: zeros, or plain's NaNs for a NaN or infinite x
      const float fill =
          live && order >= 1 && !isfinite(x) ? __int_as_float(0x7fffffff)
                                             : 0.0f;
      for (int cc = 0; cc < C; ++cc) col[cc] = fill;
      if (live && mi >= 0) {
        float v[kMaxOrder + 1];
        bases_window<kMaxOrder>(x, gk, NK, order, mi, v);
#pragma unroll
        for (int r2 = 0; r2 <= kMaxOrder; ++r2) {
          const int cc = mi - order + r2;
          if (r2 <= order && cc >= 0 && cc < C) col[cc] = v[r2];
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  // the padding columns KC..KCp of every chunk stay zero
  for (int q = t; q < 2 * BM * LDK; q += kThreads) bs0[q] = 0.0f;

  if (nch > 0) load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();
    // chunk c's copies visible; chunk c - 1's FMAs done, so its stage
    // takes chunk c + 1 (chunk c's bases go to the other bases tile)
    __syncthreads();
    if (c + 1 < nch) load(c + 1, (c + 1) & 1);
    cp_async_commit();
    bases(c, c & 1);
    __syncthreads();
    const float* const ws = smem + (c & 1) * kStage;
    const float* const bs = bs0 + (c & 1) * BM * LDK;
#pragma unroll 2
    for (int k = 0; k < KCp; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(bs + (ty + 16 * i) * LDK + k);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + (tx + 16 * j) * LDK + k);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(av[i].x, wv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, wv.y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, wv.z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, wv.w, acc[i][j]);
        }
      }
    }
  }

  if (G == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= a.R) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int o = o0 + tx + 16 * j;
        if (o < a.O) a.y[(long long)row * a.O + o] = acc[i][j];
      }
    }
    return;
  }
  // Split-K: the partial tile into this CTA's ring, then each CTA adds its
  // share of the tile's outputs over the cluster in order g = 0..G-1.
  cp_async_wait<0>();
  __syncthreads();
  float* const part = smem;   // (BM, BN)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      part[(ty + 16 * i) * BN + tx + 16 * j] = acc[i][j];
  cluster.sync();
  const int n4 = BM * BN / 4;
  const int lo = g * n4 / G, hi = (g + 1) * n4 / G;
  for (int e = lo + t; e < hi; e += kThreads) {
    float4 s = cluster.map_shared_rank(reinterpret_cast<float4*>(part), 0)[e];
    for (int q = 1; q < G; ++q) {
      const float4 v =
          cluster.map_shared_rank(reinterpret_cast<float4*>(part), q)[e];
      s.x = __fadd_rn(s.x, v.x);
      s.y = __fadd_rn(s.y, v.y);
      s.z = __fadd_rn(s.z, v.z);
      s.w = __fadd_rn(s.w, v.w);
    }
    const int m = 4 * e / BN, n = 4 * e - m * BN, row = row0 + m;
    if (row >= a.R) continue;
    float* const yr = a.y + (long long)row * a.O;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (o0 + n + u < a.O) yr[o0 + n + u] = sv[u];
  }
  cluster.sync();   // every CTA's partials stay until all are read
}

template <int TM, int TN>
int launch(const Args& a, int nM, int nN, cudaStream_t s) {
  using T = Tile<TM, TN>;
  auto kern = spline_kernel<TM, TN>;
  const int smem = static_cast<int>(sizeof(float) * T::kFloats);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static unsigned long long ready = 0;   // devices with the attribute set
  if (dev >= 64 || !(ready >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) ready |= 1ULL << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.G * nM, nN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_tn(const Args& a, int TN, int nM, int nN, cudaStream_t s) {
  switch (TN) {
    case 1: return launch<TM, 1>(a, nM, nN, s);
    case 2: return launch<TM, 2>(a, nM, nN, s);
    case 4: return launch<TM, 4>(a, nM, nN, s);
    case 8: return launch<TM, 8>(a, nM, nN, s);
    default: return launch<TM, 16>(a, nM, nN, s);
  }
}

}  // namespace

// The geometries the kernel is compiled for: at most 16 knots a feature
// and order at most 5 (the port's KAN layers have 12 knots, order 3).
extern "C" int spline_matmul_max_knots() { return kMaxKnots; }
extern "C" int spline_matmul_max_order() { return kMaxOrder; }

// The input groups of a layer (the CTAs of a cluster), which fix the
// order of its sums.
extern "C" int spline_matmul_groups(int I, int NK, int order) {
  return groups_of(I, NK - 1 - order);
}

// x (R, I), grid (I, NK), w (O, I, C) -> y (R, O).  Strides in floats;
// the last dimension of each operand is contiguous and w's feature stride
// si is C.
extern "C" int spline_matmul(const float* x, const float* grid,
                             const float* w, float* y, int R, int I, int O,
                             int NK, int order, long long sx, long long sg,
                             long long so, long long si, void* stream) {
  if (R <= 0 || O <= 0) return 0;
  const int C = NK - 1 - order;
  if (I < 1 || order < 0 || C < 1 || NK > kMaxKnots || order > kMaxOrder ||
      si != C)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = groups_of(I, C);
  const bool vec = reinterpret_cast<unsigned long long>(w) % 16 == 0 &&
                   so % 4 == 0 && C % 4 == 0;
  Args a{x, grid, w, y, sx, sg, so, R, I, O, NK, order, C, G, vec ? 1 : 0};
  // The tile follows R and O (no sum's order depends on it): TN covers O
  // in one tile up to 256 outputs, TM the largest of 4, 2, 1 that gives a
  // CTA an SM, then narrower output tiles while the CTAs are fewer.
  int TN = 1;
  while (TN < 16 && 16 * TN < O) TN *= 2;
  auto ctas = [&](int tm, int tn) {
    return (long long)G * ((R + 16 * tm - 1) / (16 * tm)) *
           ((O + 16 * tn - 1) / (16 * tn));
  };
  int TM = 4;
  while (TM > 1 && ctas(TM, TN) < sms) TM /= 2;
  if (TM == 1)
    while (TN > 4 && ctas(1, TN) < sms) TN /= 2;
  const long long nM = (R + 16 * TM - 1) / (16 * TM);
  const int nN = (O + 16 * TN - 1) / (16 * TN);
  if (nM * G > 0x7fffffffLL || nN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (TM) {
    case 4: return launch_tn<4>(a, TN, static_cast<int>(nM), nN, s);
    case 2: return launch_tn<2>(a, TN, static_cast<int>(nM), nN, s);
    default: return launch_tn<1>(a, TN, static_cast<int>(nM), nN, s);
  }
}
