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
// order (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn: no FMA contraction).
// For an x inside the knots only the order + 1 bases on its knot interval
// m are nonzero, and at each level of the recursion only the terms j = m
// - k .. m: the kernel computes just those (the terms outside are +0 in
// plain, whose products with +0 leave the sums unchanged), 9 instead of
// 27 at order 3.  A finite x off the knots has +0 bases in plain at every
// level (a +0 below gives left * +0 + right * +0, and left and right
// cannot both be negative), and the kernel writes zeros.  A NaN or
// infinite x lies in no interval, and plain's first level multiplies a
// NaN or infinite quotient by those zeros: every basis is NaN from order
// 1 on (zero at order 0), and the kernel writes that.  This holds for
// strictly increasing knots, as make_grid gives, and quotients (x - g_j)
// / (g_j+k - g_j) that do not overflow.  Only the product's order of
// summation differs from plain's.
//
// Layout: a block owns a tile of 32 rows, 64 outputs and one group of the
// inputs (8 chunks of 64 / C features: 64 features at C = 8), 256
// threads with a 2 x 4 register micro-tile each.  Per chunk the block
// stages the features' knots, forms the bases of its 32 rows on them (one
// (row, feature) pair a thread) and the chunk's weight tile in shared
// memory; then every thread adds its 8 outputs' terms, FP32 FMAs in the
// order (i, c).  With more than one group each block writes its partial
// sums to a scratch array (G, R, O) and a second kernel adds the groups
// in order g = 0..G-1.  So each y[b, o] is summed in one fixed order over
// (i, c), set by I and C alone: the same whatever R is and whichever tile
// the row falls in, so a row gives the same bits alone and inside a batch
// of 2,560.  No atomics, no split chosen by the batch size, no TF32 or
// tensor-core product.  The groups give a small batch (a serving bucket
// of 80 rows) blocks enough to spread over the SMs.  The TPU kernel's lane
// layout (per-lane knot windows, the roll trick, the lane mask and the
// 128-lane padding, pallas_spline.py:85-114) has no cause on this card and
// is not carried over.  x, the grid and the weight may be row-strided (the
// cond-diffusion chain passes column slices of a layer's weight); their
// last dimension must be contiguous.
//
// What bounds it on this card: the product's 2 R I C O FP32 operations
// (0.040 ms at R = 2,560, I = O = 256, C = 8, at 67 TFLOP/s) against x,
// the weights and y moved once (2.8 MB there, 0.0008 ms at 3.35 TB/s): the
// FP32 units.  This form re-forms the bases for each 64-output tile and
// reads its operands from shared memory for every two FMAs, so it runs
// well below that; the tensor cores (TF32 wgmma) are for a redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;          // rows a block
constexpr int kBN = 64;          // outputs a block
constexpr int kKC = 64;          // (feature, basis) columns a chunk, at most
constexpr int kChunks = 8;       // chunks a group of inputs
constexpr int kMaxKnots = 16;
constexpr int kMaxOrder = 5;

struct Args {
  const float* x;     // (R, I), row stride sx
  const float* grid;  // (I, NK), row stride sg
  const float* w;     // (O, I, C), strides so, si, 1
  float* y;           // (R, O), contiguous
  float* part;        // (G, R, O) partial sums when G > 1
  long long sx, sg, so, si;
  int R, I, O, NK, order, FI, G;
};

// The order + 1 bases of an x in the knot interval [g[m], g[m+1]): v[r]
// is B_{m - order + r}, r = 0..order.  Level k holds the terms j = m - k
// + r, r = 0..k, each as plain computes it from the level below, whose
// terms outside the window are +0; a term j outside plain's range (j < 0
// or j > nk - 2 - k) is left 0 and never read for a valid basis.
template <int MAXO>
__device__ __forceinline__ void bases_window(float x, const float* g, int nk,
                                             int order, int m,
                                             float (&v)[MAXO + 1]) {
  v[0] = 1.0f;
#pragma unroll
  for (int k = 1; k <= MAXO; ++k) {
    if (k > order) break;
#pragma unroll
    for (int r = MAXO; r >= 0; --r) {   // descending: v[r], v[r-1] still old
      if (r > k) continue;
      const int j = m - k + r;
      const float oj = r >= 1 ? v[r - 1] : 0.0f;
      const float oj1 = r <= k - 1 ? v[r] : 0.0f;
      float nv = 0.0f;
      if (j >= 0 && j <= nk - 2 - k) {
        const float gj = g[j], gj1 = g[j + 1], gjk = g[j + k],
                    gjk1 = g[j + k + 1];
        const float left = __fdiv_rn(__fsub_rn(x, gj), __fsub_rn(gjk, gj));
        const float right = __fdiv_rn(__fsub_rn(gjk1, x),
                                      __fsub_rn(gjk1, gj1));
        nv = __fadd_rn(__fmul_rn(left, oj), __fmul_rn(right, oj1));
      }
      v[r] = nv;
    }
  }
}

template <int MAXK, int MAXO>
__global__ void __launch_bounds__(kThreads) spline_matmul_kernel(Args a) {
  __shared__ float gs[kKC][kMaxKnots];                // the chunk's knots
  __shared__ __align__(16) float bs[kKC][kBM + 2];    // bases, (column, row)
  __shared__ __align__(16) float ws[kKC][kBN + 4];    // weights, (column, out)
  const int t = threadIdx.x;
  const int row0 = blockIdx.y * kBM, o0 = blockIdx.x * kBN;
  const int NK = a.NK, order = a.order, C = NK - 1 - order;
  const int FI = a.FI, KC = FI * C;                   // features, columns
  const int g_lo = blockIdx.z * kChunks * FI;
  const int g_hi = min(a.I, g_lo + kChunks * FI);
  const int tx = t & 15, ty = t >> 4;   // outputs 4 tx.., rows 2 ty..
  // the weight tile: column t / 4, outputs t % 4 + 4 n
  const int wk = t >> 2, wo = t & 3;
  float acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  for (int i0 = g_lo; i0 < g_hi; i0 += FI) {
    for (int q = t; q < FI * NK; q += kThreads) {
      const int f = q / NK, j = q - f * NK;
      gs[f][j] = i0 + f < g_hi ? a.grid[(i0 + f) * a.sg + j] : 0.0f;
    }
    __syncthreads();
    // The bases of the tile's rows on the chunk's features: a warp takes
    // one feature and 32 rows.
    for (int p = t; p < kBM * FI; p += kThreads) {
      const int f = p / kBM, r = p - f * kBM;
      const int i = i0 + f, row = row0 + r;
      float* col = &bs[f * C][r];
      const float* g = gs[f];
      const bool live = i < g_hi && row < a.R;
      const float x = live ? a.x[row * a.sx + i] : 0.0f;
      int m = -1;
#pragma unroll
      for (int j = 0; j < MAXK - 1; ++j)
        if (j < NK - 1 && x >= g[j] && x < g[j + 1]) m = j;
      // off the knots: zeros, or plain's NaNs for a NaN or infinite x
      const float fill =
          live && order >= 1 && !isfinite(x) ? __int_as_float(0x7fffffff)
                                             : 0.0f;
      for (int c = 0; c < C; ++c) col[c * (kBM + 2)] = fill;
      if (live && m >= 0) {
        float v[MAXO + 1];
        bases_window<MAXO>(x, g, NK, order, m, v);
#pragma unroll
        for (int r2 = 0; r2 <= MAXO; ++r2) {
          const int c = m - order + r2;
          if (r2 <= order && c >= 0 && c < C) col[c * (kBM + 2)] = v[r2];
        }
      }
    }
    // The chunk's weight tile: a thread keeps one column's offset.
    if (wk < KC) {
      const int f = wk / C, c = wk - f * C;
      const bool in = i0 + f < g_hi;
      const float* wp = a.w + (long long)(i0 + f) * a.si + c;
#pragma unroll 4
      for (int o = wo; o < kBN; o += 4) {
        const int og = o0 + o;
        ws[wk][o] = (in && og < a.O) ? wp[og * a.so] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float2 bv = *reinterpret_cast<const float2*>(&bs[kk][2 * ty]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      acc[0][0] = fmaf(bv.x, wv.x, acc[0][0]);
      acc[0][1] = fmaf(bv.x, wv.y, acc[0][1]);
      acc[0][2] = fmaf(bv.x, wv.z, acc[0][2]);
      acc[0][3] = fmaf(bv.x, wv.w, acc[0][3]);
      acc[1][0] = fmaf(bv.y, wv.x, acc[1][0]);
      acc[1][1] = fmaf(bv.y, wv.y, acc[1][1]);
      acc[1][2] = fmaf(bv.y, wv.z, acc[1][2]);
      acc[1][3] = fmaf(bv.y, wv.w, acc[1][3]);
    }
    __syncthreads();
  }
  float* out = a.G > 1 ? a.part + (long long)blockIdx.z * a.R * a.O : a.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 2 * ty + r;
    if (row >= a.R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o < a.O) out[(long long)row * a.O + o] = acc[r][j];
    }
  }
}

// y = the groups' partial sums added in order g = 0..G-1.
__global__ void __launch_bounds__(kThreads) spline_groups_kernel(
    const float* part, float* y, long long n, int G) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    float s = part[e];
    for (int g = 1; g < G; ++g) s += part[g * n + e];
    y[e] = s;
  }
}

template <int MAXK, int MAXO>
int launch(const Args& a, cudaStream_t s) {
  const dim3 grid((a.O + kBN - 1) / kBN, (a.R + kBM - 1) / kBM, a.G);
  spline_matmul_kernel<MAXK, MAXO><<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.G == 1) return (int)err;
  const long long n = (long long)a.R * a.O;
  const long long blocks = (n + kThreads - 1) / kThreads;
  spline_groups_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0,
                         s>>>(a.part, a.y, n, a.G);
  return (int)cudaGetLastError();
}

int features_a_chunk(int NK, int order) { return kKC / (NK - 1 - order); }

}  // namespace

// The geometries the kernel is compiled for: at most 16 knots a feature
// and order at most 5 (the port's KAN layers have 12 knots, order 3).
extern "C" int spline_matmul_max_knots() { return kMaxKnots; }
extern "C" int spline_matmul_max_order() { return kMaxOrder; }

// The input groups of a layer, which fix the order of its sums: the
// wrapper allocates G * R * O floats of scratch when G > 1.
extern "C" int spline_matmul_groups(int I, int NK, int order) {
  const int per = kChunks * features_a_chunk(NK, order);
  return (I + per - 1) / per;
}

// x (R, I), grid (I, NK), w (O, I, C) -> y (R, O); part holds G R O
// floats when G = spline_matmul_groups(I, NK, order) > 1.  Strides in
// floats; the last dimension of each operand is contiguous.
extern "C" int spline_matmul(const float* x, const float* grid,
                             const float* w, float* y, float* part, int R,
                             int I, int O, int NK, int order, long long sx,
                             long long sg, long long so, long long si,
                             void* stream) {
  if (R <= 0 || O <= 0) return 0;
  const int C = NK - 1 - order;
  if (I < 1 || order < 0 || C < 1 || NK > kMaxKnots || order > kMaxOrder ||
      (R + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = spline_matmul_groups(I, NK, order);
  if (G > 65535 || (G > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{x, grid, w, y, part, sx, sg, so, si, R, I, O, NK, order,
         features_a_chunk(NK, order), G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NK <= 12 && order <= 3) return launch<12, 3>(a, s);
  return launch<kMaxKnots, kMaxOrder>(a, s);
}
