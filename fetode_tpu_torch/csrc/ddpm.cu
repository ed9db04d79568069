// The whole DDPM reverse chain of the forecasters' MLP eps-head for Hopper
// (sm_90a): all T steps of every row in one launch, forward only.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_ddpm.py:94
// (pallas_eps_head_sample; its row-major kernel _make_kernel :40 and its
// feature-major gridded kernel _make_kernel_fm :59, two layouts of one
// computation that are one kernel here).  Loop step i (t = T-1-i) maps
// each row y (P,) to
//
//   h   = silu(y W1y^T + cond_h + temb_h[i])      (H,)
//   h   = silu(h W2^T + b2)                       (H,)
//   eps = h W3^T + b3                             (P,)
//   y   = c1[i] y - c2[i] eps + c3[i] noise[i]
//
// with cond_h (the conditioning's first-layer term plus b1), temb_h (the
// t-embeddings' first-layer terms, in loop order), the coefficients and
// the noise tables all made by the caller (ops/ddpm.py), as the TPU
// wrapper makes them (:124-150).
//
// What bounds it on this card: 2 H (2 P + H) FP32 operations per row and
// step, about 139 k at H = 256, P = 8, so 71 GFLOP for 2,560 rows over 200
// steps, 1.06 ms at 67 TFLOP/s; its bytes (the noise table, cond_h, y)
// are 19 MB, 6 us.  FP32 arithmetic bounds it.  What holds this form
// above that bound: each step is a chain of five dependent phases, two of
// them cluster barriers, so at 80 rows latency, not the FMA rate, sets a
// step; at 2,560 rows layer 2's shared-memory reads (a float4 read costs
// four wavefronts however many threads share it) and the h1 exchange
// through distributed shared memory (74 KB into each CTA a step) weigh
// most.  PERF.md (Findings, B.9) has the times.
//
// Layout.  Rows are independent, so there is no grid-wide step: a
// thread-block cluster of 4 CTAs owns a tile of RT rows for all T steps,
// and CTA c of the cluster owns the hidden columns [c H/4, (c+1) H/4) of
// both hidden layers.  Each CTA keeps in shared memory, for the whole
// chain, its H x H/4 block of W2 (64 KB at H = 256), its columns of
// W1y^T, its rows of W3^T, its slice of b2, the coefficients and its
// rows' cond_h slice; W2 is read from device memory once.  A step:
//  1. layer 1 on the CTA's columns, 8 columns a task (p in order); each
//     CTA stores its slice of h into every CTA's copy of h through
//     distributed shared memory (cluster.map_shared_rank), then one
//     cluster barrier;
//  2. layer 2 on the CTA's columns over the whole of h: the k range falls
//     into four quarters, each summed in order as one chain by a quarter
//     of the CTA's threads (each thread TR rows by 8 columns, two float4
//     of W2 Hc/2 apart so a quarter-warp reads 32 distinct banks; h rows
//     padded to H + 4 floats); the quarters' sums go to shared memory and
//     are added in quarter order, b2 added and SiLU taken (each row
//     rotated by 4 r columns, so the next phase's reads of one column in
//     several rows fall in distinct banks);
//  3. eps: each CTA's partial for a (row, p) is its 8-column groups, each
//     a chain of 8 in order, added in group order; each CTA stores it into
//     every CTA's copy of the partials, then one cluster barrier;
//  4. every CTA adds the 4 CTAs' partials in rank order, adds b3 and
//     updates its copy of y: the same operations on the same values, so
//     every copy holds the same bits and no third barrier is needed.
// The step's noise rows and the next step's t-embedding slice load with
// cp.async behind the step's arithmetic.  SiLU's quotient is
// knot_quotient.cuh's branch-free fast path (IEEE's bits wherever 1 +
// e^-x < 2^126); nvcc's branchy IEEE quotient made a thread's activations
// run one after another.  Each sum's order is fixed by (P, H) alone, so it
// does not depend on RT or the thread count: a row gives the same bits
// alone and inside a batch, and every run the same.  All products are
// FP32 FMAs (parity with the JAX kernel's Precision.HIGHEST products; TF32
// tensor cores would not keep it).
//
// Tiles follow R: the smallest of RT = 16 (128 threads, 4 rows a thread),
// 32 (256, 4), 48, 64, 80, 96 (512 threads, 3-6 rows) whose clusters the
// card runs in one wave (cudaOccupancyMaxActiveClusters: 30 four-CTA
// clusters at one CTA an SM on the H100; ddpm_chain_tile reports the
// pick).  RT = 96 takes 211 KB of shared memory.  The cluster has 4 CTAs,
// not 8: 8 would halve each CTA's W2 block but fit fewer rows a wave.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "knot_quotient.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxP = 32;
constexpr int kCluster = 4;      // CTAs a row tile, H / kCluster columns each
constexpr int kQuarters = 4;     // layer 2's k-chains, added in order
constexpr int kMaxGroups = 8;    // column groups of 8 a CTA
constexpr size_t kMaxSmem = 232448;   // a CTA's shared memory on sm_90

struct ChainArgs {
  const float* y0;     // (rows, P) the chain's start
  const float* condh;  // (rows, H)
  const float* temb;   // (T, H) t-embedding terms in loop order
  const float* noise;  // (T, rows, P)
  const float* coef;   // (T, 3): c1, c2, c3
  const float* w1yt;   // (P, H) the first layer's y block, transposed
  const float* w2t;    // (H, H) W2 transposed: w2t[k * H + j] = W2[j, k]
  const float* b2;     // (H)
  const float* w3;     // (P, H)
  const float* b3;     // (P)
  float* out;          // (rows, P)
  int rows, P, H, T;
};

// The row tiles: NT threads, TR rows a thread in layer 2; RT = NT / (4
// ncg) TR rows, ncg = H / (8 kCluster) column groups of 8 a CTA.
struct Config {
  int NT, TR;
};
constexpr Config kConfigs[] = {{128, 4}, {256, 4}, {512, 3}, {512, 4},
                               {512, 5}, {512, 6}};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

// Column groups of 8 in a CTA's H / kCluster columns.
__host__ __device__ inline int groups(int H) { return H / (8 * kCluster); }

__host__ __device__ inline int tile_rows(int NT, int TR, int H) {
  return NT / (kQuarters * groups(H)) * TR;
}

// Float offsets of a CTA's shared memory.  Layer 2's four quarter sums,
// then h2 in the first of them, reuse h1's space once layer 2 has read it.
struct Layout {
  int w2, w1, w3, b2, b3, coef, tb, ch, h1, y, ep, nz, total;
};

__host__ __device__ inline Layout layout(int RT, int P, int H, int T) {
  const int Hc = H / kCluster;
  const int h1 = RT * (H + 4), quarters = kQuarters * RT * Hc;
  Layout L;
  int o = 0;
  L.w2 = o;   o += H * Hc;                 // (H, Hc) W2^T's columns, k-major
  L.w1 = o;   o += P * Hc;                 // (P, Hc) W1y^T's columns
  L.w3 = o;   o += Hc * P;                 // (Hc, P) W3^T's rows
  L.b2 = o;   o += Hc;
  L.b3 = o;   o += (P + 3) & ~3;
  L.coef = o; o += (3 * T + 3) & ~3;
  L.tb = o;   o += 2 * Hc;                 // temb slice, two steps
  L.ch = o;   o += RT * Hc;                // cond_h slice
  L.h1 = o;   o += h1 > quarters ? h1 : quarters;
  L.y = o;    o += (RT * P + 3) & ~3;
  L.ep = o;   o += (kCluster * RT * P + 3) & ~3;   // the CTAs' eps partials
  L.nz = o;   o += RT * P;                 // the step's noise rows
  L.total = o;
  return L;
}

// x / (1 + e^-x): the quotient by knot_quotient.cuh's branch-free fast
// path, IEEE's bits wherever 1 + e^-x < 2^126 (x > -87.3); below, -0 for
// IEEE's -1e-36 or less (NaN stays NaN).  nvcc's IEEE quotient branches to
// a slow path, and each branch closed a region the scheduler could not
// move work across: a thread's activations ran one after another.
__device__ __forceinline__ float silu(float x) {
  const float d = 1.0f + expf(-x);
  return d < 0x1p126f ? div_knot(x, d) : 0.0f * x;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Column u (0..7) of column group g of a CTA's Hc columns: two float4,
// Hc/2 apart, so a quarter-warp's 8 groups read 32 distinct banks.
__device__ __forceinline__ int col_of(int g, int u, int half) {
  return (u < 4 ? 4 * g : half + 4 * g) + (u & 3);
}

// Where column col of row r of the quarter sums and h2 lies: each row
// rotated by 4 r columns, so the eps terms' reads of one column in 4 or 8
// rows fall in distinct banks.
__device__ __forceinline__ int qs_at(int r, int col, int Hc) {
  return r * Hc + ((col + 4 * r) & (Hc - 1));
}

template <int NT, int TR>
__global__ void __launch_bounds__(NT, 1) ddpm_chain_kernel(ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = a.P, H = a.H, T = a.T, Hc = H / kCluster, LDH = H + 4;
  const int half = Hc / 2, Hq = H / kQuarters, ncg = groups(H);
  const int nrg = NT / (kQuarters * ncg), RT = nrg * TR;
  const int c0 = rank * Hc;                   // the CTA's first column
  const Layout L = layout(RT, P, H, T);
  float* const w2s = sm + L.w2;
  float* const w1s = sm + L.w1;
  float* const w3s = sm + L.w3;
  float* const b2s = sm + L.b2;
  float* const b3s = sm + L.b3;
  float* const cf = sm + L.coef;
  float* const tb = sm + L.tb;
  float* const ch = sm + L.ch;
  float* const h1 = sm + L.h1;
  float* const qs = h1;     // (4, RT, Hc) quarter sums; h2 in quarter 0
  float* const y = sm + L.y;
  float* const ep = sm + L.ep;
  float* const nz = sm + L.nz;
  const int t = threadIdx.x;
  const int row0 = (blockIdx.x / kCluster) * RT;
  const int nr = min(RT, a.rows - row0);

  for (int q = t; q < H * (Hc / 4); q += NT) {
    const int k = q / (Hc / 4), j = 4 * (q - k * (Hc / 4));
    *reinterpret_cast<float4*>(w2s + k * Hc + j) =
        ld4(a.w2t + (size_t)k * H + c0 + j);
  }
  for (int q = t; q < P * Hc; q += NT) {
    const int p = q / Hc, j = q - p * Hc;
    w1s[q] = a.w1yt[(size_t)p * H + c0 + j];
    w3s[j * P + p] = a.w3[(size_t)p * H + c0 + j];
  }
  for (int q = t; q < Hc; q += NT) {
    b2s[q] = a.b2[c0 + q];
    tb[q] = a.temb[c0 + q];
  }
  for (int q = t; q < P; q += NT) b3s[q] = a.b3[q];
  for (int q = t; q < 3 * T; q += NT) cf[q] = a.coef[q];
  for (int q = t; q < RT * Hc; q += NT) {
    const int r = q / Hc, j = q - r * Hc;
    ch[q] = r < nr ? a.condh[(size_t)(row0 + r) * H + c0 + j] : 0.0f;
  }
  for (int q = t; q < RT * P; q += NT)
    y[q] = q / P < nr ? a.y0[(size_t)row0 * P + q] : 0.0f;
  // every CTA of the cluster has started before any stores into another
  cluster.sync();

  // Layer 2: k-quarter kq, column group g, rows rg + nrg i.
  const int kq = t / (NT / kQuarters), g = t % ncg;
  const int rg = (t % (NT / kQuarters)) / ncg;
  const int clo = 4 * g, chi = half + 4 * g;
  for (int step = 0; step < T; ++step) {
    // this step's noise rows, the next step's temb slice, behind the work
    for (int q = t; q < nr * P; q += NT)
      cp_async4(nz + q, a.noise + ((size_t)step * a.rows + row0) * P + q);
    if (step + 1 < T)
      for (int q = t; q < Hc; q += NT)
        cp_async4(tb + ((step + 1) & 1) * Hc + q,
                  a.temb + (size_t)(step + 1) * H + c0 + q);
    cp_async_commit();

    // 1. h1 = silu(y W1y^T + cond_h + temb_h[step]) on the CTA's columns,
    // 8 a task (p in order), stored into every CTA's h1.
    const float* const tv = tb + (step & 1) * Hc;
    for (int task = t; task < RT * ncg; task += NT) {
      const int r = task / ncg, lo = 4 * (task - r * ncg), hi = half + lo;
      float acc[8] = {};
      for (int p = 0; p < P; ++p) {
        const float yv = y[r * P + p];
        const float4 wl = ld4(w1s + p * Hc + lo), wh = ld4(w1s + p * Hc + hi);
        acc[0] = fmaf(yv, wl.x, acc[0]);
        acc[1] = fmaf(yv, wl.y, acc[1]);
        acc[2] = fmaf(yv, wl.z, acc[2]);
        acc[3] = fmaf(yv, wl.w, acc[3]);
        acc[4] = fmaf(yv, wh.x, acc[4]);
        acc[5] = fmaf(yv, wh.y, acc[5]);
        acc[6] = fmaf(yv, wh.z, acc[6]);
        acc[7] = fmaf(yv, wh.w, acc[7]);
      }
      const float4 cl = ld4(ch + r * Hc + lo), chv = ld4(ch + r * Hc + hi);
      const float4 tl = ld4(tv + lo), th = ld4(tv + hi);
      const float4 vl = make_float4(silu((acc[0] + cl.x) + tl.x),
                                    silu((acc[1] + cl.y) + tl.y),
                                    silu((acc[2] + cl.z) + tl.z),
                                    silu((acc[3] + cl.w) + tl.w));
      const float4 vh = make_float4(silu((acc[4] + chv.x) + th.x),
                                    silu((acc[5] + chv.y) + th.y),
                                    silu((acc[6] + chv.z) + th.z),
                                    silu((acc[7] + chv.w) + th.w));
      for (int q = 0; q < kCluster; ++q) {
        float* const dst = cluster.map_shared_rank(h1, q) + r * LDH + c0;
        *reinterpret_cast<float4*>(dst + lo) = vl;
        *reinterpret_cast<float4*>(dst + hi) = vh;
      }
    }
    cluster.sync();

    // 2. h1 W2^T on the CTA's columns: quarter kq of k, a chain in order.
    float acc[TR][8];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
#pragma unroll 1
    for (int k = kq * Hq; k < (kq + 1) * Hq; k += 4) {
      float4 hv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) hv[i] = ld4(h1 + (rg + nrg * i) * LDH + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wl = ld4(w2s + (k + u) * Hc + clo);
        const float4 wh = ld4(w2s + (k + u) * Hc + chi);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float h = u == 0 ? hv[i].x : u == 1 ? hv[i].y
                        : u == 2 ? hv[i].z : hv[i].w;
          acc[i][0] = fmaf(h, wl.x, acc[i][0]);
          acc[i][1] = fmaf(h, wl.y, acc[i][1]);
          acc[i][2] = fmaf(h, wl.z, acc[i][2]);
          acc[i][3] = fmaf(h, wl.w, acc[i][3]);
          acc[i][4] = fmaf(h, wh.x, acc[i][4]);
          acc[i][5] = fmaf(h, wh.y, acc[i][5]);
          acc[i][6] = fmaf(h, wh.z, acc[i][6]);
          acc[i][7] = fmaf(h, wh.w, acc[i][7]);
        }
      }
    }
    __syncthreads();   // h1 read: its space takes the quarter sums
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        qs[kq * RT * Hc + qs_at(rg + nrg * i, col_of(g, c, half), Hc)] =
            acc[i][c];
    __syncthreads();
    // h2 = silu(the quarters in order + b2), into quarter 0's place.
#pragma unroll 4
    for (int item = t; item < RT * Hc; item += NT) {
      float v = qs[item];
      for (int w = 1; w < kQuarters; ++w)
        v = __fadd_rn(v, qs[w * RT * Hc + item]);
      const int r = item / Hc;
      qs[item] = silu(v + b2s[(item - r * Hc - 4 * r) & (Hc - 1)]);
    }
    __syncthreads();
    // 3. the CTA's eps partial of each (row, p): each column group's 8
    // terms in order, the groups in order; stored into every CTA.
    for (int item = t; item < RT * P; item += NT) {
      const int r = item / P, p = item - r * P;
      float eg[kMaxGroups];   // the groups' chains, independent of each other
#pragma unroll
      for (int w = 0; w < kMaxGroups; ++w) {
        eg[w] = 0.0f;
        if (w < ncg)
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int col = col_of(w, u, half);
            eg[w] = fmaf(qs[qs_at(r, col, Hc)], w3s[col * P + p], eg[w]);
          }
      }
      float e = eg[0];
#pragma unroll
      for (int w = 1; w < kMaxGroups; ++w)
        if (w < ncg) e = __fadd_rn(e, eg[w]);
      for (int q = 0; q < kCluster; ++q)
        cluster.map_shared_rank(ep, q)[rank * RT * P + item] = e;
    }
    cp_async_wait_all();
    cluster.sync();

    // 4. eps = the CTAs' partials in rank order + b3; the update, the same
    // bits in every CTA's copy of y.
    const float c1 = cf[3 * step], c2 = cf[3 * step + 1];
    const float c3 = cf[3 * step + 2];
    for (int item = t; item < nr * P; item += NT) {
      float e = ep[item];
      for (int w = 1; w < kCluster; ++w)
        e = __fadd_rn(e, ep[w * RT * P + item]);
      const float eps = e + b3s[item % P];
      y[item] = c1 * y[item] - c2 * eps + c3 * nz[item];
    }
    __syncthreads();
  }
  if (rank == 0)
    for (int q = t; q < nr * P; q += NT)
      a.out[(size_t)row0 * P + q] = y[q];
}

using Kernel = void (*)(ChainArgs);

Kernel kernel_of(int c) {
  switch (c) {
    case 0: return ddpm_chain_kernel<128, 4>;
    case 1: return ddpm_chain_kernel<256, 4>;
    case 2: return ddpm_chain_kernel<512, 3>;
    case 3: return ddpm_chain_kernel<512, 4>;
    case 4: return ddpm_chain_kernel<512, 5>;
    default: return ddpm_chain_kernel<512, 6>;
  }
}

cudaLaunchConfig_t launch_config(int c, int tiles, size_t smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * kCluster, 1, 1);
  cfg.blockDim = dim3(kConfigs[c].NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of config c that the device runs at once (0 if none fit),
// asked once a device and config.
int max_clusters(int dev, int c, size_t smem) {
  static int known[64][kNumConfigs] = {};   // the count + 1; 0 unknown
  if (dev < 64 && known[dev][c] > 0) return known[dev][c] - 1;
  Kernel k = kernel_of(c);
  int n = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(c, 1, smem, nullptr, attr);
  if (cudaOccupancyMaxActiveClusters(&n, k, &cfg) != cudaSuccess) return -1;
  if (dev < 64) known[dev][c] = n + 1;
  return n;
}

}  // namespace

// The row tile of a chain of `rows` rows: out[0] = RT, out[1] = the
// threads a CTA, out[2] = the four-CTA clusters the device runs at once
// with that tile, out[3] = the shared memory a CTA takes (bytes).  The
// smallest tile whose clusters the device runs in one wave, else the
// largest that fits; rows are independent and every sum's order is fixed
// by (P, H), so the tile changes no bits.  Returns a CUDA error code.
extern "C" int ddpm_chain_tile(int rows, int P, int H, int T, int* out) {
  if (H % (8 * kCluster) != 0 || groups(H) < 1 || groups(H) > kMaxGroups ||
      128 % (kQuarters * groups(H)) != 0 || P < 1 || P > kMaxP || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int pick = -1, clusters = 0;
  size_t smem = 0;
  for (int c = 0; c < kNumConfigs; ++c) {
    const int RT = tile_rows(kConfigs[c].NT, kConfigs[c].TR, H);
    const size_t bytes = sizeof(float) * static_cast<size_t>(
        layout(RT, P, H, T).total);
    if (bytes > kMaxSmem) break;
    const int n = max_clusters(dev, c, bytes);
    if (n <= 0) break;
    pick = c;
    smem = bytes;
    clusters = n;
    if ((rows + RT - 1) / RT <= n) break;
  }
  if (pick < 0) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = tile_rows(kConfigs[pick].NT, kConfigs[pick].TR, H);
  out[1] = kConfigs[pick].NT;
  out[2] = clusters;
  out[3] = static_cast<int>(smem);
  return 0;
}

// y0 (rows, P), cond_h (rows, H), temb_h (T, H), noise (T, rows, P), coef
// (T, 3), W1y^T (P, H), W2^T (H, H), b2 (H), W3 (P, H), b3 (P) -> out
// (rows, P).  H must be 32, 64, 128 or 256 and P at most 32, every
// pointer 16-byte aligned, and one CTA's tables (its W2 block, 16 rows)
// must fit its shared memory.
extern "C" int ddpm_chain(const float* y0, const float* condh,
                          const float* temb, const float* noise,
                          const float* coef, const float* w1yt,
                          const float* w2t, const float* b2, const float* w3,
                          const float* b3, float* out, int rows, int P, int H,
                          int T, void* stream) {
  if (rows <= 0) return 0;
  int tile[4];
  cudaError_t err = static_cast<cudaError_t>(
      ddpm_chain_tile(rows, P, H, T, tile));
  if (err != cudaSuccess) return static_cast<int>(err);
  int pick = 0;
  while (tile_rows(kConfigs[pick].NT, kConfigs[pick].TR, H) != tile[0] ||
         kConfigs[pick].NT != tile[1])
    ++pick;
  Kernel k = kernel_of(pick);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile[3]);
  if (err != cudaSuccess) return static_cast<int>(err);
  ChainArgs a{y0, condh, temb, noise, coef, w1yt, w2t, b2, w3, b3, out,
              rows, P, H, T};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(pick, (rows + tile[0] - 1) / tile[0], tile[3],
                    static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
