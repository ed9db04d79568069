// The row-tile products of the fields that run under node_common.cuh's
// row policy (RowSync), B.7's csrc/ode_dyn.cu and B.8's csrc/node_enc.cu,
// also B.6's parameter tiles (csrc/mlp_node.cu), and the cluster and
// cooperative-grid launches of the row policy (B.5's csrc/logistic_node.cu
// too).
// A CTA multiplies its own batch rows, held as row records (row b at
// x + b * RS), with a weight it holds by rows, in FP32 FMAs (no tensor
// cores, no TF32), 4 rows a pass, each weight element read once for the 4.
//
// Where a weight's element (r, c) lies is the layout's: Padded, rows S
// floats apart with S = 4 mod 32 words (row_stride), or Swizzled, rows
// S = a multiple of 32 floats apart with the float4 groups of each row
// permuted by r mod 8, which gives the products the same spread over the
// 32 banks with no pad columns.  Every sum has a fixed owner and an order
// set by the widths alone, so a row gives the same bits alone and in any
// batch, and the layout moves no bit.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <tuple>

namespace row_products {

constexpr int kMaxCluster = 16;  // CTAs, the non-portable cluster size
constexpr int kGroup = 4;  // rows of a work item's register block
constexpr int kOut = 2;    // outputs a lane of a column product holds

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round32(int x) { return (x + 31) & ~31; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The smallest stride >= k that is 4 mod 32 words: 8 consecutive rows'
// 16-byte loads at that stride cover the 32 banks once.
__host__ __device__ inline int row_stride(int k) {
  int s = round4(k);
  while ((s & 31) != 4) s += 4;
  return s;
}

struct Padded {
  int S;
  __device__ __forceinline__ int at(int r, int c) const { return r * S + c; }
};

// S a multiple of 32: element (r, c) in float4 group (c / 4) xor (r mod 8)
// of its row.  8 rows' loads of one group, and a row's 32 consecutive
// columns, each cover the 32 banks once.
struct Swizzled {
  int S;
  __device__ __forceinline__ int at(int r, int c) const {
    return r * S + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
  }
};

// dst (rows of the layout) = src (real rows of n floats, row-major), zero
// past n and past `real` rows, over `cols` columns a row; kLoads loads in
// flight a thread.
template <class Lay>
__device__ __forceinline__ void pad_copy(float* dst, Lay lay, const float* src,
                                         int rows, int real, int n,
                                         int cols) {
  constexpr int kLoads = 8;
  const int total = rows * cols, step = blockDim.x * kLoads;
  for (int i0 = threadIdx.x; i0 < total; i0 += step) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      const int j = i / cols, c = i - j * cols;
      v[u] = (i < total && j < real && c < n) ? __ldg(src + j * n + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      const int j = i / cols, c = i - j * cols;
      if (i < total) dst[lay.at(j, c)] = v[u];
    }
  }
}

// One warp's item of product_rows: out[b, o] = epi(sum_c x[b, c] W(o, c))
// for the 8 outputs o of group og and the 4 rows b0 .. b0 + 3 (those
// below nrows), the contraction c < Kc (x and W zero past their lengths,
// Kc a multiple of 4): a quarter-warp holds the 8 outputs, one a lane, and
// the 4 quarters 4 chunks of the contraction, each lane running its chunk
// for the 4 rows at once (each weight read once for the 4 rows, each input
// a 16-byte load its quarter shares); the chunks' sums meet in a fixed
// shuffle tree and quarter 0 applies the epilogue.  No barrier.  kUnroll
// float4 steps of the contraction are in flight at once (a weight read
// through L2 wants them all; the order of every sum is the same).
template <int kUnroll = 2, class Lay, class Epi>
__device__ __forceinline__ void rows_item(const float* x, int RS, int nrows,
                                          const float* W, Lay lay, int Kc,
                                          int O, int og, int b0,
                                          const Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int ks = lane >> 3, ol = lane & 7;
  const int KC = round4(cdiv(Kc, 4));
  const int c0 = ks * KC, c1 = min(Kc, c0 + KC);
  const float* xr[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) xr[r] = x + min(b0 + r, nrows - 1) * RS;
  const int o = og * 8 + ol, orow = min(o, O - 1);
  float a[kGroup] = {};
#pragma unroll kUnroll
  for (int c = c0; c < c1; c += 4) {
    const float4 w = *reinterpret_cast<const float4*>(W + lay.at(orow, c));
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(xr[r] + c);
      a[r] = fmaf(v.x, w.x, a[r]);
      a[r] = fmaf(v.y, w.y, a[r]);
      a[r] = fmaf(v.z, w.z, a[r]);
      a[r] = fmaf(v.w, w.w, a[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    a[r] += __shfl_xor_sync(0xffffffffu, a[r], 8);
    a[r] += __shfl_xor_sync(0xffffffffu, a[r], 16);
  }
  if (ks == 0 && o < O)
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (b0 + r < nrows) epi(b0 + r, o, a[r]);
}

// out[b, o] = epi(sum_c x[b, c] W(o, c)) for the CTA's `nrows` rows b and
// o < O: the (8 outputs, 4 rows) items of rows_item spread over the
// warps, og fastest.  One barrier.
template <int kUnroll = 2, class Lay, class Epi>
__device__ __forceinline__ void product_rows(const float* x, int RS, int nrows,
                                             const float* W, Lay lay, int Kc,
                                             int O, const Epi& epi) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int NG = cdiv(O, 8), NB = cdiv(nrows, kGroup);
  for (int it = warp; it < NG * NB; it += nw)
    rows_item<kUnroll>(x, RS, nrows, W, lay, Kc, O, it % NG,
                       (it / NG) * kGroup, epi);
  __syncthreads();
}

// out[b, o] = epi(sum_c x[b, c] W(c, o)): the VJPs' products down a
// weight's columns.  There the 4 quarters of a warp would read rows a
// chunk apart, in the same banks, so a warp's work item is (64 outputs,
// contraction chunk): each lane runs the chunk for 2 outputs, 32 apart
// (consecutive lanes, consecutive words), and 4 rows; the items' partial
// sums go through P (kGroup * max(O, the warps x 64) floats of shared
// memory), where one thread per (row, o) adds the chunks in order and
// applies the epilogue.  kUnroll as rows_item's; at most max_ks chunks
// (P then holds kGroup max_ks O floats).
template <int kUnroll = 2, class Lay, class Epi>
__device__ __forceinline__ void product_cols(const float* x, int RS, int nrows,
                                             const float* W, Lay lay, int Kc,
                                             int O, float* P, const Epi& epi,
                                             int max_ks = 1 << 30) {
  const int nth = blockDim.x, nw = nth >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NG = cdiv(O, 32 * kOut);
  const int KS = min(NG < nw ? nw / NG : 1, max_ks);
  const int KC = round4(cdiv(Kc, KS));
  for (int b0 = 0; b0 < nrows; b0 += kGroup) {
    for (int it = warp; it < KS * NG; it += nw) {
      const int og = it % NG, ks = it / NG;
      const int c0 = ks * KC, c1 = min(Kc, c0 + KC);
      const float* xr[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) xr[r] = x + min(b0 + r, nrows - 1) * RS;
      int o[kOut];
      bool live[kOut];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        o[j] = og * 32 * kOut + 32 * j + lane;
        live[j] = o[j] < O;
        if (!live[j]) o[j] = O - 1;  // a valid column, its sums unused
      }
      float a[kOut][kGroup] = {};
#pragma unroll kUnroll
      for (int c = c0; c < c1; c += 4) {
        float4 v[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          v[r] = *reinterpret_cast<const float4*>(xr[r] + c);
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          const float4 w =
              make_float4(W[lay.at(c, o[j])], W[lay.at(c + 1, o[j])],
                          W[lay.at(c + 2, o[j])], W[lay.at(c + 3, o[j])]);
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            a[j][r] = fmaf(v[r].x, w.x, a[j][r]);
            a[j][r] = fmaf(v[r].y, w.y, a[j][r]);
            a[j][r] = fmaf(v[r].z, w.z, a[j][r]);
            a[j][r] = fmaf(v[r].w, w.w, a[j][r]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        if (live[j])
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            P[(ks * kGroup + r) * O + o[j]] = a[j][r];
    }
    __syncthreads();
    for (int it = threadIdx.x; it < kGroup * O; it += nth) {
      const int r = it / O, o = it - r * O, b = b0 + r;
      if (b >= nrows) continue;
      float s = P[r * O + o];
      for (int ks = 1; ks < KS; ++ks) s += P[(ks * kGroup + r) * O + o];
      epi(b, o, s);
    }
    __syncthreads();
  }
}

// Floats of P a column product over O outputs needs with `threads` a CTA.
__host__ __device__ inline int cols_partials(int O, int threads) {
  const int span = (threads / 32) * 32 * kOut;
  return kGroup * (O > span ? O : span);
}

// Launches kernel(args) as one cluster of C CTAs of `threads` threads with
// `bytes` of dynamic shared memory each; an error if the card cannot run
// it.  The attributes and the occupancy check run once for each kernel,
// device, C and shared-memory size; later launches skip them.
template <class Args>
int launch_cluster(void (*kernel)(Args), Args& args, int C, int threads,
                   size_t bytes, size_t budget, cudaStream_t stream) {
  static std::mutex mu;
  static std::set<std::tuple<const void*, int, int, size_t>> checked;
  if (bytes > budget || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple((const void*)kernel, dev, C, bytes);
  std::lock_guard<std::mutex> lock(mu);
  const bool known = checked.count(key) > 0;
  if (!known) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)budget);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!known) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;
    checked.insert(key);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches kernel(args) as a cooperative grid of G CTAs of `threads`
// threads with `bytes` of dynamic shared memory each, the row policy past
// one cluster; an error if the card cannot hold them all at once.
template <class Args>
int launch_row_grid(void (*kernel)(Args), Args& args, int G, int threads,
                    size_t bytes, size_t budget, cudaStream_t stream) {
  static std::mutex mu;
  static std::set<std::tuple<const void*, int, int, size_t>> checked;
  if (bytes > budget) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple((const void*)kernel, dev, G, bytes);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!checked.count(key)) {
      int sms = 0, occ = 0;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)budget);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                            threads, bytes);
      if (err != cudaSuccess) return (int)err;
      if ((long long)occ * sms < G)
        return (int)cudaErrorCooperativeLaunchTooLarge;
      checked.insert(key);
    }
  }
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(G),
                                    dim3(threads), params, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace row_products
