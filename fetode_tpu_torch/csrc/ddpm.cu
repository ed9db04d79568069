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
// Rows are independent, so there is no grid-wide step: a block owns a
// tile of kRT * 4 rows for all T steps and keeps their y, both hidden
// activations and cond_h in shared memory.  Each of the block's 256
// threads computes a kRT-row by 4-column tile of a hidden layer (the
// output columns of a warp contiguous, its rows shared, so its reads of
// the activations are broadcasts and its weight reads 512 contiguous
// bytes); the eps layer is one warp per (row, p) with a fixed shuffle
// tree.  W2 (H x H, 256 KB at H = 256) does not fit beside them in a
// block's 227 KB, so it is read transposed ([k][j], the caller's layout)
// through L1 from L2 on every step.  All arithmetic is FP32 FMAs in a
// fixed order (parity with the JAX kernel's Precision.HIGHEST products;
// TF32 tensor cores would not keep it), so the output is the same bits
// on every run.
//
// What bounds it on this card: 2 H (2 P + H) FP32 operations per row and
// step, about 139 k at H = 256, P = 8, so 71 GFLOP for 2,560 rows over 200
// steps, 1.06 ms at 67 TFLOP/s; its bytes (the noise table, cond_h, y)
// are 19 MB, 6 us.  It is bound by FP32 arithmetic.  The block's tile is
// 16 rows when that makes at least one block per SM, else 8 rows, so
// small batches still spread over more SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 32;

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

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int kRT>
__global__ void __launch_bounds__(kThreads) ddpm_chain_kernel(ChainArgs a) {
  constexpr int R = 4 * kRT;  // rows of the block's tile
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int P = a.P, H = a.H;
  float* const y = smem;          // (R, P)
  float* const h1 = y + R * P;    // (R, H)
  float* const h2 = h1 + R * H;   // (R, H)
  float* const ch = h2 + R * H;   // (R, H)
  const int row0 = blockIdx.x * R;
  const int nr = min(R, a.rows - row0);
  for (int i = threadIdx.x; i < R * P; i += blockDim.x)
    y[i] = i / P < nr ? a.y0[(size_t)row0 * P + i] : 0.0f;
  for (int i = threadIdx.x; i < R * H; i += blockDim.x)
    ch[i] = i / H < nr ? a.condh[(size_t)row0 * H + i] : 0.0f;
  __syncthreads();

  const int ncg = H / 4, ntask = (R / kRT) * ncg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int step = 0; step < a.T; ++step) {
    // Layer 1: h1 = silu(y W1y^T + cond_h + temb_h[step]).
    for (int task = threadIdx.x; task < ntask; task += blockDim.x) {
      const int j0 = (task % ncg) * 4, r0 = (task / ncg) * kRT;
      float acc[kRT][4] = {};
      for (int p = 0; p < P; ++p) {
        const float4 w = ldg4(a.w1yt + p * H + j0);
#pragma unroll
        for (int rr = 0; rr < kRT; ++rr) {
          const float yv = y[(r0 + rr) * P + p];
          acc[rr][0] += yv * w.x;
          acc[rr][1] += yv * w.y;
          acc[rr][2] += yv * w.z;
          acc[rr][3] += yv * w.w;
        }
      }
      const float4 tv = ldg4(a.temb + (size_t)step * H + j0);
      const float tvv[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) {
        const int o = (r0 + rr) * H + j0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          h1[o + c] = silu((acc[rr][c] + ch[o + c]) + tvv[c]);
      }
    }
    __syncthreads();
    // Layer 2: h2 = silu(h1 W2^T + b2), k in order.
    for (int task = threadIdx.x; task < ntask; task += blockDim.x) {
      const int j0 = (task % ncg) * 4, r0 = (task / ncg) * kRT;
      float acc[kRT][4] = {};
      // Unrolled so that several L2 reads of W2 are in flight at once.
#pragma unroll 4
      for (int k = 0; k < H; k += 4) {
        float4 w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = ldg4(a.w2t + (size_t)(k + q) * H + j0);
#pragma unroll
        for (int rr = 0; rr < kRT; ++rr) {
          const float4 hv = ld4(h1 + (r0 + rr) * H + k);
          const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[rr][0] += hq[q] * w[q].x;
            acc[rr][1] += hq[q] * w[q].y;
            acc[rr][2] += hq[q] * w[q].z;
            acc[rr][3] += hq[q] * w[q].w;
          }
        }
      }
      const float4 bv = ldg4(a.b2 + j0);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) {
        const int o = (r0 + rr) * H + j0;
#pragma unroll
        for (int c = 0; c < 4; ++c) h2[o + c] = silu(acc[rr][c] + bb[c]);
      }
    }
    __syncthreads();
    // eps = h2 W3^T + b3 and the posterior update, one warp per (r, p).
    const float c1 = a.coef[3 * step], c2 = a.coef[3 * step + 1];
    const float c3 = a.coef[3 * step + 2];
    for (int item = warp; item < R * P; item += nwarps) {
      const int r = item / P, p = item - r * P;
      const float* hrow = h2 + r * H;
      const float* wrow = a.w3 + p * H;
      float s = 0.0f;
      for (int k = lane; k < H; k += 32) s += hrow[k] * __ldg(wrow + k);
      s = warp_sum(s);
      if (lane == 0 && r < nr) {
        const float eps = s + a.b3[p];
        const float nz = a.noise[((size_t)step * a.rows + row0 + r) * P + p];
        y[item] = c1 * y[item] - c2 * eps + c3 * nz;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nr * P; i += blockDim.x)
    a.out[(size_t)row0 * P + i] = y[i];
}

template <int kRT>
int launch(const ChainArgs& a, cudaStream_t stream) {
  const int R = 4 * kRT;
  const size_t smem = sizeof(float) * ((size_t)R * a.P + 3 * (size_t)R * a.H);
  cudaError_t err = cudaFuncSetAttribute(
      ddpm_chain_kernel<kRT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.rows + R - 1) / R;
  ddpm_chain_kernel<kRT><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// y0 (rows, P), cond_h (rows, H), temb_h (T, H), noise (T, rows, P), coef
// (T, 3), W1y^T (P, H), W2^T (H, H), b2 (H), W3 (P, H), b3 (P) -> out
// (rows, P).  H must be a multiple of 4 and P at most 32; every pointer
// 16-byte aligned.
extern "C" int ddpm_chain(const float* y0, const float* condh,
                          const float* temb, const float* noise,
                          const float* coef, const float* w1yt,
                          const float* w2t, const float* b2, const float* w3,
                          const float* b3, float* out, int rows, int P, int H,
                          int T, void* stream) {
  if (rows <= 0) return 0;
  if (H % 4 != 0 || P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  ChainArgs a{y0, condh, temb, noise, coef, w1yt, w2t, b2, w3, b3, out,
              rows, P, H, T};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-row tiles once they make a block per SM, else 8-row tiles.
  return (rows + 15) / 16 >= sms ? launch<4>(a, s) : launch<2>(a, s);
}
