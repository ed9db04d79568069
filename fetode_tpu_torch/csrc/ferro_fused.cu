// The stateful ferroelectric-hysteresis layer op for Hopper (sm_90a): the
// layer's output and its new branch state in one launch, forward only.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_ferro.py:107
// (ferro_apply_fused, its kernel body _kernel :72).  For each sample b,
// input i, output o and basis k, with x (B, P), the state prev_x (B, P)
// and branch (B, P, O, K), and the parameters k, ec, ps, bias, coef
// (P, O, K):
//
//   up     = sig(g (x[b,i] - prev_x[b,i]))                   once per (b, i)
//   cp, cn = sig(g (x - ec)), sig(g (-x - ec))
//   su, sd = up cp, (1 - up) cn
//   target = su - sd + (1 - su - sd) branch
//   mom    = alpha branch + (1 - alpha) target
//   y[b,o] = sum_i sum_k coef (ps tanh(k (x + ec mom)) + bias)
//
// and target is the new branch, stored in the state's type (float32 or
// bfloat16); all arithmetic is float32.  sig is the logistic 1 / (1 +
// exp(-z)) or, with gate_impl "tanh", 0.5 + 0.5 tanh(z / 2), as the plain
// op (ops/ferro.py) chooses; the TPU kernel's fixed tanh form was a v5e
// workaround.  Everything up to the basis is rounded as the plain op
// rounds it, one operation at a time in its order (no FMA contraction):
// the target cancels to near zero where the gates balance, and there a
// contracted product would move it by many bfloat16 units.  The new
// branch is then plain's, bit for bit, as far as expf and tanhf agree.
// The update_branch flag of the config is honoured: with a null
// new_branch pointer nothing is stored (the TPU kernel ignores it).
//
// Layout (redesigned for Hopper): a block owns a group of samples (one
// at small B, up to kMaxGroup as B grows) and a chunk of outputs; a thread
// owns one (o, k) column and one slice of the inputs, and loads its
// parameters once for every sample of the group.
// The P inputs are cut into S contiguous slices of L (the last may be
// shorter), so a thread walks L inputs, not P: at P = 64 eight, where the
// first form walked all 64 in one chain of dependent sigmoids and tanhfs
// on a quarter of the SMs.  The threads of a slice hold consecutive
// columns, so their reads of branch[b, i, :, :] and of each parameter row
// [i, :, :] are contiguous across the warp.  The block first puts x[b, :]
// and the gate up[b, :] of its samples in shared memory (P sigmoids a
// sample, not one per term; with one slice, P is at most 8 and each
// thread forms them itself, without the block barrier).  Each thread adds a sample's terms in input
// order into its slice's
// partial; the partials meet in shared memory, each column's S partials
// added in slice order by the column's thread, then one thread per output
// folds its K column sums in order k = 0..K-1: every y has one owner and
// an order fixed by (P, O, K), never by B, no atomics, so the output is
// the same bits on every run and in any batch.  The wrapper
// (ops/ferro_fused.py: slice_plan) picks S, L and the chunk from (P, O,
// K) alone: slices of at most 8 inputs, more of them where a sample has
// few columns, and blocks of about 256 threads, so B = 8 at 64 -> 64, K =
// 12 gives 256 blocks.  The TPU kernel's 128-lane padding of O*K, its
// K-fold outside the kernel and its VMEM limit have no cause here and are
// not carried over.
//
// What bounds it on this card: the branch state read and written once,
// B P O K (4 + 4) bytes in float32, and the five parameter tensors read
// once, 20 P O K bytes: 4.1 MB at B = 8, P = O = 64, K = 12, 1.2 us at
// 3.35 TB/s; its three sigmoids-or-tanhs per term are about 0.6 us of the
// special-function unit.  So HBM bounds it, and at B = 8 the launch
// itself (a few us) is longer still.  Each block re-reads its chunk's
// parameters (from L2 after the first group): B / group times 20 P O K
// bytes of L2 traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;  // the most threads a block takes
constexpr int kMaxGroup = 4;       // the most samples a block takes

struct Args {
  const float* x;      // (B, P)
  const void* prev;    // (B, P), the state's type
  const void* branch;  // (B, P, O, K), the state's type
  const float* k;      // (P, O, K) each
  const float* ec;
  const float* ps;
  const float* bias;
  const float* coef;
  float* y;            // (B, O)
  void* new_branch;    // (B, P, O, K), the state's type; null: not stored
  int B, P, O, K;
  int S, L;            // input slices, inputs a slice (the last: fewer)
  int chunk;           // outputs a block owns
  int n_chunks;        // blocks a sample group takes
  float g, alpha, alpha1;  // gate slope, alpha, 1 - alpha
};

template <bool kTanh>
__device__ __forceinline__ float sig(float z) {
  return kTanh ? __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.5f, z))))
               : __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
}

__device__ __forceinline__ float load(const float* p, size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename St, bool kTanh, int G>
__global__ void __launch_bounds__(kMaxThreads)
ferro_fused_kernel(Args a) {
  extern __shared__ float smem[];
  const int P = a.P, O = a.O, K = a.K;
  const int W = a.chunk * K;       // columns a slice
  const int SW = a.S * W;          // partials a sample
  float* xs = smem;                // (G, P) x[b, :]
  float* ups = smem + G * P;       // (G, P) up[b, :]
  float* part = smem + 2 * G * P;  // (G, S, W) slice partials; slice 0
                                   // then the column sums
  const int b0 = (blockIdx.x / a.n_chunks) * G;
  const int nbk = min(G, a.B - b0);
  const int o0 = (blockIdx.x % a.n_chunks) * a.chunk;
  const int n_out = min(a.chunk, O - o0);
  const St* prev = static_cast<const St*>(a.prev);
  const St* branch = static_cast<const St*>(a.branch);
  St* nb = static_cast<St*>(a.new_branch);

  // With one slice a thread walks every input and forms x and up itself;
  // otherwise the block forms them once into shared memory.
  const bool own = a.S == 1;
  if (!own) {
    for (int q = threadIdx.x; q < nbk * P; q += blockDim.x) {
      const size_t bi = (size_t)b0 * P + q;
      const float xv = a.x[bi];
      xs[q] = xv;
      ups[q] = sig<kTanh>(__fmul_rn(a.g, __fsub_rn(xv, load(prev, bi))));
    }
    __syncthreads();
  }

  const int m = threadIdx.x;
  const int s = m / W, j = m - s * W;   // slice, (o, k) column in the chunk
  float acc[G];
#pragma unroll
  for (int bb = 0; bb < G; ++bb) acc[bb] = 0.0f;
  if (s < a.S && j < n_out * K) {
    // 32-bit offsets: the launcher takes B P O K < 2^31.
    const int OK = O * K, c = o0 * K + j;
    const int i1 = min(P, (s + 1) * a.L);
    for (int i = s * a.L; i < i1; ++i) {
      const int pi = i * OK + c;
      const float ec = load(a.ec, pi), kk = load(a.k, pi);
      const float ps = load(a.ps, pi), bias = load(a.bias, pi);
      const float cf = load(a.coef, pi);
#pragma unroll
      for (int bb = 0; bb < G; ++bb) {
        if (bb >= nbk) break;
        const int bi = (b0 + bb) * P + i, si = bi * OK + c;
        float xv, up;
        if (own) {
          xv = a.x[bi];
          up = sig<kTanh>(__fmul_rn(a.g, __fsub_rn(xv, load(prev, bi))));
        } else {
          xv = xs[bb * P + i];
          up = ups[bb * P + i];
        }
        const float br = load(branch, si);
        const float cp = sig<kTanh>(__fmul_rn(a.g, __fsub_rn(xv, ec)));
        const float cn = sig<kTanh>(__fmul_rn(a.g, __fsub_rn(-xv, ec)));
        const float su = __fmul_rn(up, cp);
        const float sd = __fmul_rn(__fsub_rn(1.0f, up), cn);
        const float target = __fadd_rn(
            __fsub_rn(su, sd),
            __fmul_rn(__fsub_rn(__fsub_rn(1.0f, su), sd), br));
        const float mom =
            __fadd_rn(__fmul_rn(a.alpha, br), __fmul_rn(a.alpha1, target));
        const float th =
            tanhf(__fmul_rn(kk, __fadd_rn(xv, __fmul_rn(ec, mom))));
        const float basis = __fadd_rn(__fmul_rn(ps, th), bias);
        acc[bb] = fmaf(basis, cf, acc[bb]);
        if (nb != nullptr) store(nb, si, target);
      }
    }
  }
  if (s < a.S) {
#pragma unroll
    for (int bb = 0; bb < G; ++bb)
      if (bb < nbk) part[bb * SW + m] = acc[bb];
  }
  __syncthreads();
  // Column j's partials of sample bb in slice order, by one thread; it
  // alone reads that column, so its sum may overwrite the slice-0 entry.
  // With one slice the partials are the column sums.
  if (a.S > 1) {
    for (int bb = 0; bb < nbk; ++bb)
      for (int q = threadIdx.x; q < n_out * K; q += blockDim.x) {
        float* pc = part + bb * SW + q;
        float col = pc[0];
#pragma unroll 4
        for (int r = 1; r < a.S; ++r) col += pc[r * W];
        pc[0] = col;
      }
    __syncthreads();
  }
  for (int bb = 0; bb < nbk; ++bb)
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      const float* pc = part + bb * SW + o * K;
      float y = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < K; ++kk) y += pc[kk];
      a.y[(size_t)(b0 + bb) * O + o0 + o] = y;
    }
}

using Kernel = void (*)(Args);

template <typename St, bool kTanh>
Kernel kernel_of_group(int group) {
  return group == 1   ? ferro_fused_kernel<St, kTanh, 1>
         : group == 2 ? ferro_fused_kernel<St, kTanh, 2>
                      : ferro_fused_kernel<St, kTanh, kMaxGroup>;
}

Kernel kernel_of(bool bf16, bool tanh_gate, int group) {
  if (bf16)
    return tanh_gate ? kernel_of_group<__nv_bfloat16, true>(group)
                     : kernel_of_group<__nv_bfloat16, false>(group);
  return tanh_gate ? kernel_of_group<float, true>(group)
                   : kernel_of_group<float, false>(group);
}

}  // namespace

// x (B, P) float32; prev_x (B, P) and branch (B, P, O, K) in the state's
// type (state_bf16: bfloat16, else float32); k, ec, ps, bias, coef (P, O,
// K) float32 -> y (B, O) float32 and, unless new_branch is null, the new
// branch (B, P, O, K) in the state's type.  Every array contiguous.  The
// plan (ops/ferro_fused.py: slice_plan): S slices of L inputs (S L >= P >
// (S - 1) L), chunk outputs a block, threads >= S chunk K (at most 1024)
// and smem = 4 (2 P + S chunk K) bytes a sample; group samples a block
// (1, 2 or 4, ops/ferro_fused.py: samples_per_block), which moves no sum.
extern "C" int ferro_fused(const float* x, const void* prev,
                           const void* branch, const float* k,
                           const float* ec, const float* ps,
                           const float* bias, const float* coef, float* y,
                           void* new_branch, int B, int P, int O, int K,
                           float g, float alpha, float alpha1, int tanh_gate,
                           int state_bf16, int S, int L, int chunk,
                           int threads, int smem, int group, void* stream) {
  if (B <= 0 || O <= 0) return 0;
  if (P < 1 || K < 1 || S < 1 || L < 1 || (long long)S * L < P ||
      (long long)(S - 1) * L >= P || chunk < 1 || chunk > O ||
      threads > kMaxThreads || (long long)S * chunk * K > threads ||
      (long long)smem != 4LL * (2LL * P + (long long)S * chunk * K) ||
      (group != 1 && group != 2 && group != kMaxGroup) ||
      (long long)B * P * O * K >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (O + chunk - 1) / chunk;
  const long long blocks = (long long)((B + group - 1) / group) * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a{x, prev, branch, k, ec, ps, bias, coef, y, new_branch,
         B, P, O, K, S, L, chunk, n_chunks, g, alpha, alpha1};
  smem *= group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(Args) = kernel_of(state_bf16 != 0, tanh_gate != 0, group);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(int)blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
