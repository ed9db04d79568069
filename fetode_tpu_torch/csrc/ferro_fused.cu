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
// Layout: a block owns one sample and a chunk of outputs; a thread owns
// one (o, k) column, so its reads of branch[b, i, :, :] and of each
// parameter row [i, :, :] are contiguous across the warp, and it walks i
// from 0 to P-1, adding its terms in that order.  The block first puts
// x[b, :] and the gate up[b, :] in shared memory (P sigmoids a block, not
// one per term).  At the end one thread per output sums its K column sums
// in order k = 0..K-1: every y has one owner and a fixed order, no atomics,
// so the output is the same bits on every run.  The TPU kernel's 128-lane
// padding of O*K, its K-fold outside the kernel and its VMEM limit have no
// cause here and are not carried over.
//
// What bounds it on this card: the branch state read and written once,
// B P O K (4 + 4) bytes in float32, and the five parameter tensors read
// once, 20 P O K bytes: 4.1 MB at B = 8, P = O = 64, K = 12, 1.2 us at
// 3.35 TB/s; its three sigmoids-or-tanhs per term are about 0.6 us of the
// special-function unit.  So HBM bounds it, and at B = 8 the launch
// itself (a few us) is longer still.  Each block re-reads the parameters
// (from L2 after the first sample): B times 20 P O K bytes of L2 traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // the most threads a block takes

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
  int chunk;           // outputs a block owns
  int n_chunks;        // blocks a sample takes
  float g, alpha, alpha1;  // gate slope, alpha, 1 - alpha
  int tanh_gate;       // 1: sig(z) = 0.5 + 0.5 tanh(z / 2)
};

__device__ __forceinline__ float sig(float z, int tanh_gate) {
  return tanh_gate ? __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.5f, z))))
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

template <typename S>
__global__ void __launch_bounds__(kThreads)
ferro_fused_kernel(Args a) {
  extern __shared__ float smem[];
  const int P = a.P, O = a.O, K = a.K;
  float* xs = smem;            // (P) x[b, :]
  float* ups = smem + P;       // (P) up[b, :]
  float* col = smem + 2 * P;   // (chunk * K) column sums
  const int b = blockIdx.x / a.n_chunks;
  const int o0 = (blockIdx.x % a.n_chunks) * a.chunk;
  const int n_out = min(a.chunk, O - o0);
  const S* prev = static_cast<const S*>(a.prev);
  const S* branch = static_cast<const S*>(a.branch);
  S* nb = static_cast<S*>(a.new_branch);

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float xv = a.x[(size_t)b * P + i];
    xs[i] = xv;
    ups[i] = sig(__fmul_rn(a.g, __fsub_rn(xv, load(prev, (size_t)b * P + i))),
                 a.tanh_gate);
  }
  __syncthreads();

  const int m = threadIdx.x;            // (o, k) column within the chunk
  float acc = 0.0f;
  if (m < n_out * K) {
    const size_t OK = (size_t)O * K;
    const size_t c = (size_t)o0 * K + m;
    const size_t srow = (size_t)b * P * OK + c;
    for (int i = 0; i < P; ++i) {
      const size_t pi = i * OK + c, si = srow + i * OK;
      const float xv = xs[i], up = ups[i];
      const float br = load(branch, si);
      const float ec = load(a.ec, pi);
      const float cp = sig(__fmul_rn(a.g, __fsub_rn(xv, ec)), a.tanh_gate);
      const float cn = sig(__fmul_rn(a.g, __fsub_rn(-xv, ec)), a.tanh_gate);
      const float su = __fmul_rn(up, cp);
      const float sd = __fmul_rn(__fsub_rn(1.0f, up), cn);
      const float target = __fadd_rn(
          __fsub_rn(su, sd), __fmul_rn(__fsub_rn(__fsub_rn(1.0f, su), sd), br));
      const float mom =
          __fadd_rn(__fmul_rn(a.alpha, br), __fmul_rn(a.alpha1, target));
      const float th = tanhf(
          __fmul_rn(load(a.k, pi), __fadd_rn(xv, __fmul_rn(ec, mom))));
      const float basis = __fadd_rn(__fmul_rn(load(a.ps, pi), th),
                                    load(a.bias, pi));
      acc = fmaf(basis, load(a.coef, pi), acc);
      if (nb != nullptr) store(nb, si, target);
    }
  }
  col[m] = acc;
  __syncthreads();
  if (m < n_out) {
    float s = 0.0f;
    for (int kk = 0; kk < K; ++kk) s += col[m * K + kk];
    a.y[(size_t)b * O + o0 + m] = s;
  }
}

}  // namespace

// x (B, P) float32; prev_x (B, P) and branch (B, P, O, K) in the state's
// type (state_bf16: bfloat16, else float32); k, ec, ps, bias, coef (P, O,
// K) float32 -> y (B, O) float32 and, unless new_branch is null, the new
// branch (B, P, O, K) in the state's type.  K at most 256; every array
// contiguous.
extern "C" int ferro_fused(const float* x, const void* prev,
                           const void* branch, const float* k,
                           const float* ec, const float* ps,
                           const float* bias, const float* coef, float* y,
                           void* new_branch, int B, int P, int O, int K,
                           float g, float alpha, float alpha1, int tanh_gate,
                           int state_bf16, void* stream) {
  if (B <= 0 || O <= 0) return 0;
  if (P < 1 || K < 1 || K > kThreads) return (int)cudaErrorInvalidValue;
  // Outputs a block owns: as many whole (o, K) groups as kThreads holds,
  // spread evenly over the blocks a sample takes.
  const int per = kThreads / K;
  const int n_chunks = (O + per - 1) / per;
  const int chunk = (O + n_chunks - 1) / n_chunks;
  const long long blocks = (long long)B * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a{x, prev, branch, k, ec, ps, bias, coef, y, new_branch,
         B, P, O, K, chunk, n_chunks, g, alpha, alpha1, tanh_gate};
  const int threads = ((chunk * K + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (2 * (size_t)P + threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        state_bf16 ? ferro_fused_kernel<__nv_bfloat16>
                   : ferro_fused_kernel<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (state_bf16)
    ferro_fused_kernel<__nv_bfloat16><<<(int)blocks, threads, smem, s>>>(a);
  else
    ferro_fused_kernel<float><<<(int)blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
