// Whole-solve KANFET NODE kernel for Hopper (sm_90a): a full adaptive
// dopri5 integration of a two-layer [D, H, D] KANFET vector field in one
// launch, with per-trajectory step control.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_node.py:260
// (pallas_kanfet_solve; kernel body _make_kernel :125, field
// _field_factory :67).  It computes what that kernel computes — Hairer
// initial step, PI controller, FSAL, CONTD5 dense output at T times,
// unreached tails holding the last state — and is held against the
// eager twin fetode_tpu_torch/ops/kanfet_node.py:kanfet_solve_reference.
//
// Design.  One thread per trajectory.  Its state, the seven stages, and
// t / dt / err_prev live in registers; it writes its own (T, D) rows of
// the (B, T, D) output.  The block first copies every layer's packed
// parameters (base weight, scaled spline weight, knot grid, five ferro
// arrays; about 2.1k floats for the flagship [2,10,2], K=8, grid 5) and
// the T output times into shared memory; from then on each thread reads
// them as broadcasts.  A KAN layer is a sum of per-edge functions, so the
// field walks the hidden units j = 0..H-1 one at a time: it forms hidden
// activation h_j from the D inputs and adds h_j's edge functions straight
// into the D outputs.  No hidden vector is kept, H and K are runtime
// values, and only D, the spline order and the knot count are template
// parameters (they size the register arrays).
//
// What bounds it on this card.  Work per trajectory is serial: about
// 100 attempts of 6 field evaluations, each evaluation 2*D*H*K ferro
// terms (320 for the flagship) of three expf and one tanhf, so the kernel
// is bound by the SFU/FP32 issue rate of the few warps it has, and by
// their latency — not by memory (inputs ~9 KB, outputs B*T*D floats).
// At the serving buckets (8, 64, 256) one thread per trajectory makes at
// most 2 blocks of 128 threads, so it fills at most 2 of the H100's 132
// SMs.  Spreading each trajectory's field over a warp (lanes over the
// hidden units and ferro terms, a warp-shuffle reduction per output) is
// the next step, for a later PR.
//
// Numerics: see kanfet_field.cuh, which holds the field and the solve
// that this kernel shares with the discrete-adjoint kernels.

#include "kanfet_field.cuh"

namespace {

using namespace kanfet;

template <int D, int ORD, int NK>
__global__ void __launch_bounds__(kThreads)
kanfet_node_kernel(const float* __restrict__ x0s, const float* __restrict__ ts_g,
                   const float* __restrict__ packed, float* __restrict__ out,
                   int B, int T, int H, int K, int max_steps, float rtol,
                   float atol, float gate, float alpha, float oma) {
  extern __shared__ float smem[];
  const float* ts;
  const Field p = load_field<D, ORD, NK>(smem, packed, ts_g, T, H, K, gate,
                                         alpha, oma, &ts);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  NoRecord rec;
  dopri5_solve<D, ORD, NK>(x0s + b * D, ts, T, out + (size_t)b * T * D,
                           max_steps, rtol, atol, p, rec);
}

template <int D, int ORD, int NK>
cudaError_t launch(const float* x0s, const float* ts, const float* packed,
                   float* out, int B, int T, int H, int K, int max_steps,
                   float rtol, float atol, float gate, float alpha, float oma,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(n_params<D, ORD, NK>(H, K) + T) * sizeof(float);
  const int blocks = (B + kThreads - 1) / kThreads;
  kanfet_node_kernel<D, ORD, NK><<<blocks, kThreads, smem, stream>>>(
      x0s, ts, packed, out, B, T, H, K, max_steps, rtol, atol, gate, alpha,
      oma);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// for a shape the kernel is not compiled for (the Python wrapper checks
// shapes first: fetode_tpu_torch/ops/kanfet_node.py KERNEL_SHAPES).
extern "C" int kanfet_node_solve(const float* x0s, const float* ts,
                                 const float* packed, float* out, int B, int T,
                                 int D, int H, int K, int spline_order,
                                 int n_knots, int max_steps, float rtol,
                                 float atol, float gate, float alpha,
                                 float one_minus_alpha, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 2 && spline_order == 3 && n_knots == 12)
    return (int)launch<2, 3, 12>(x0s, ts, packed, out, B, T, H, K, max_steps,
                                 rtol, atol, gate, alpha, one_minus_alpha, s);
  return -1;
}
