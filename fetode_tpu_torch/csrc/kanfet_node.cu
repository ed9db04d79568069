// Whole-solve KANFET NODE kernel for Hopper (sm_90a): a full adaptive
// dopri5 integration of any pure-KANFET [D, ..., D] vector field in one
// launch, with per-trajectory step control.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_node.py:260
// (pallas_kanfet_solve; kernel body _make_kernel :125, field
// _field_factory :67).  It computes what that kernel computes — Hairer
// initial step, PI controller, FSAL, CONTD5 dense output at T times,
// unreached tails holding the last state — and is held against the
// eager twin fetode_tpu_torch/ops/kanfet_node.py:kanfet_solve_reference.
//
// What bounds it on this card.  Each trajectory is a serial chain: about
// 100 attempts of 6 field evaluations, each evaluation 2*D*H*K ferro
// terms (320 for the flagship [2,10,2], K = 8) of two expf and a tanhf.
// The least time is the SFU's (exp2, reciprocal, tanh) work over the
// whole batch (PERF.md §6 row 1: 0.054 ms at B = 256), far below what a
// chain of dependent special-function latencies allows; the inputs are
// ~9 KB and the outputs B*T*D floats, so memory never bounds it.
//
// What the layout does about it.  One warp owns one trajectory
// (kanfet_field.cuh): the field's edge and ferro terms are spread over
// the 32 lanes (at the flagship 5-6 ferro terms a lane a layer instead of
// 320 in one thread), and at B = 256 the 256 warps fill 64 blocks, where
// one thread per trajectory filled 2 of the 132 SMs.  Within a lane the
// chain is latency: the sigmoid's reciprocal and the Cox-de Boor weights
// take IEEE's quotient without nvcc's branch to its slow path (which
// their operands never need; tools/quotient_check.py holds their bits),
// so a lane's independent terms overlap.  A block of kWarps warps copies
// the packed parameters and reads them from shared memory when they fit
// (opting in past 48 KB, up to 227 KB); larger stacks read them from
// global memory (__ldg; they stay in the 50 MB L2).  Each warp's scratch
// (layer buffers and per-input bases) lives in shared memory, or in a
// global slice when even that does not fit.  The wrapper chooses
// (ops/kanfet_node.py: smem_placement).
//
// Numerics: see kanfet_field.cuh, which holds the field and the solve
// that this kernel shares with the discrete-adjoint kernels.

#include "kanfet_field.cuh"

namespace {

using namespace kanfet;

// ROWS: trajectory b reads its times at ts + b * ts_stride; without it
// every trajectory reads the one row at ts (the shared-times launch keeps
// its own instantiation, the code it had before the stride existed).
template <bool PG, bool ROWS>
__global__ void __launch_bounds__(kThreads)
kanfet_node_kernel(const float* __restrict__ x0s, const float* __restrict__ ts,
                   const float* __restrict__ packed,
                   const int* __restrict__ dims, float* __restrict__ out,
                   float* __restrict__ gscratch, Geo geo, int B, int T,
                   int ts_stride, int max_steps, float rtol, float atol,
                   float gate, float alpha, float oma) {
  extern __shared__ float smem[];
  const float* P = stage_params<PG>(smem, packed, geo.n_params);
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp
  const Field F = make_field(geo, dims, P, smem + (PG ? 0 : geo.n_params),
                             gscratch, warp, gate, alpha, oma);
  NoRecord rec;
  dopri5_solve<PG>(F, x0s + (size_t)b * geo.D,
                   ROWS ? ts + (size_t)b * ts_stride : ts, T,
                   out + (size_t)b * T * geo.D, max_steps, rtol, atol, rec);
}

template <bool PG, bool ROWS>
cudaError_t launch(const float* x0s, const float* ts, const float* packed,
                   const int* dims, float* out, float* gscratch,
                   const Geo& geo, int B, int T, int ts_stride,
                   int max_steps, float rtol, float atol, float gate,
                   float alpha, float oma, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kanfet_node_kernel<PG, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kWarps - 1) / kWarps;
  kanfet_node_kernel<PG, ROWS><<<blocks, kThreads, geo.smem_bytes, stream>>>(
      x0s, ts, packed, dims, out, gscratch, geo, B, T, ts_stride, max_steps,
      rtol, atol, gate, alpha, oma);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success and a cudaError_t code if the launch failed.
// geo: the 13 host ints of kanfet_field.cuh: Geo; dims: the (L, 6) layer
// table on the device; gscratch: ceil(B / kWarps) * kWarps * ws_floats
// floats when the warp scratch is not in shared memory, else unused.
// Trajectory b reads its T output times at ts + b * ts_stride: 0 shares
// one (T,) row, T gives each trajectory its own row of a (B, T) array.
extern "C" int kanfet_node_solve(const float* x0s, const float* ts,
                                 const float* packed, const int* dims,
                                 float* out, float* gscratch, const int* geo,
                                 int B, int T, int ts_stride, int max_steps,
                                 float rtol, float atol, float gate,
                                 float alpha, float one_minus_alpha,
                                 void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kanfet::Geo g = kanfet::read_geo(geo);
  const auto fn = g.params_smem
                      ? (ts_stride ? launch<false, true> : launch<false, false>)
                      : (ts_stride ? launch<true, true> : launch<true, false>);
  return (int)fn(x0s, ts, packed, dims, out, gscratch, g, B, T, ts_stride,
                 max_steps, rtol, atol, gate, alpha, one_minus_alpha, s);
}
