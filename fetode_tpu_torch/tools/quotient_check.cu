// Bit checks of the fields' quotients (csrc/knot_quotient.cuh, through
// csrc/kanfet_field.cuh) against
// the IEEE operations they replace, one value a thread: rcp_sigmoid(d)
// against 1.0f / d below 2^126 and div_knot(a, b) against a / b.  Also
// sigmoid(z) against plain float32's rounding, each operation rounded
// once (exp, then the add, then the quotient): where rcp_sigmoid holds,
// a difference there comes from nvcc contracting 1.0f + expf(-z), not
// from the quotient.  bad[0..2] count the mismatches of each.
#include "../csrc/kanfet_field.cuh"

namespace {

__global__ void quotient_check_kernel(const float* x, const float* a,
                                      const float* b, int n, unsigned* bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float d = 1.0f + x[i];
  if (d < 0x1p126f &&
      __float_as_uint(1.0f / d) != __float_as_uint(kanfet::rcp_sigmoid(d)))
    atomicAdd(bad, 1u);
  if (__float_as_uint(a[i] / b[i]) !=
      __float_as_uint(kanfet::div_knot(a[i], b[i])))
    atomicAdd(bad + 1, 1u);
  const float z = 9.0f * a[i];
  if (__float_as_uint(1.0f / __fadd_rn(1.0f, expf(-z))) !=
      __float_as_uint(kanfet::sigmoid(z)))
    atomicAdd(bad + 2, 1u);
}

}  // namespace

extern "C" int quotient_check(const float* x, const float* a, const float* b,
                              int n, unsigned* bad) {
  quotient_check_kernel<<<(n + 255) / 256, 256>>>(x, a, b, n, bad);
  return (int)cudaGetLastError();
}
