"""The KAN layer's spline term, B-spline basis and product in one CUDA
kernel, with its plain PyTorch version.

Counterpart of ``fetode_tpu/ops/pallas_spline.py`` (the TPU kernel
``spline_matmul_fused`` at :65).  The CUDA source is
``fetode_tpu_torch/csrc/spline.cu``; its header gives the design and what
bounds it: each CTA forms the bases of a row tile once for every output
it owns, a two-stage ``cp.async`` ring feeds it the weight tiles, and the
input groups of an output tile are the CTAs of a thread-block cluster
whose partial sums are added through distributed shared memory in a
fixed order (no scratch tensor, one launch).  With x (B, in), the knot
rows grid (in, G + 2k + 1) and the *scaled* spline weight (out, in, G +
k):

    y[b, o] = sum_{i, c} bsplines(x)[b, i, c] * weight[o, i, c]

* ``spline_matmul_reference`` — the plain version: ``bspline_basis``,
  then the product (the JAX module's ``_ref``, :136-138).
* ``spline_matmul_fused`` — the dispatch: a CPU tensor takes the plain
  version; a CUDA float32 tensor launches the kernel (counted in
  ``.launches``), as a ``torch.autograd.Function`` whose backward
  recomputes the plain version and takes its VJP for x and the weight,
  and gives the grid no gradient (the JAX custom VJP, :145-149, has no
  backward kernel either); any other CUDA input raises.
* ``spline_matmul_vjp`` — that backward, usable on either device.

The operands are read as given on every call (nothing is cached).  The
kernel takes row-strided x, grid and weight whose last dimension is
contiguous and whose weight has its (in, C) block contiguous, so a column
slice of a layer's weight (``models/cond_diffusion.py: _kan_partial``)
needs no copy; any other weight is copied first.  The kernel sums each
output in a fixed order set by ``in`` and C alone, so a row gives the
same bits alone and inside any batch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.bsplines import bspline_basis

_KERNEL_NAME = "spline"
_WHAT = "spline_matmul_fused (ROADMAP B.12)"


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spline_matmul.argtypes = [P] * 4 + [I] * 5 + [L] * 4 + [P]
    lib.spline_matmul.restype = ctypes.c_int
    lib.spline_matmul_groups.argtypes = [I] * 3
    lib.spline_matmul_groups.restype = ctypes.c_int
    for fn in (lib.spline_matmul_max_knots, lib.spline_matmul_max_order):
        fn.argtypes, fn.restype = [], ctypes.c_int
    lib.limits = (lib.spline_matmul_max_knots(),
                  lib.spline_matmul_max_order())
    return lib


def _check(x: torch.Tensor, grid: torch.Tensor, weight: torch.Tensor,
           order: int) -> None:
    if x.ndim != 2 or grid.ndim != 2 or weight.ndim != 3:
        raise ValueError(f"{_WHAT}: x must be (B, in), grid (in, n_knots), "
                         f"weight (out, in, C); got {tuple(x.shape)}, "
                         f"{tuple(grid.shape)}, {tuple(weight.shape)}")
    n_in, n_knots = grid.shape
    C = n_knots - 1 - order
    if order < 0 or C < 1 or x.shape[1] != n_in or \
            tuple(weight.shape[1:]) != (n_in, C):
        raise ValueError(f"{_WHAT}: x {tuple(x.shape)}, grid "
                         f"{tuple(grid.shape)} and weight "
                         f"{tuple(weight.shape)} do not match order {order} "
                         f"(weight (out, in, n_knots - 1 - order))")


def spline_matmul_reference(x: torch.Tensor, grid: torch.Tensor,
                            weight: torch.Tensor, order: int
                            ) -> torch.Tensor:
    """The plain version: ``bspline_basis(x)`` flattened to (B, in*C), times
    the weight flattened to (out, in*C), transposed -> (B, out)."""
    bases = bspline_basis(x, grid, order)
    return bases.reshape(x.shape[0], -1) @ weight.reshape(
        weight.shape[0], -1).T


def spline_matmul_vjp(ybar: torch.Tensor, x: torch.Tensor, grid: torch.Tensor,
                      weight: torch.Tensor, order: int, need_x: bool = True,
                      need_w: bool = True):
    """The backward of the spline term: the plain version recomputed at the
    same inputs and its VJP -> ``(xbar or None, weightbar or None)``."""
    if not (need_x or need_w):
        return None, None
    wrt = [t.detach().requires_grad_(True) if need else t.detach()
           for t, need in ((x, need_x), (weight, need_w))]
    with torch.enable_grad():
        y = spline_matmul_reference(wrt[0], grid.detach(), wrt[1], order)
        grads = torch.autograd.grad(
            y, [t for t, need in zip(wrt, (need_x, need_w)) if need], ybar)
    grads = list(grads)
    return (grads.pop(0) if need_x else None,
            grads.pop(0) if need_w else None)


def _launch(x: torch.Tensor, grid: torch.Tensor, weight: torch.Tensor,
            order: int) -> torch.Tensor:
    """One kernel launch: y (B, out) float32."""
    dev = x.device
    for t, name in ((x, "x"), (grid, "grid"), (weight, "weight")):
        if t.device != dev:
            raise ValueError(f"{_WHAT}: {name} on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{_WHAT}: the kernel takes float32 operands, "
                            f"got {name} {t.dtype}")
    lib = _lib()
    n_knots = grid.shape[1]
    max_knots, max_order = lib.limits
    if n_knots > max_knots or order > max_order:
        raise ValueError(f"{_WHAT}: the kernel is compiled for at most "
                         f"{max_knots} knots and order {max_order}, got "
                         f"{n_knots} knots, order {order}")
    x, grid = (t.detach() if t.stride(-1) == 1 else t.detach().contiguous()
               for t in (x, grid))
    C = n_knots - 1 - order
    weight = weight.detach()
    if weight.stride(-1) != 1 or weight.stride(1) != C:
        weight = weight.contiguous()
    B, n_in = x.shape
    O = weight.shape[0]
    y = torch.empty((B, O), dtype=torch.float32, device=dev)
    if B == 0 or O == 0:
        return y
    NC.launch(lib.spline_matmul, NC.ptr(x), NC.ptr(grid), NC.ptr(weight),
              NC.ptr(y), B, n_in, O, n_knots, int(order),
              x.stride(0), grid.stride(0), weight.stride(0),
              weight.stride(1), name="spline_matmul_fused", device=dev)
    spline_matmul_fused.launches += 1
    return y


class _SplineMatmul(torch.autograd.Function):
    """The kernel forward and the recomputing plain backward; the grid gets
    no gradient."""

    @staticmethod
    def forward(ctx, x, grid, weight, order):
        y = _launch(x, grid, weight, order)
        ctx.save_for_backward(x, grid, weight)
        ctx.order = order
        return y

    @staticmethod
    def backward(ctx, ybar):
        x, grid, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        xbar, wbar = spline_matmul_vjp(ybar, x, grid, weight, ctx.order,
                                       need_x=need[0], need_w=need[2])
        return xbar, None, wbar, None


def spline_matmul_fused(x: torch.Tensor, grid: torch.Tensor,
                        weight: torch.Tensor, order: int) -> torch.Tensor:
    """The spline term ``y[b, o] = sum_{i,c} B(x)[b, i, c] w[o, i, c]`` of
    x (B, in), grid (in, G + 2k + 1) and the scaled spline weight (out, in,
    G + k) -> (B, out).  One kernel launch for CUDA float32 tensors; the
    plain version for CPU tensors; a CUDA tensor of another type
    raises."""
    _check(x, grid, weight, order)
    if x.device.type == "cpu":
        return spline_matmul_reference(x, grid, weight, order)
    if x.device.type != "cuda":
        raise ValueError(f"{_WHAT} runs on CUDA (or CPU, through its plain "
                         f"version), got a tensor on {x.device}")
    return _SplineMatmul.apply(x, grid, weight, int(order))


spline_matmul_fused.launches = 0
