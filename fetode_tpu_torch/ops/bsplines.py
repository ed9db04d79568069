"""B-spline basis evaluation and least-squares coefficient fitting.

Counterpart of ``fetode_tpu/ops/bsplines.py``: the Cox-de Boor recursion
on a per-feature knot grid, and the batched least-squares fit of spline
coefficients.  ``refine_grid`` (the adaptive grid refit) arrives with
the training slice.

Shapes
------
grid  : (in_features, grid_size + 2*spline_order + 1)   knot vector per input
x     : (..., in_features)
bases : (..., in_features, grid_size + spline_order)
"""

from __future__ import annotations

import torch


def make_grid(in_features: int, grid_size: int, spline_order: int,
              grid_range=(-1.0, 1.0), *, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """Uniform extended knot grid, one row per input feature.

    Knots run from ``grid_range[0] - spline_order*h`` to
    ``grid_range[1] + spline_order*h`` with ``h = span / grid_size``.
    """
    lo, hi = grid_range
    h = (hi - lo) / grid_size
    knots = torch.arange(-spline_order, grid_size + spline_order + 1,
                         device=device, dtype=dtype) * h + lo
    return knots.expand(in_features, knots.shape[0]).contiguous()


def bspline_basis(x: torch.Tensor, grid: torch.Tensor,
                  spline_order: int) -> torch.Tensor:
    """All degree-``spline_order`` B-spline basis functions at ``x``.

    Args:
      x:    (..., in_features) evaluation points.
      grid: (in_features, grid_size + 2*spline_order + 1) knot rows.

    Returns:
      (..., in_features, grid_size + spline_order) basis values.
    """
    grid = grid.to(x.dtype)
    xe = x[..., None]                                        # (..., in, 1)
    bases = ((xe >= grid[..., :-1]) & (xe < grid[..., 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left_num = xe - grid[..., : -(k + 1)]
        left_den = grid[..., k:-1] - grid[..., : -(k + 1)]
        right_num = grid[..., k + 1:] - xe
        right_den = grid[..., k + 1:] - grid[..., 1:-k]
        bases = ((left_num / left_den) * bases[..., :-1]
                 + (right_num / right_den) * bases[..., 1:])
    return bases


def curve2coeff(x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor,
                spline_order: int) -> torch.Tensor:
    """Fit spline coefficients so that ``spline(x) ~= y`` per (in, out) pair.

    One minimum-norm least-squares problem per input feature, solved on
    the CPU: ``torch.linalg.lstsq`` offers only the ``gels`` driver on
    CUDA, which needs full column rank, and the initial fit (G+1 samples
    for G+order coefficients) is under-determined.  This is init-time
    work; the result is moved back to ``x``'s device.

    Args:
      x: (batch, in_features) sample locations.
      y: (batch, in_features, out_features) target values.

    Returns:
      (out_features, in_features, grid_size + spline_order) coefficients.
    """
    device = x.device
    a = bspline_basis(x.cpu(), grid.cpu(), spline_order).transpose(0, 1)
    b = y.cpu().transpose(0, 1)                              # (in, B, out)
    sol = torch.linalg.lstsq(a, b, driver="gelsd").solution  # (in, C, out)
    return sol.permute(2, 0, 1).contiguous().to(device)
