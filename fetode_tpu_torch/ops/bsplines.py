"""B-spline basis evaluation and least-squares coefficient fitting.

Counterpart of ``fetode_tpu/ops/bsplines.py``: the Cox-de Boor recursion
on a per-feature knot grid, the batched least-squares fit of spline
coefficients, and ``refine_grid``, the data-adaptive knot grid of the
live grid refit (``nn/kan.py: kan_update_grid``).

Shapes
------
grid  : (in_features, grid_size + 2*spline_order + 1)   knot vector per input
x     : (..., in_features)
bases : (..., in_features, grid_size + spline_order)
"""

from __future__ import annotations

import numpy as np
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


def quantile_indices(batch: int, grid_size: int) -> np.ndarray:
    """The sample ranks ``refine_grid`` takes as knots: the JAX package's
    ``jnp.linspace(0, batch - 1, grid_size + 1).astype(int32)``, its float32
    arithmetic reproduced as XLA compiles it (the division by
    ``grid_size`` folded into a float32 reciprocal and reassociated: point
    i is ``i * ((batch - 1) * (1 / grid_size))``, the last exact), then
    truncated.  A float64 or a plain float32 linspace rounds some ranks
    the other way (at batch 109, grid 12, point 7 is 63, not 62)."""
    r = np.float32(1.0) / np.float32(grid_size)
    pts = np.arange(grid_size, dtype=np.float32) * (np.float32(batch - 1) * r)
    pts = np.append(pts, np.float32(batch - 1))
    return pts.astype(np.int32).astype(np.int64)


def refine_grid(x: torch.Tensor, grid_size: int, spline_order: int,
                grid_eps: float = 0.02, margin: float = 0.01
                ) -> torch.Tensor:
    """Data-adaptive knot grid blended with a uniform grid (the capability
    of the reference's ``update_grid``, ``efficientkan.py:184-221``):
    interior knots are a ``grid_eps`` blend of uniform spacing and
    empirical quantiles of ``x``, extended by ``spline_order`` knots on
    each side.  The same knot count as before, so every kernel that reads
    a grid takes the refit one.

    Args:
      x: (batch, in_features) samples observed by the layer.

    Returns:
      (in_features, grid_size + 2*spline_order + 1) new knot grid.
    """
    batch = x.shape[0]
    xs = torch.sort(x, dim=0).values                          # (B, in)
    idx = torch.from_numpy(quantile_indices(batch, grid_size)).to(x.device)
    grid_adaptive = xs[idx]                                   # (G+1, in)

    span = xs[-1] - xs[0] + 2 * margin                        # (in,)
    step = span / grid_size
    ar = torch.arange(grid_size + 1, dtype=x.dtype, device=x.device)[:, None]
    grid_uniform = ar * step[None, :] + xs[0][None, :] - margin

    interior = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive

    kw = dict(dtype=x.dtype, device=x.device)
    below = interior[:1] - step[None, :] * torch.arange(
        spline_order, 0, -1, **kw)[:, None]
    above = interior[-1:] + step[None, :] * torch.arange(
        1, spline_order + 1, **kw)[:, None]
    full = torch.cat([below, interior, above], dim=0)         # (G+2k+1, in)
    return full.T.contiguous()
