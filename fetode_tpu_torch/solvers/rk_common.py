"""The generic explicit-RK stage loop and the scaled error norm
(counterpart of ``fetode_tpu/solvers/rk_common.py``).

The JAX package works on pytrees; the port's states are tensors whose
leading axis is the row (trajectory) axis, so ``t`` and ``dt`` arrive as
``(B, 1)`` columns and broadcast against a ``(B, D)`` state.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fetode_tpu_torch.solvers.tableaux import ButcherTableau


def combination(coeffs: Sequence[float], ks: Sequence[torch.Tensor]):
    """sum_i coeffs[i] * ks[i], skipping exact-zero coefficients, summed in
    the JAX package's order; None when every coefficient is zero."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        acc = c * k if acc is None else acc + c * k
    return acc


def rk_stage_loop(func: Callable, t, y: torch.Tensor, dt, tableau: ButcherTableau,
                  args=(), f0: torch.Tensor | None = None):
    """Run the explicit stage recursion of ``tableau`` once.

    If ``f0`` is given it is used as the first stage (FSAL reuse).

    Returns ``(y1, y_err, ks)`` — the step solution, the embedded error
    estimate (or None), and all stage derivatives.
    """
    ks = []
    for i in range(len(tableau.b)):
        if i == 0 and f0 is not None:
            ks.append(f0)
            continue
        yi = y if i == 0 else y + dt * combination(tableau.a[i][:i], ks)
        ks.append(func(t + tableau.c[i] * dt, yi, *args))
    y1 = y + dt * combination(tableau.b, ks)
    y_err = None
    if tableau.b_err is not None:
        y_err = dt * combination(tableau.b_err, ks)
    return y1, y_err, ks


def error_norm(y_err: torch.Tensor, y0: torch.Tensor, y1: torch.Tensor,
               rtol, atol) -> torch.Tensor:
    """Scaled RMS error norm over the last axis: one value per row."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    r = y_err / scale
    return torch.sqrt((r * r).mean(dim=-1))
