"""Fixed-step ODE integration (counterpart of
``fetode_tpu/solvers/fixed.py``).

One tableau-driven stage loop (``rk_common.rk_stage_loop``) covers Euler,
the explicit midpoint ("rk2"), Heun, the classical RK4 and
Dormand-Prince's 5th-order row without step control.  The JAX package
scans the steps under ``jax.checkpoint``; here they are a Python loop that
autograd records as it runs.  No step is rematerialised: a right-hand
side may draw device noise from a ``torch.Generator``, and a recomputed
step would draw other numbers.  States are tensors (the JAX package takes
pytrees).
"""

from __future__ import annotations

from typing import Callable

import torch

from fetode_tpu_torch.solvers.rk_common import rk_stage_loop
from fetode_tpu_torch.solvers.tableaux import FIXED_TABLEAUX, ButcherTableau


def fixed_tableau(method: str) -> ButcherTableau:
    """The tableau of a fixed-step ``method``; a ValueError names the
    choices."""
    if method not in FIXED_TABLEAUX:
        raise ValueError(f"unknown fixed-step method {method!r}: expected "
                         f"one of {sorted(FIXED_TABLEAUX)}")
    return FIXED_TABLEAUX[method]


def odeint_fixed(func: Callable, y0: torch.Tensor, ts: torch.Tensor, *args,
                 method: str = "rk4", n_substeps: int = 1) -> torch.Tensor:
    """Integrate ``dy/dt = func(t, y, *args)`` on the grid ``ts``, each
    interval in ``n_substeps`` equal steps of ``method``.

    Returns the trajectory (T, *y0.shape), ``out[0]`` being ``y0``.
    """
    tableau = fixed_tableau(method)
    out, y = [y0], y0
    for j in range(ts.shape[0] - 1):
        t0 = ts[j]
        dt = (ts[j + 1] - t0) / n_substeps
        for i in range(n_substeps):
            y, _, _ = rk_stage_loop(func, t0 + i * dt, y, dt, tableau, args)
        out.append(y)
    return torch.stack(out)


def integrate_final(func: Callable, y0: torch.Tensor, t0, t1, *args,
                    method: str = "rk4", n_steps: int = 8) -> torch.Tensor:
    """Integrate from ``t0`` to ``t1`` in ``n_steps`` equal steps of
    ``method`` and return only the final state.  The times are tensors of
    the state's dtype, as the JAX package forms them."""
    tableau = fixed_tableau(method)
    kw = dict(dtype=y0.dtype, device=y0.device)
    t0 = torch.as_tensor(t0, **kw)
    dt = (torch.as_tensor(t1, **kw) - t0) / n_steps
    y = y0
    for i in range(n_steps):
        y, _, _ = rk_stage_loop(func, t0 + i * dt, y, dt, tableau, args)
    return y


def rollout_discrete(step_fn: Callable, x0: torch.Tensor, n_steps: int, *args,
                     residual_dt: float | None = None) -> torch.Tensor:
    """The autoregressive rollout ``x <- step_fn(x, *args)``, or ``x <- x +
    residual_dt * step_fn(x, *args)``; returns the trajectory including
    ``x0`` (n_steps + 1, *x0.shape)."""
    out, x = [x0], x0
    for _ in range(n_steps):
        dx = step_fn(x, *args)
        x = dx if residual_dt is None else x + residual_dt * dx
        out.append(x)
    return torch.stack(out)
