"""Fixed-step integration with an auxiliary side-state channel
(counterpart of ``fetode_tpu/solvers/stateful.py``).

Hysteretic vector fields carry discrete device state (branch signs, last
field) that is not part of the continuous ODE state: it has no
derivative, does not enter error control, and advances by jumps.  Within
a step every stage sees the state frozen at the step's start; the state
advances once per step, from the evaluation at the step's start.
``func`` has the signature

    func(t, y, s, *args) -> (dy, s_next)

and the integrators return the trajectory (or final state) and the final
side state.  ``s`` is whatever ``func`` takes (a tensor, a tuple of
them).  As in ``solvers/fixed.py`` the steps are a Python loop that
autograd records, with no rematerialisation (the JAX package's
``checkpoint`` switch).
"""

from __future__ import annotations

from typing import Callable

import torch

from fetode_tpu_torch.solvers.fixed import fixed_tableau
from fetode_tpu_torch.solvers.rk_common import rk_stage_loop


def _step(func, tableau, t, y, s, dt, n_substeps, args, advance_state):
    """One interval: the side state's advance from ``(t, y, s)`` and
    ``n_substeps`` steps of ``tableau`` on the state frozen at ``s``."""
    _, s1 = func(t, y, s, *args)

    def frozen(tt, yy):
        return func(tt, yy, s, *args)[0]

    for i in range(n_substeps):
        y, _, _ = rk_stage_loop(frozen, t + i * dt, y, dt, tableau)
    return y, (s1 if advance_state else s)


def odeint_fixed_stateful(func: Callable, y0: torch.Tensor, s0, ts, *args,
                          method: str = "rk4", n_substeps: int = 1,
                          advance_state: bool = True):
    """Fixed-grid trajectory with a per-interval side-state advance.

    Returns ``(traj (T, *y0.shape), s_final)``.  With
    ``advance_state=False`` the side state stays ``s0`` for the whole
    solve.
    """
    tableau = fixed_tableau(method)
    out, y, s = [y0], y0, s0
    for j in range(ts.shape[0] - 1):
        dt = (ts[j + 1] - ts[j]) / n_substeps
        y, s = _step(func, tableau, ts[j], y, s, dt, n_substeps, args,
                     advance_state)
        out.append(y)
    return torch.stack(out), s


def integrate_final_stateful(func: Callable, y0: torch.Tensor, s0, t0, t1,
                             *args, method: str = "rk4", n_steps: int = 8,
                             advance_state: bool = True):
    """The final state and side state after ``n_steps`` equal steps from
    ``t0`` to ``t1``; the times are tensors of the state's dtype."""
    tableau = fixed_tableau(method)
    kw = dict(dtype=y0.dtype, device=y0.device)
    t0 = torch.as_tensor(t0, **kw)
    dt = (torch.as_tensor(t1, **kw) - t0) / n_steps
    y, s = y0, s0
    for i in range(n_steps):
        y, s = _step(func, tableau, t0 + i * dt, y, s, dt, 1, args,
                     advance_state)
    return y, s
