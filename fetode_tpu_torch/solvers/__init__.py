"""ODE integrators (counterpart of ``fetode_tpu/solvers/__init__.py``).

``odeint`` is the torchdiffeq-style entry point the reference calls
(``odeint(func, y0, t, method=..., rtol=..., atol=...)``): adaptive
dopri5, the fixed-step methods, the stateful fixed-step integrators and
the continuous adjoint, with the JAX package's exports.
"""

from __future__ import annotations

from typing import Callable

import torch

from fetode_tpu_torch.solvers.adjoint import odeint_adjoint  # noqa: F401
from fetode_tpu_torch.solvers.dopri5 import (  # noqa: F401
    Dopri5Stats,
    odeint_dopri5,
)
from fetode_tpu_torch.solvers.fixed import (  # noqa: F401
    integrate_final,
    odeint_fixed,
    rollout_discrete,
)
from fetode_tpu_torch.solvers.stateful import (  # noqa: F401
    integrate_final_stateful,
    odeint_fixed_stateful,
)
from fetode_tpu_torch.solvers.tableaux import FIXED_TABLEAUX  # noqa: F401

ADAPTIVE_METHODS = ("dopri5",)
FIXED_METHODS = tuple(FIXED_TABLEAUX)


def odeint(func: Callable, y0: torch.Tensor, ts: torch.Tensor, *args,
           method: str = "dopri5", rtol: float = 1e-7, atol: float = 1e-9,
           **options):
    """Integrate ``dy/dt = func(t, y, *args)``, reporting states at ``ts``.

    method: 'dopri5' (adaptive) or any fixed method in ``FIXED_METHODS``.
    Fixed methods take ``n_substeps``; dopri5 takes ``max_steps``, ``mode``
    ('auto' | 'scan' | 'while'), ``norm_fn``, ``full_output``.
    """
    if method in ADAPTIVE_METHODS:
        return odeint_dopri5(func, y0, ts, *args, rtol=rtol, atol=atol,
                             **options)
    if method in FIXED_TABLEAUX:
        return odeint_fixed(func, y0, ts, *args, method=method, **options)
    raise ValueError(f"unknown method {method!r}; "
                     f"choose from {ADAPTIVE_METHODS + FIXED_METHODS}")
