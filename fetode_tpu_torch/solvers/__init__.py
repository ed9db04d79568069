"""ODE integrators (counterpart of ``fetode_tpu/solvers/__init__.py``).

Ported so far: adaptive dopri5, the early-exit forward mode and the
differentiable scan mode; the fixed-step solvers.
"""

from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5  # noqa: F401
from fetode_tpu_torch.solvers.fixed import (  # noqa: F401
    integrate_final,
    odeint_fixed,
    rollout_discrete,
)
