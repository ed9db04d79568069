"""ODE integrators (counterpart of ``fetode_tpu/solvers/__init__.py``).

Ported so far: adaptive dopri5, the early-exit forward mode and the
differentiable scan mode.
"""

from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5  # noqa: F401
