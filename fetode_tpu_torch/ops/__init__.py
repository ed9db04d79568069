"""Basis-function primitives and hand-written kernels (counterpart of
``fetode_tpu/ops/__init__.py``).

Modules are imported by path (``fetode_tpu_torch.ops.ferro`` ...); the
logistic bases are also exported here, as the JAX package exports them.
The CUDA kernels build on first use, never at import.
"""

from fetode_tpu_torch.ops.logistic import (  # noqa: F401
    HystereticLogisticParams,
    HystereticLogisticState,
    LogisticParams,
    hysteretic_logistic_basis,
    hysteretic_logistic_init,
    hysteretic_logistic_state,
    logistic_basis,
    logistic_init,
)
