"""Logistic basis functions (counterpart of ``fetode_tpu/ops/logistic.py``).

The plain basis, which ``nn/kan.py: kan_linear_apply`` uses (it is off
in KANFET stacks) and the ECG models' feature mixer is built on
(``models/ecg.py``), and the hysteretic two-branch variant, whose
carried state (``HystereticLogisticState``) is explicit, passed in and
returned.  Parameters draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fetode_tpu_torch.utils.init import normal, uniform


class LogisticParams(NamedTuple):
    """Per-feature logistic basis parameters, each ``(in_features, num_basis)``."""

    a: torch.Tensor  # slope
    b: torch.Tensor  # centre


def logistic_init(generator: torch.Generator, in_features: int,
                  num_basis: int, scale: float = 1.0, *, device=None,
                  dtype=torch.float32) -> LogisticParams:
    """``a``, ``b`` ~ ``scale`` * N(0, 1), each ``(in_features, num_basis)``."""
    shape = (in_features, num_basis)
    a = normal(generator, shape, device=device, dtype=dtype) * scale
    b = normal(generator, shape, device=device, dtype=dtype) * scale
    return LogisticParams(a=a, b=b)


def logistic_basis(params: LogisticParams, x: torch.Tensor) -> torch.Tensor:
    """``2 * sigmoid(a * (x - b))`` per feature and basis function.

    Args:
      x: (..., in_features)
    Returns:
      (..., in_features, num_basis)
    """
    return 2.0 * torch.sigmoid(params.a * (x[..., None] - params.b))


class HystereticLogisticState(NamedTuple):
    """Carried state of the two-branch hysteretic logistic basis.

    prev_x : (..., in_features)              last seen input
    branch : (..., in_features, num_basis)   1.0 = up branch, 0.0 = down branch
    """

    prev_x: torch.Tensor
    branch: torch.Tensor


class HystereticLogisticParams(NamedTuple):
    a: torch.Tensor    # (in, K) slope
    b: torch.Tensor    # (in, K) centre
    ec: torch.Tensor   # (in, K) half branch-separation (coercive shift)


def hysteretic_logistic_init(generator: torch.Generator, in_features: int,
                             num_basis: int, *, device=None,
                             dtype=torch.float32) -> HystereticLogisticParams:
    """``a`` ~ U[0.5, 2.5], ``b`` ~ 0.5 N(0, 1), ``ec`` ~ U[0.1, 1.0]."""
    shape = (in_features, num_basis)
    kw = dict(device=device, dtype=dtype)
    return HystereticLogisticParams(
        a=uniform(generator, shape, 0.5, 2.5, **kw),
        b=normal(generator, shape, **kw) * 0.5,
        ec=uniform(generator, shape, 0.1, 1.0, **kw))


def hysteretic_logistic_state(batch_shape, in_features: int, num_basis: int,
                              *, device=None, dtype=torch.float32
                              ) -> HystereticLogisticState:
    """Fresh state: zero input history, every basis on the up branch."""
    return HystereticLogisticState(
        prev_x=torch.zeros((*batch_shape, in_features), device=device,
                           dtype=dtype),
        branch=torch.ones((*batch_shape, in_features, num_basis),
                          device=device, dtype=dtype))


def hysteretic_logistic_basis(params: HystereticLogisticParams,
                              state: HystereticLogisticState, x: torch.Tensor,
                              *, gate_slope: float = 10.0,
                              hard_gate: bool = False):
    """Two-branch logistic basis with direction-dependent branch selection.

    The up branch is the logistic shifted left by ``ec``, the down branch
    shifted right; a gate driven by the sign of ``dx = x - prev_x``
    selects the branch, and where the drive is stationary (dx ~ 0) the
    previous branch persists.  The gate is smooth unless ``hard_gate``
    (the reference's, which passes no gradient).

    Returns ``(phi, new_state)`` with ``phi: (..., in, K)``; the state
    carries no gradient.
    """
    xe = x[..., None]                                        # (..., in, 1)
    dx = x - state.prev_x.detach()                           # (..., in)
    raw = torch.sigmoid(gate_slope * dx)[..., None]          # (..., in, 1)
    # persistence weight: 1 at dx = 0 (keep the previous branch), -> 0 for
    # a decisive sweep in either direction
    persist = 4.0 * raw * (1.0 - raw)
    branch_prev = state.branch.detach()                      # (..., in, K)
    gate = (1.0 - persist) * raw + persist * branch_prev
    if hard_gate:
        gate = (gate > 0.5).to(x.dtype).detach()

    up = 2.0 * torch.sigmoid(params.a * (xe - params.b + params.ec))
    down = 2.0 * torch.sigmoid(params.a * (xe - params.b - params.ec))
    phi = gate * up + (1.0 - gate) * down

    new_state = HystereticLogisticState(
        prev_x=x.detach().to(state.prev_x.dtype),
        branch=gate.detach().expand(phi.shape).to(state.branch.dtype))
    return phi, new_state
