"""Logistic basis functions (counterpart of ``fetode_tpu/ops/logistic.py``).

Ported: the plain basis, which ``nn/kan.py: kan_linear_apply`` uses (it
is off in KANFET stacks) and the ECG models' feature mixer is built on
(``models/ecg.py``), and ``logistic_init``.  The hysteretic two-branch
variant is not ported (ROADMAP A.11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fetode_tpu_torch.utils.init import normal


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
