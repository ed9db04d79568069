"""Logistic basis functions (counterpart of ``fetode_tpu/ops/logistic.py``).

Only the plain basis that ``nn/kan.py: kan_linear_apply`` uses is ported
(the layer initialises its parameters); it is off in KANFET stacks.  The
hysteretic two-branch variant arrives with the ECG slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LogisticParams(NamedTuple):
    """Per-feature logistic basis parameters, each ``(in_features, num_basis)``."""

    a: torch.Tensor  # slope
    b: torch.Tensor  # centre


def logistic_basis(params: LogisticParams, x: torch.Tensor) -> torch.Tensor:
    """``2 * sigmoid(a * (x - b))`` per feature and basis function.

    Args:
      x: (..., in_features)
    Returns:
      (..., in_features, num_basis)
    """
    return 2.0 * torch.sigmoid(params.a * (x[..., None] - params.b))
