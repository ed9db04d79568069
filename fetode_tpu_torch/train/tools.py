"""Training utilities (counterpart of ``fetode_tpu/train/tools.py``):
early stopping, learning-rate schedules and an attribute dict.

The schedules are step -> learning-rate callables with optax's values
(the JAX package builds them on optax).  With an optimiser whose ``lr``
is 1.0, ``torch.optim.lr_scheduler.LambdaLR(opt, schedule)`` sets each
step's rate to ``schedule(step)``.
"""

from __future__ import annotations

import math

import numpy as np


class EarlyStopping:
    """Stop when the validation metric has not improved for ``patience``
    epochs; tracks the best value."""

    def __init__(self, patience: int = 7, min_delta: float = 0.0,
                 mode: str = "min"):
        self.patience = patience
        self.min_delta = min_delta
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = np.inf
        self.counter = 0
        self.should_stop = False

    def step(self, metric: float) -> bool:
        """Returns True if this metric is a new best."""
        value = self.sign * float(metric)
        if value < self.best - self.min_delta:
            self.best = value
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.should_stop = True
        return False


def exponential_decay_schedule(lr: float, decay: float = 0.5,
                               every: int = 1):
    """The reference's ``adjust_learning_rate`` type1 policy (lr *
    0.5^epoch) over epoch indices."""
    return lambda epoch: lr * (decay ** (epoch // every))


def cosine_schedule(lr: float, total_steps: int, min_scale: float = 0.0):
    """CosineAnnealingLR's curve, ``optax.cosine_decay_schedule(lr,
    total_steps, alpha=min_scale)``: ``lr * ((1 - min_scale) * 0.5 * (1 +
    cos(pi * min(step, total_steps) / total_steps)) + min_scale)``."""
    if total_steps <= 0:
        raise ValueError(f"cosine_schedule: total_steps must be positive, "
                         f"got {total_steps}")

    def schedule(step):
        frac = min(step, total_steps) / total_steps
        return lr * ((1.0 - min_scale) * 0.5 * (1.0 + math.cos(math.pi * frac))
                     + min_scale)
    return schedule


class dotdict(dict):
    """Attribute-style dict (the reference kit's ``dotdict``)."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__
