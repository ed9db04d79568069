"""The optimiser (counterpart of ``fetode_tpu/train/optim.py``).

The JAX package builds ``optax.chain(clip_by_global_norm(grad_clip),
core)`` with ``core`` one of ``adam(lr)``, ``adamw(lr, weight_decay)``
and ``sgd(lr)``; the port has the first two.  ``lr`` is a float or a
schedule such as ``optax.cosine_decay_schedule(lr, epochs, alpha=0.05)``
(``train/predprey_driver.py:288-294``), and masks the knot grids out by
their ``_buffers`` key.  Here the grids are module buffers, so only the
parameters reach the optimiser and there is nothing to mask.

``Optimizer.step`` reproduces optax's arithmetic: the clip scales the
gradients by ``max / norm`` only when ``norm >= max`` (optax's
``(g / norm) * max``, not ``clip_grad_norm_``'s ``max / (norm + 1e-6)``),
computed on the device without a host sync; Adam is ``torch.optim.Adam``
(b1 0.9, b2 0.999, eps 1e-8), whose update equals optax's
``scale_by_adam``; AdamW is ``torch.optim.AdamW``, whose step ``p * (1 -
lr * wd) - lr * adam(g)`` is optax's ``adamw`` update ``-lr * (adam(g) +
wd * p)``.  The schedule is read at the count before the step, as optax's
``scale_by_schedule`` reads it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Union

import torch

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``: ``init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``
    (optax's formula); returns the norm before clipping."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class Optimizer:
    """Adam or AdamW over ``params`` with an optional global-norm clip
    first and a learning rate that is a float or a schedule of the step
    count."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Schedule], grad_clip: float | None = None,
                 kind: str = "adam", weight_decay: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.grad_clip = grad_clip
        self.count = 0
        adam = dict(lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8)
        if kind == "adam":
            self.inner = torch.optim.Adam(self.params, **adam)
        elif kind == "adamw":
            self.inner = torch.optim.AdamW(self.params, **adam,
                                           weight_decay=weight_decay)
        else:
            raise ValueError(f"unknown optimiser {kind!r}")

    def state_dict(self) -> dict:
        """The step count (the schedule's position) and the inner
        optimiser's moments, for a checkpoint."""
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.inner.load_state_dict(sd["inner"])

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        # A parameter the loss did not reach steps with a zero gradient, as
        # optax updates every leaf (AdamW still decays it); torch's
        # optimisers would skip it.
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.grad_clip is not None and grads:
            clip_by_global_norm_(grads, self.grad_clip)
        for group in self.inner.param_groups:
            group["lr"] = self.lr(self.count)
        self.inner.step()
        self.count += 1


def make_optimizer(lr: Union[float, Schedule], *,
                   params: Iterable[torch.Tensor], kind: str = "adam",
                   weight_decay: float = 0.0,
                   grad_clip: float | None = None) -> Optimizer:
    """``lr`` may be a float or a schedule (e.g. ``cosine_decay_schedule``);
    ``kind`` is "adam" or "adamw" (with ``weight_decay``)."""
    return Optimizer(params, lr, grad_clip, kind, weight_decay)
