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


def clip_by_global_norm_(grads, max_norm: float,
                         sq_norm: torch.Tensor | None = None) -> torch.Tensor:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``
    (optax's formula); returns the norm before clipping.  ``sq_norm``: the
    squared norm when the caller computes it (across ranks)."""
    if sq_norm is None:
        sq_norm = sum(g.square().sum() for g in grads)
    norm = torch.sqrt(sq_norm)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class Optimizer:
    """Adam or AdamW over ``params`` with an optional global-norm clip
    first and a learning rate that is a float or a schedule of the step
    count.  ``params`` may be a mesh ``Placement``
    (``parallel.shard_params``): the optimiser then steps its
    ``parameters()`` (a model-sharded leaf's block), the clip takes the
    norm across the model group, a checkpoint holds the whole state, and
    ``self.placement`` is the one the train step syncs through
    (``train/loop.py: make_train_step``)."""

    def __init__(self, params, lr: Union[float, Schedule],
                 grad_clip: float | None = None, kind: str = "adam",
                 weight_decay: float = 0.0):
        self.placement = None
        if hasattr(params, "sq_norm"):
            self.placement, params = params, params.parameters()
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
        optimiser's moments, for a checkpoint; on a placement with
        model-sharded blocks their moments gathered whole (a collective:
        every rank calls it)."""
        inner = self.inner.state_dict()
        if self.placement is not None:
            inner = self.placement.whole_state(inner, self.params)
        return {"count": self.count, "inner": inner}

    def load_state_dict(self, sd: dict) -> None:
        """Load ``state_dict``'s payload; on a placement the blocks and
        their moments are cut anew from the loaded module and state."""
        self.count = int(sd["count"])
        inner = sd["inner"]
        if self.placement is not None:
            inner = self.placement.own_state(inner, self.params)
            self.placement.scatter()
        self.inner.load_state_dict(inner)

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
            sq = (self.placement.sq_norm(grads, self.params)
                  if self.placement is not None else None)
            clip_by_global_norm_(grads, self.grad_clip, sq)
        for group in self.inner.param_groups:
            group["lr"] = self.lr(self.count)
        self.inner.step()
        self.count += 1


def make_optimizer(lr: Union[float, Schedule], *, params, kind: str = "adam",
                   weight_decay: float = 0.0,
                   grad_clip: float | None = None) -> Optimizer:
    """``lr`` may be a float or a schedule (e.g. ``cosine_decay_schedule``);
    ``kind`` is "adam" or "adamw" (with ``weight_decay``); ``params`` the
    tensors to step or a mesh ``Placement``."""
    return Optimizer(params, lr, grad_clip, kind, weight_decay)
