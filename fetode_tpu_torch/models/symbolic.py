"""Symbolic-regression demo: a 2-layer ferroelectric KAN fit to a
closed-form target.

Counterpart of ``fetode_tpu/models/symbolic.py`` (the reference's
``smooth_test_KAN_ferro.py:125-160``): a small net whose every edge is a
hysteretic basis (``ops/ferro.py``), trained on ``y = sin(x) + 0.1 x^2``
with an L1 pruning penalty on the mixing coefficients and the hysteresis
state fresh at every call (the reference's per-epoch ``reset_state``).
Training is full-batch Adam through ``train/loop.py: make_epoch_scanner``.
Its two ferro layers are ``ops/ferro_fused.py: ferro_apply_fused``: the
CUDA kernel on the card, the plain ``ferro_apply`` on the CPU.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from fetode_tpu_torch.ops.ferro import (
    FerroConfig,
    ferro_init,
    ferro_state_init,
)
from fetode_tpu_torch.ops.ferro_fused import ferro_apply_fused


class SymbolicNetSpec(NamedTuple):
    in_dim: int = 1
    hidden: int = 8
    out_dim: int = 1
    num_basis: int = 6
    l1_coef: float = 1e-3

    @property
    def l1_cfg(self) -> FerroConfig:
        return FerroConfig(self.in_dim, self.hidden, self.num_basis)

    @property
    def l2_cfg(self) -> FerroConfig:
        return FerroConfig(self.hidden, self.out_dim, self.num_basis)


class SymbolicNet(nn.Module):
    """The two ferro layers, ``l1`` and ``l2`` (the JAX package's param
    dict keys)."""

    def __init__(self, l1: nn.Module, l2: nn.Module):
        super().__init__()
        self.l1 = l1
        self.l2 = l2


def symbolic_net_init(generator: torch.Generator, spec: SymbolicNetSpec, *,
                      device=None, dtype=torch.float32) -> SymbolicNet:
    kw = dict(device=device, dtype=dtype, coef_scale=0.3)
    return SymbolicNet(ferro_init(generator, spec.l1_cfg, **kw),
                       ferro_init(generator, spec.l2_cfg, **kw))


def symbolic_net_apply(params: SymbolicNet, spec: SymbolicNetSpec,
                       x: torch.Tensor, state=None):
    """x (B, in_dim) -> ``((B, out_dim), (state1, state2))``; a fresh
    hysteresis state unless ``state`` is given."""
    B = x.shape[0]
    if state is None:
        kw = dict(device=x.device, dtype=x.dtype)
        state = (ferro_state_init((B,), spec.l1_cfg, **kw),
                 ferro_state_init((B,), spec.l2_cfg, **kw))
    h, s1 = ferro_apply_fused(params.l1, state[0], x, spec.l1_cfg)
    y, s2 = ferro_apply_fused(params.l2, state[1], torch.tanh(h),
                              spec.l2_cfg)
    return y, (s1, s2)


def target_fn(x: torch.Tensor) -> torch.Tensor:
    """The reference's regression target (smooth_test_KAN_ferro.py:125-130)."""
    return torch.sin(x) + 0.1 * x ** 2


def pruning_l1(params: SymbolicNet) -> torch.Tensor:
    """L1 penalty on the mixing coefficients (the coef-pruning regulariser)."""
    return params.l1.coef.abs().mean() + params.l2.coef.abs().mean()


def train_symbolic(spec: SymbolicNetSpec = SymbolicNetSpec(),
                   epochs: int = 300, lr: float = 5e-3, n_points: int = 128,
                   seed: int = 0, log=None, *, device="cuda",
                   init_params: SymbolicNet | None = None):
    """Fit the net on ``n_points`` in [-3, 3]; returns ``(params, losses)``,
    ``losses[i]`` the loss before step i's update.  ``init_params`` starts
    from given parameters (a copy) instead of an init from ``seed``.  Runs
    on the card unless ``device="cpu"``; ``cuda`` without a card raises."""
    from fetode_tpu_torch.train.loop import init_state, make_epoch_scanner
    from fetode_tpu_torch.train.optim import make_optimizer
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    x = torch.linspace(-3.0, 3.0, n_points, device=device)[:, None]
    y = target_fn(x)
    params = (copy.deepcopy(init_params).to(device) if init_params is not None
              else symbolic_net_init(torch.Generator().manual_seed(seed),
                                     spec, device=device))
    if epochs == 0:
        return params, np.zeros(0, np.float32)
    state = init_state(params, make_optimizer(lr, params=params.parameters(),
                                              kind="adam"))

    def loss_fn(p, x_, y_):
        pred, _ = symbolic_net_apply(p, spec, x_)
        return torch.mean((pred - y_) ** 2) + spec.l1_coef * pruning_l1(p)

    state, losses = make_epoch_scanner(loss_fn, epochs)(state, x, y)
    losses = losses.cpu().numpy()
    if log is not None:
        log(f"symbolic regression: loss {float(losses[0]):.4f} -> "
            f"{float(losses[-1]):.4f}")
    return state.params, losses
