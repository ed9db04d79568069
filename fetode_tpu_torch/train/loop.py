"""The training step and the loop over steps (counterpart of
``fetode_tpu/train/loop.py``).

The JAX package jits one step and scans ``n_epochs_per_call`` of them in
one dispatch.  PyTorch runs eagerly, so here a call is a plain loop over
that many steps.  The state is updated in place (the parameters and the
optimiser's moments) and returned, so call sites read as in the JAX
package: ``state, losses = scanner(state, *batch)``.  The losses stay on
the device until the caller reads them.  The minibatch and population
scanners come with the ECG slice (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch import nn

from fetode_tpu_torch.train.optim import Optimizer


class TrainState(NamedTuple):
    params: nn.Module
    opt: Optimizer

    @property
    def step(self) -> int:
        return self.opt.count


def init_state(params: nn.Module, opt: Optimizer) -> TrainState:
    return TrainState(params=params, opt=opt)


def make_train_step(loss_fn: Callable) -> Callable:
    """``loss_fn(params, *batch) -> scalar``.  Returns ``step(state,
    *batch) -> (state, loss)``: one gradient step in place."""
    def step(state: TrainState, *batch) -> Tuple[TrainState, torch.Tensor]:
        state.opt.zero_grad()
        loss = loss_fn(state.params, *batch)
        loss.backward()
        state.opt.step()
        return state, loss.detach()

    return step


def make_epoch_scanner(loss_fn: Callable, n_epochs_per_call: int) -> Callable:
    """``fn(state, *batch) -> (state, losses[n])``: ``n_epochs_per_call``
    full-batch steps; ``losses[i]`` is the loss before step i's update."""
    step = make_train_step(loss_fn)

    def run(state: TrainState, *batch):
        losses = []
        for _ in range(n_epochs_per_call):
            state, loss = step(state, *batch)
            losses.append(loss)
        return state, torch.stack(losses)

    return run
