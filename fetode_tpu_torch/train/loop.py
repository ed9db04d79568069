"""The training step and the loop over steps (counterpart of
``fetode_tpu/train/loop.py``).

The JAX package jits one step and scans ``n_epochs_per_call`` of them in
one dispatch.  PyTorch runs eagerly, so here a call is a plain loop over
that many steps.  The state is updated in place (the parameters and the
optimiser's moments) and returned, so call sites read as in the JAX
package: ``state, losses = scanner(state, *batch)``.  The losses stay on
the device until the caller reads them.

The minibatch epoch and the block-of-epochs scanner are plain loops too.
Their keyed form replaces the JAX package's split PRNG keys: the loss
takes a ``torch.Generator`` (``loss_fn(params, generator, *batch)``),
and every step gets a fresh one, seeded from (seed, epoch, step) by
``step_generator``, so one epoch draws the same numbers whether it runs
alone or inside a block.

The population scanner trains P independent members (the noise study,
``train/ecg_driver.py: train_ecg_population``) in one loop: each member
has its own parameters, optimiser state and global-norm clip, and its
own step generators, seeded from (member seed, epoch, step) as a single
run's; one loss call computes every member's loss, so the members' latent
solves can share one kernel launch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
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
    *batch) -> (state, loss)``: one gradient step in place.

    On a mesh (the optimiser built on a ``parallel.Placement``) the
    placement's ``backward`` runs the backward: with the rows sharded
    over the ranks each rank backpropagates its share of the global mean
    and the gradients are summed over the ranks before the clip and the
    step; a model-sharded leaf steps its block, and the module's full
    tensors are gathered after the step.  The loss returned is the
    global one."""
    def step(state: TrainState, *batch) -> Tuple[TrainState, torch.Tensor]:
        place = getattr(state.opt, "placement", None)
        state.opt.zero_grad()
        loss = loss_fn(state.params, *batch)
        if place is None:
            loss.backward()
        else:
            loss = place.backward(loss)
        state.opt.step()
        if place is not None:
            place.gather()
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


def derived_seed(*words: int) -> int:
    """A 63-bit seed from a few integers, through numpy's
    ``SeedSequence``."""
    state = np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0]
    return int(state >> 1)


def step_generator(seed: int, epoch: int, step: int,
                   device: torch.device) -> torch.Generator:
    """A fresh generator on ``device`` for one training step, seeded from
    (seed, epoch, step)."""
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, epoch, step))


def make_minibatch_epoch(loss_fn: Callable, *, keyed: bool = False
                         ) -> Callable:
    """One epoch over pre-batched minibatches: ``fn(state, batches) ->
    (state, losses[n_batches])``, every tensor of ``batches`` with leading
    axes (n_batches, batch_size, ...).

    With ``keyed=True`` the loss is ``loss_fn(params, generator, *batch)``
    and the epoch function ``fn(state, key, batches)`` with ``key = (seed,
    epoch)``: step i draws from ``step_generator(seed, epoch, i)``.
    """
    step = make_train_step(loss_fn)

    def run(state: TrainState, batches: Sequence[torch.Tensor], key=None):
        losses = []
        for i in range(batches[0].shape[0]):
            batch = [b[i] for b in batches]
            if key is not None:
                batch.insert(0, step_generator(*key, i, batches[0].device))
            state, loss = step(state, *batch)
            losses.append(loss)
        return state, torch.stack(losses)

    if not keyed:
        return run
    return lambda state, key, batches: run(state, batches, key)


def make_minibatch_epochs_scanner(loss_fn: Callable, *, keyed: bool = False
                                  ) -> Callable:
    """A block of epochs in one call: every tensor of ``epoch_batches``
    has leading axes (n_epochs, n_batches, batch_size, ...).  Returns
    ``fn(state, epoch_batches) -> (state, losses[n_epochs, n_batches])``;
    keyed, ``fn(state, (seed, epoch0), epoch_batches)``, where epoch e of
    the block draws as epoch ``epoch0 + e`` of ``make_minibatch_epoch``.
    """
    epoch_fn = make_minibatch_epoch(loss_fn)

    def run(state: TrainState, epoch_batches: Sequence[torch.Tensor],
            key=None):
        losses = []
        for e in range(epoch_batches[0].shape[0]):
            batches = [b[e] for b in epoch_batches]
            ekey = None if key is None else (key[0], key[1] + e)
            state, loss = epoch_fn(state, batches, ekey)
            losses.append(loss)
        return state, torch.stack(losses)

    if not keyed:
        return run
    return lambda state, key, epoch_batches: run(state, epoch_batches, key)


class PopulationState(NamedTuple):
    """P members' training states, each its own parameters and optimiser
    (with its own clip)."""

    members: Tuple[TrainState, ...]

    @property
    def params(self):
        return [m.params for m in self.members]


def make_population_epochs_scanner(loss_fn: Callable) -> Callable:
    """Population training: P independent runs in one call (counterpart of
    ``fetode_tpu/train/loop.py: make_population_epochs_scanner``, the
    ``vmap`` written out as a member axis).

    ``loss_fn(params, generators, extras, *batch) -> losses (P,)``: member
    m's loss from its own parameters ``params[m]``, its generator
    ``generators[m]`` and config ``extras[m]`` (e.g. a device-noise std)
    and its minibatch ``batch[...][m]``.  Returns ``fn(states, keys,
    extras, epoch_batches) -> (states, losses[P, n_epochs, n_batches])``:
    ``keys[m] = (seed, epoch0)`` of member m, every tensor of
    ``epoch_batches`` with leading axes (P, n_epochs, n_batches, B, ...).
    A step sums the members' losses, so one backward gives each member
    the gradient of its own loss, then steps each member's optimiser,
    whose global-norm clip sees that member's gradients alone.  Member m
    draws at epoch ``epoch0 + e``, step i, from ``step_generator(seed,
    epoch0 + e, i)``: its curve is ``make_minibatch_epochs_scanner``'s
    (keyed) for that member alone.
    """
    def step(states: PopulationState, gens, extras, *batch):
        for s in states.members:
            s.opt.zero_grad()
        losses = loss_fn(states.params, gens, extras, *batch)
        losses.sum().backward()
        for s in states.members:
            s.opt.step()
        return states, losses.detach()

    def run(states: PopulationState, keys, extras,
            epoch_batches: Sequence[torch.Tensor]):
        n_epochs, n_batches = epoch_batches[0].shape[1:3]
        device = epoch_batches[0].device
        losses = []
        for e in range(n_epochs):
            for i in range(n_batches):
                gens = [step_generator(seed, ep0 + e, i, device)
                        for seed, ep0 in keys]
                states, loss = step(states, gens, extras,
                                    *(b[:, e, i] for b in epoch_batches))
                losses.append(loss)
        return states, torch.stack(losses, 1).reshape(-1, n_epochs,
                                                      n_batches)

    return run
