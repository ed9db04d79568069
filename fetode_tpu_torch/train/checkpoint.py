"""Checkpoint / resume on ``torch.save`` (counterpart of
``fetode_tpu/train/checkpoint.py``, which writes orbax checkpoints).

* ``CheckpointManager`` — one file a step, ``<dir>/ckpt_<step>.pt``,
  written atomically: the payload goes to a temporary file in the same
  directory, which ``os.replace`` then renames, so a process killed
  during a save leaves the previous checkpoints as they were and no
  half-written file under a checkpoint's name.  At most ``max_to_keep``
  steps are kept (the oldest go); ``latest_step`` reads the directory.
  Files load with ``torch.load(weights_only=True)``, so a payload holds
  only tensors, dicts, lists and numbers: ``state_dict``s, the step, a
  best criterion, a budget stage, a ``torch.Generator``'s state.
* ``BestTracker`` — the best-metric in-memory snapshot (the reference's
  working pattern, ``train_kan_fet_ett.py:341-358``), host copies.
* ``DurableLoop`` — periodic save and exact resume for the epoch-style
  drivers.  Their per-epoch randomness is stateless (shuffles seeded
  ``run.seed + epoch``, step generators seeded from (seed, epoch, step),
  evaluation generators from (seed, stream, epoch)), so a payload of the
  train state (parameters with their knot-grid buffers, the optimiser's
  moments and step count, which places the schedule), the best snapshot
  and its criterion, and the epoch makes a resumed run continue the exact
  curve of an unbroken one.  A caller whose randomness does carry over
  passes its ``torch.Generator`` as ``key``: its state rides the payload.

The port reads no orbax checkpoint of the JAX package, and the JAX
package reads none of the port's.  Hysteresis states are built fresh for
every sequence and never checkpointed, as in the JAX package.
"""

from __future__ import annotations

import copy
import os
import re
import tempfile
from typing import Any, Optional

import torch
import torch.distributed as dist

from fetode_tpu_torch.parallel.mesh import is_rank0, world

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Save and restore payloads by step under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")

    def all_steps(self):
        """The steps with a complete checkpoint file, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> bool:
        """Write ``tree`` as step ``step`` (replacing a checkpoint of the
        same step), then drop the oldest past ``max_to_keep``."""
        fd, tmp = tempfile.mkstemp(prefix=f".ckpt_{int(step)}.",
                                   suffix=".tmp", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return True

    def restore(self, step: Optional[int] = None) -> Any:
        """The payload of ``step`` (default the latest), its tensors on the
        CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)


class BestTracker:
    """Best-metric snapshot of a module's ``state_dict``, host copies."""

    def __init__(self, mode: str = "min"):
        self.mode = mode
        self.best_metric = float("inf") if mode == "min" else -float("inf")
        self.best_tree = None

    def update(self, metric: float, module: torch.nn.Module) -> bool:
        better = (metric < self.best_metric if self.mode == "min"
                  else metric > self.best_metric)
        if better:
            self.best_metric = float(metric)
            self.best_tree = {k: v.detach().to("cpu", copy=True)
                              for k, v in module.state_dict().items()}
        return better

    def restore(self, like: Optional[torch.nn.Module] = None) -> Any:
        """The snapshot's ``state_dict``, or, given a module, a copy of it
        holding the snapshot."""
        if self.best_tree is None:
            raise ValueError("no snapshot recorded yet")
        if like is None:
            return self.best_tree
        out = copy.deepcopy(like)
        out.load_state_dict(self.best_tree)
        return out


def train_state_dict(state) -> dict:
    """A ``TrainState``'s parameters (buffers included) and optimiser."""
    return {"params": state.params.state_dict(),
            "opt": state.opt.state_dict()}


def load_train_state(state, sd: dict):
    """Load ``train_state_dict``'s payload into ``state`` in place (the
    optimiser keeps its ``Parameter`` objects); returns ``state``."""
    state.params.load_state_dict(sd["params"])
    state.opt.load_state_dict(sd["opt"])
    return state


class DurableLoop:
    """Periodic-save + exact-resume harness for epoch-style drivers.

    Usage::

        dl = DurableLoop(run.ckpt_dir, run.ckpt_every, run.resume)
        start_ep, saved = dl.restore(state=state, best_crit=np.inf,
                                     best_params=best[1])
        if saved is not None:
            state = saved["state"]
            best = (float(saved["best_crit"]), saved["best_params"])
        for ep in range(start_ep, run.epochs):
            ...
            dl.save(ep + 1, state=state, best_crit=best[0],
                    best_params=best[1], last=ep + 1 == run.epochs)

    ``restore`` loads into the ``state`` and ``best_params`` it is given
    (in place) and returns them in ``saved``; a ``key`` (a
    ``torch.Generator``) gets its saved state back.  Other numbers a
    driver carries (the predprey budget stage) ride ``save``'s keywords
    and come back in ``saved``.  On a mesh rank 0 alone writes (the
    payload is every rank's: a model-sharded optimiser's moments are
    gathered whole); every rank restores, after a barrier.
    """

    def __init__(self, ckpt_dir: str = "", ckpt_every: int = 0,
                 resume: bool = False, max_to_keep: int = 3):
        self.every = int(ckpt_every)
        self.resume = bool(resume)
        self.enabled = bool(ckpt_dir) and (self.every > 0 or self.resume)
        self.manager = (CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)
                        if self.enabled else None)

    def restore(self, *, state, best_crit, best_params, key=None):
        """(start_epoch, saved payload | None)."""
        if not (self.enabled and self.resume):
            return 0, None
        if world()[1] > 1:
            dist.barrier()      # rank 0's last save is on disk
        step = self.manager.latest_step()
        if step is None:
            return 0, None
        raw = self.manager.restore(step)
        load_train_state(state, raw["state"])
        best_params.load_state_dict(raw["best_params"])
        saved = dict(raw, state=state, best_crit=float(raw["best_crit"]),
                     best_params=best_params)
        if key is not None:
            key.set_state(raw["key"])
            saved["key"] = key
        return int(step), saved

    def save(self, epoch: int, *, state, best_crit, best_params, key=None,
             last: bool = False, **extra) -> bool:
        if self.manager is None or self.every <= 0:
            return False
        if epoch % self.every and not last:
            return False
        # every rank builds the payload: a model-sharded optimiser gathers
        # its moments (Optimizer.state_dict)
        payload = dict(extra, state=train_state_dict(state),
                       best_crit=float(best_crit),
                       best_params=best_params.state_dict())
        if key is not None:
            payload["key"] = key.get_state()
        return self.manager.save(epoch, payload) if is_rank0() else False


def resume_run(run, state, best, log):
    """A ``DurableLoop`` for a run's ``ckpt_dir`` / ``ckpt_every`` /
    ``resume`` and what to continue from: ``(loop, start epoch, state,
    best, saved payload | None)``, with ``best`` a (criterion, module)
    pair; logs the resume."""
    dl = DurableLoop(run.ckpt_dir, run.ckpt_every, run.resume)
    start, saved = dl.restore(state=state, best_crit=best[0],
                              best_params=best[1])
    if saved is not None:
        state = saved["state"]
        best = (saved["best_crit"], saved["best_params"])
        if log is not None:
            log(f"[ckpt] resumed at epoch {start} from {run.ckpt_dir}")
    return dl, start, state, best, saved


def aot_cache_note(aot_cache: str, log) -> None:
    """The drivers' ``aot_cache``: the JAX package stores compiled
    executables there; the port runs eagerly and its kernels are built
    once per source hash (``ops/_build.py``), so there is nothing to
    cache.  The flag is accepted and logged."""
    if aot_cache and log is not None:
        log(f"[aot] aot_cache={aot_cache!r} is a no-op in the PyTorch port: "
            "nothing is compiled per run")
