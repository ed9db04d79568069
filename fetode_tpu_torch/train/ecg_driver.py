"""ECG200 trainer (counterpart of ``fetode_tpu/train/ecg_driver.py:
train_ecg_model``).

AdamW (lr 1e-3, weight decay 1e-4), global-norm clip 1.0, cross-entropy,
minibatches of 8 reshuffled every epoch (seed ``run.seed + epoch``),
train and test accuracy after every block of epochs, and the parameters
of the best test accuracy kept.  Device noise is fresh per training
step: the model's ``apply_fn(params, x, generator)`` gets a generator
seeded from (run seed, epoch, step) (``train/loop.py: step_generator``).
Evaluation averages logits over ``eval_noise_draws`` generators that are
seeded the same way at every evaluation (the fixed eval draws); a
noiseless model ignores them.  ``eval_chunk`` evaluates in chunks of
that many rows, padding the last with the last row, in every solver
mode alike.

Not ported yet, each raising an error that names its ROADMAP item:
the mesh (``mesh_devices``, ``mesh_model``), checkpoint/resume
(``ckpt_dir``, ``ckpt_every``, ``resume``), the AOT cache
(``aot_cache``, ``aot_tag``), and the population trainer and noise
study.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from fetode_tpu_torch.data.ecg200 import batch_iterator
from fetode_tpu_torch.train.loop import (
    derived_seed,
    init_state,
    make_minibatch_epoch,
    make_minibatch_epochs_scanner,
)
from fetode_tpu_torch.train.optim import make_optimizer
from fetode_tpu_torch.utils.device import resolve_device

_NOT_PORTED = {
    "mesh_devices": "ROADMAP A.11 (multi-device)",
    "mesh_model": "ROADMAP A.11 (multi-device)",
    "ckpt_dir": "ROADMAP A.5 (checkpoint/resume)",
    "ckpt_every": "ROADMAP A.5 (checkpoint/resume)",
    "resume": "ROADMAP A.5 (checkpoint/resume)",
    "aot_cache": "ROADMAP A.5 (aot_cache)",
    "aot_tag": "ROADMAP A.5 (aot_cache)",
}

# Streams of the seeds derived from run.seed: step noise, eval draws.
_NOISE, _EVAL = 1, 2


@dataclass
class ECGRun:
    epochs: int = 100
    batch_size: int = 8
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    eval_noise_draws: int = 1   # logits averaged over this many draws
    # >0: evaluate accuracy in chunks of this many rows; 0 = the whole
    # split in one call.
    eval_chunk: int = 0
    # Epochs per call of the block scanner; eval and best-tracking happen
    # once per block.
    epochs_per_call: int = 1
    # Not ported (see _NOT_PORTED).
    mesh_devices: int = 0
    mesh_model: int = 1
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    aot_cache: str = ""
    aot_tag: str = ""
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


def _check_ported(run: ECGRun) -> None:
    for f in dataclasses.fields(run):
        if f.name in _NOT_PORTED and getattr(run, f.name) != f.default:
            raise NotImplementedError(
                f"ECGRun.{f.name}={getattr(run, f.name)!r} is not ported "
                f"yet: {_NOT_PORTED[f.name]}")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def _chunked_logits(apply_i: Callable, x: torch.Tensor, n_draws: int,
                    chunk: int) -> torch.Tensor:
    """Logits of ``x`` averaged over ``n_draws`` draws (``apply_i(xc, i)``),
    in ``chunk``-row pieces when ``chunk`` > 0 (the last padded with the
    last row)."""
    def logits_of(xc):
        return torch.stack([apply_i(xc, i) for i in range(n_draws)]).mean(0)

    n = x.shape[0]
    if not chunk or n <= chunk:
        return logits_of(x)
    pad = (-n) % chunk
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return torch.cat([logits_of(xc) for xc in x.split(chunk)])[:n]


def train_ecg_model(init_fn: Callable, apply_fn: Callable, data,
                    run: ECGRun = ECGRun(), log=print):
    """Generic ECG trainer.

    ``init_fn(generator) -> params`` (an ``nn.Module`` on the run's
    device); ``apply_fn(params, x, generator) -> logits``, the generator
    consumed for device noise by a noisy model and ignored otherwise.
    ``data = (x_train, y_train, x_test, y_test)`` numpy arrays.  Returns
    (best params, history) with the history keys of the JAX package:
    ``loss``, ``train_acc``, ``test_acc``, ``wall_seconds``,
    ``best_test_acc``.
    """
    _check_ported(run)
    device = resolve_device(run.device)
    x_train, y_train, x_test, y_test = data
    params = init_fn(torch.Generator().manual_seed(run.seed))
    opt = make_optimizer(run.lr, params=params.parameters(), kind="adamw",
                         weight_decay=run.weight_decay,
                         grad_clip=run.grad_clip)
    state = init_state(params, opt)
    noise_seed = derived_seed(run.seed, _NOISE)
    eval_seeds = [derived_seed(run.seed, _EVAL, i)
                  for i in range(max(1, run.eval_noise_draws))]

    def loss_fn(p, generator, xb, yb):
        return cross_entropy(apply_fn(p, xb, generator), yb)

    epoch_fn = make_minibatch_epoch(loss_fn, keyed=True)
    block_fn = make_minibatch_epochs_scanner(loss_fn, keyed=True)

    def tensors(x, y):
        return (torch.as_tensor(x, dtype=torch.float32, device=device),
                torch.as_tensor(y, dtype=torch.long, device=device))

    @torch.no_grad()
    def eval_acc(p, x, y):
        def apply_i(xc, i):
            g = torch.Generator(device=device).manual_seed(eval_seeds[i])
            return apply_fn(p, xc, g)
        return float(accuracy(_chunked_logits(apply_i, x, len(eval_seeds),
                                              run.eval_chunk), y))

    train_split, test_split = tensors(x_train, y_train), tensors(x_test,
                                                                 y_test)
    history = {"loss": [], "train_acc": [], "test_acc": []}
    best = (-1.0, copy.deepcopy(state.params))
    t0 = time.perf_counter()
    E = max(1, run.epochs_per_call)
    for ep in range(0, run.epochs, E):
        n = min(E, run.epochs - ep)
        shuffles = [batch_iterator(x_train, y_train, run.batch_size,
                                   seed=run.seed + ep + i) for i in range(n)]
        if n == 1:
            state, losses = epoch_fn(state, (noise_seed, ep),
                                     tensors(*shuffles[0]))
        else:
            state, losses = block_fn(state, (noise_seed, ep), tensors(
                np.stack([s[0] for s in shuffles]),
                np.stack([s[1] for s in shuffles])))
        tr_acc = eval_acc(state.params, *train_split)
        te_acc = eval_acc(state.params, *test_split)
        history["loss"].append(float(losses.mean()))
        history["train_acc"].append(tr_acc)
        history["test_acc"].append(te_acc)
        if te_acc > best[0]:
            best = (te_acc, copy.deepcopy(state.params))
        # Log whenever the block [ep, ep+n) crossed a log_every boundary,
        # labelled with the last epoch the metrics were evaluated after.
        if log is not None and (
                (ep + n - 1) // run.log_every > (ep - 1) // run.log_every
                or ep + n >= run.epochs):
            log(f"epoch {ep + n - 1:3d} | loss {history['loss'][-1]:.4f} | "
                f"train_acc {tr_acc*100:.1f}% | test_acc {te_acc*100:.1f}%")
    history["wall_seconds"] = time.perf_counter() - t0
    history["best_test_acc"] = best[0]
    return best[1], history
