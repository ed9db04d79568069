"""Forecasting trainers: the point forecaster and the diffusion
forecasters (counterpart of ``fetode_tpu/train/forecast_driver.py``).

AdamW (lr 1e-3, weight decay 1e-4), global-norm clip 1.0, minibatches
reshuffled every epoch (seed ``run.seed + epoch``), the best validation
score's parameters kept, test MSE with them, and the de-standardised
forecast of the last test window.  The point forecaster trains on MSE;
the diffusion forecasters on the epsilon loss, each step's draws from a
generator seeded from (run seed, epoch, step) (``train/loop.py:
step_generator``), and are scored by the MSE of the mean of
``eval_samples`` samples.  Evaluation runs in chunks (512 windows for
the point forecaster, 256 for the diffusion ones; the tail chunk keeps
its own size), every chunk of one evaluation with the same generator
seed, as the JAX package gives every chunk the same key.  The latent
solve batches a whole chunk under one step controller, so the chunks are
cut as the JAX package cuts them.  On the card evaluation runs the
forward kernels (``ops/ode_dyn.py`` without records, ``ops/ddpm.py``).

Checkpoint/resume (``ckpt_dir``, ``ckpt_every``, ``resume``;
``train/checkpoint.py: DurableLoop``) saves the train state, the best
snapshot and its validation score every ``ckpt_every`` epochs and after
the last; a resumed run continues the exact curve of an unbroken one,
since every epoch's shuffle, step generators and validation draws are
seeded from the run seed and the epoch alone (the JAX package's
diffusion trainer carries a key chain in the payload instead).
``aot_cache`` is accepted and logged: the port compiles nothing per run.

``mesh_devices`` / ``mesh_model`` train over a mesh of that many ranks
(``parallel.place_params``): every rank computes the whole minibatch,
since the latent solve steps a batch under one controller (a per-rank
block would take other steps), and ``mesh_model`` > 1 shards the
weights' output features over 'model'.  The curves are the
single-device ones; rank 0 alone writes checkpoints.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from fetode_tpu_torch.data.timeseries import (
    make_windows,
    split_time_series,
    standardize_fit,
    window_batches,
)
from fetode_tpu_torch.models.forecasting import (
    DiffusionForecasterSpec,
    LatentODEForecasterSpec,
    diffusion_forecaster_init,
    diffusion_forecaster_loss,
    diffusion_forecaster_sample,
    latent_ode_forecast,
    latent_ode_forecaster_init,
)
from fetode_tpu_torch.nn.diffusion import make_schedule
from fetode_tpu_torch.train.checkpoint import aot_cache_note, resume_run
from fetode_tpu_torch.train.loop import (
    derived_seed,
    init_state,
    make_minibatch_epoch,
)
from fetode_tpu_torch.parallel import driver_mesh, place_params
from fetode_tpu_torch.train.optim import make_optimizer
from fetode_tpu_torch.utils.device import resolve_device

# Streams of the seeds derived from run.seed: step noise, validation,
# test and the final forecast's draws.
_NOISE, _EVAL, _TEST, _FINAL = 1, 2, 3, 4


@dataclass
class ForecastRun:
    context_len: int = 96
    pred_len: int = 8
    batch_size: int = 64
    epochs: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    train_frac: float = 0.7
    val_frac: float = 0.1
    seed: int = 0
    log_every: int = 10
    eval_samples: int = 10   # diffusion eval averaging
    # >0: train over a ('data', 'model') mesh of this many ranks, the
    # whole minibatch on every rank (the latent solves step the batch under
    # one controller); mesh_model > 1 shards the weights' output features
    # over 'model' (parallel.place_params).
    mesh_devices: int = 0
    mesh_model: int = 1
    # Durable checkpoint/resume (train/checkpoint.py: DurableLoop).
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    # Accepted and logged: the port has no compiled program to cache.
    aot_cache: str = ""
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


def _chunked_mean(sum_fn: Callable, p, x, y, chunk: int = 512) -> float:
    """``sum_fn(p, x, y) -> (sum, count)`` over chunks of ``chunk`` rows
    (the tail chunk keeps its own size) -> the mean."""
    total, count = 0.0, 0
    for i in range(0, len(x), chunk):
        s, c = sum_fn(p, x[i:i + chunk], y[i:i + chunk])
        total += float(s)
        count += int(c)
    return total / count


def prepare_windows(X: np.ndarray, y: np.ndarray, run: ForecastRun):
    """Chronological split, train-only standardisation, dense windows."""
    tr, va, te = split_time_series(len(X), run.train_frac, run.val_frac)
    sx = standardize_fit(X[tr])
    sy = standardize_fit(y[tr][:, None])
    Xs, ys = sx.apply(X), sy.apply(y[:, None])[:, 0]
    out = {}
    for name, sl in (("train", tr), ("val", va), ("test", te)):
        out[name] = make_windows(Xs[sl], ys[sl], run.context_len,
                                 run.pred_len)
    return out, sx, sy


def _setup(run: ForecastRun, X, y, log):
    """The device, the windows as device tensors, the target scaler."""
    aot_cache_note(run.aot_cache, log)
    device = resolve_device(run.device)
    windows, _, sy = prepare_windows(X, y, run)
    tensors = {k: tuple(torch.as_tensor(a, dtype=torch.float32,
                                        device=device) for a in v)
               for k, v in windows.items()}
    return device, windows, tensors, sy


def _optimizer(params, run: ForecastRun, mesh):
    placed = place_params(params, mesh)
    return make_optimizer(run.lr, params=placed, kind="adamw",
                          weight_decay=run.weight_decay,
                          grad_clip=run.grad_clip)


def _epoch_batches(windows, run: ForecastRun, ep: int, device):
    bx, by = window_batches(*windows["train"], run.batch_size,
                            seed=run.seed + ep)
    return (torch.as_tensor(bx, device=device),
            torch.as_tensor(by, device=device))


def train_point_forecaster(spec: LatentODEForecasterSpec, X, y,
                           run: ForecastRun = ForecastRun(), log=print):
    """MSE point-forecast trainer.  Returns (best params, history with
    ``train``, ``val``, ``wall_seconds``, ``test_mse``,
    ``final_forecast``)."""
    mesh = driver_mesh(run.mesh_devices, run.mesh_model)
    device, windows, data, sy = _setup(run, X, y, log)
    params = latent_ode_forecaster_init(
        torch.Generator().manual_seed(run.seed), spec, device=device)
    state = init_state(params, _optimizer(params, run, mesh))

    def loss_fn(p, xb, yb):
        return torch.mean((latent_ode_forecast(p, spec, xb) - yb) ** 2)

    epoch_fn = make_minibatch_epoch(loss_fn)

    @torch.no_grad()
    def eval_mse(p, x, yt):
        return _chunked_mean(lambda q, xs, ys: (torch.sum(
            (latent_ode_forecast(q, spec, xs) - ys) ** 2), ys.numel()),
            p, x, yt, chunk=512)

    best = (np.inf, copy.deepcopy(state.params))
    dl, start_ep, state, best, _ = resume_run(run, state, best, log)
    history = {"train": [], "val": []}
    t0 = time.perf_counter()
    for ep in range(start_ep, run.epochs):
        state, losses = epoch_fn(state, _epoch_batches(windows, run, ep,
                                                       device))
        vl = eval_mse(state.params, *data["val"])
        history["train"].append(float(losses.mean()))
        history["val"].append(vl)
        if vl < best[0]:
            best = (vl, copy.deepcopy(state.params))
        dl.save(ep + 1, state=state, best_crit=best[0], best_params=best[1],
                last=ep + 1 == run.epochs)
        if log is not None and (ep % run.log_every == 0
                                or ep == run.epochs - 1):
            log(f"epoch {ep:3d} | train {history['train'][-1]:.5f} | "
                f"val {vl:.5f}")

    history["test_mse"] = eval_mse(best[1], *data["test"])
    history["wall_seconds"] = time.perf_counter() - t0
    if log is not None:
        log(f"best-val test MSE: {history['test_mse']:.5f}")
    with torch.no_grad():
        y_hat = latent_ode_forecast(best[1], spec, data["test"][0][-1:])
    history["final_forecast"] = sy.invert(
        y_hat[0].cpu().numpy()[:, None])[:, 0]
    return best[1], history


def train_diffusion_forecaster(spec: DiffusionForecasterSpec, X, y,
                               run: ForecastRun = ForecastRun(), log=print):
    """Epsilon-loss diffusion trainer with sampling-MSE validation; the
    encoder ('mlp' or 'kan') is ``spec.encoder``.  Returns (best params,
    history with ``train``, ``val``, ``wall_seconds``, ``test_mse``,
    ``final_forecast``)."""
    mesh = driver_mesh(run.mesh_devices, run.mesh_model)
    device, windows, data, sy = _setup(run, X, y, log)
    sched = make_schedule(spec.diff_T, device=device)
    params = diffusion_forecaster_init(
        torch.Generator().manual_seed(run.seed), spec, device=device)
    state = init_state(params, _optimizer(params, run, mesh))

    def loss_fn(p, generator, xb, yb):
        return diffusion_forecaster_loss(p, spec, sched, xb, yb, generator)

    epoch_fn = make_minibatch_epoch(loss_fn, keyed=True)

    def samples_of(p, x, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        s = diffusion_forecaster_sample(p, spec, sched, x, g,
                                        n_samples=run.eval_samples)
        return s[None] if s.ndim == 2 else s   # n_samples == 1: (B, P)

    def eval_sample_mse(p, x, yt, seed):
        return _chunked_mean(lambda q, xs, ys: (torch.sum(
            (samples_of(q, xs, seed).mean(0) - ys) ** 2), ys.numel()),
            p, x, yt, chunk=256)

    noise_seed = derived_seed(run.seed, _NOISE)
    best = (np.inf, copy.deepcopy(state.params))
    dl, start_ep, state, best, _ = resume_run(run, state, best, log)
    history = {"train": [], "val": []}
    t0 = time.perf_counter()
    for ep in range(start_ep, run.epochs):
        state, losses = epoch_fn(state, (noise_seed, ep),
                                 _epoch_batches(windows, run, ep, device))
        vl = eval_sample_mse(state.params, *data["val"],
                             derived_seed(run.seed, _EVAL, ep))
        history["train"].append(float(losses.mean()))
        history["val"].append(vl)
        if vl < best[0]:
            best = (vl, copy.deepcopy(state.params))
        dl.save(ep + 1, state=state, best_crit=best[0], best_params=best[1],
                last=ep + 1 == run.epochs)
        if log is not None and (ep % run.log_every == 0
                                or ep == run.epochs - 1):
            log(f"epoch {ep:3d} | eps-loss {history['train'][-1]:.5f} | "
                f"val sample-MSE {vl:.5f}")

    history["test_mse"] = eval_sample_mse(best[1], *data["test"],
                                          derived_seed(run.seed, _TEST))
    history["wall_seconds"] = time.perf_counter() - t0
    if log is not None:
        log(f"best-val test sample-MSE: {history['test_mse']:.5f}")
    y_hat = samples_of(best[1], data["test"][0][-1:],
                       derived_seed(run.seed, _FINAL)).mean(0)[0]
    history["final_forecast"] = sy.invert(y_hat.cpu().numpy()[:, None])[:, 0]
    return best[1], history
