"""Conditional-diffusion trainer and forecast evaluation (counterpart of
``fetode_tpu/train/cond_diffusion_driver.py``).

AdamW (lr 2e-4, weight decay 1e-4), global-norm clip 1.0, minibatches
reshuffled every epoch (seed ``run.seed + epoch``), the epsilon loss with
each step's draws (the steps, then the noise) from a generator seeded from
(run seed, epoch, step) (``train/loop.py: step_generator``), the
validation loss over the whole validation split once an epoch, and the
parameters of the best validation loss kept.  Forecasts are the mean of
``n_samples`` reverse chains on the past conditioning, which is encoded
once for all of them: the samples are folded into the chain's rows
(row ``s*B + b`` is sample s of window b), so one chain of S*B rows runs.

On the card a training step of a NODE-encoder denoiser runs the encoder's
kernel pair (``ops/node_enc.py``: the forward with records and the replay
backward); validation and sampling run without autograd, so the forward
kernel alone, recording nothing (the JAX package downgrades its kernel to
the while-mode solve there).

Checkpoint/resume (``ckpt_dir``, ``ckpt_every``, ``resume``;
``train/checkpoint.py: DurableLoop``) saves the train state, the best
snapshot and its validation loss every ``ckpt_every`` epochs and after
the last; a resumed run continues the exact curve of an unbroken one,
since every epoch's shuffle, step generators and validation draws are
seeded from the run seed and the epoch alone (the JAX package carries a
key chain in the payload instead).  ``aot_cache`` is accepted and
logged: the port compiles nothing per run.

``mesh_devices`` / ``mesh_model`` train over a mesh of that many ranks.
A denoiser with the convolutional encoder treats each window on its own,
so its minibatch is sharded over the ranks: each rank takes its block
of the rows and of the step's draws (the steps and the noise are drawn for
the whole minibatch from the single-device generator, then cut), and
the train step sums the gradients (``train/loop.py``).  The NODE
encoder steps its batch under one controller, so its denoisers run the
whole minibatch on every rank.  ``mesh_model`` > 1 shards the weights'
output features over 'model'.  The curves are the single-device ones;
rank 0 alone writes checkpoints.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from fetode_tpu_torch.data.timeseries import window_batches
from fetode_tpu_torch.models.cond_diffusion import (
    CondDenoiserSpec,
    cond_denoiser_apply,
    cond_denoiser_encode,
    cond_denoiser_init,
    cond_denoiser_sample_loop,
)
from fetode_tpu_torch.nn.diffusion import (
    DiffusionSchedule,
    make_schedule,
    q_sample,
)
from fetode_tpu_torch.parallel import (
    driver_mesh,
    place_params,
    shard_rows,
)
from fetode_tpu_torch.train.checkpoint import aot_cache_note, resume_run
from fetode_tpu_torch.train.loop import (
    derived_seed,
    init_state,
    make_minibatch_epoch,
)
from fetode_tpu_torch.train.optim import make_optimizer
from fetode_tpu_torch.utils.device import resolve_device

# Streams of the seeds derived from run.seed: step noise, validation.
_NOISE, _EVAL = 1, 2


@dataclass
class CondDiffusionRun:
    """seq_len 96, pred_len 24, diffusion T 250, batch 64, AdamW 2e-4."""

    seq_len: int = 96
    pred_len: int = 24
    diff_T: int = 250
    beta_start: float = 1e-4
    beta_end: float = 2e-2
    epochs: int = 10
    batch_size: int = 64
    lr: float = 2e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0
    eval_samples: int = 10
    log_every: int = 1
    # >0: train over a ('data', 'model') mesh of this many ranks (see the
    # module docstring); mesh_model > 1 shards the weights' output
    # features over 'model'.
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


def _schedule(run: CondDiffusionRun, device) -> DiffusionSchedule:
    return make_schedule(run.diff_T, run.beta_start, run.beta_end,
                         device=device)


def cond_diffusion_loss(params, spec: CondDenoiserSpec,
                        sched: DiffusionSchedule, past: torch.Tensor,
                        fut: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        t_idx: Optional[torch.Tensor] = None,
                        eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epsilon-prediction MSE; the steps ``t_idx`` (B,) and the noise
    ``eps`` are drawn from ``generator`` (in that order) unless given."""
    if t_idx is None:
        t_idx = torch.randint(0, sched.T, (fut.shape[0],),
                              generator=generator, device=fut.device)
    y_noisy, eps = q_sample(sched, fut, t_idx, generator, eps=eps)
    eps_hat = cond_denoiser_apply(params, spec, y_noisy, past, t_idx)
    return torch.mean((eps_hat - eps) ** 2)


def train_conditional_diffusion(spec: CondDenoiserSpec, past_fut,
                                run: CondDiffusionRun = CondDiffusionRun(),
                                log=print):
    """``past_fut``: 'train' / 'val' / 'test' -> (past (M, Lx, D), fut (M,
    Ly, D)) numpy arrays.  Returns (best params, history with ``train``,
    ``val`` and ``wall_seconds``)."""
    mesh = driver_mesh(run.mesh_devices, run.mesh_model)
    aot_cache_note(run.aot_cache, log)
    device = resolve_device(run.device)
    sched = _schedule(run, device)
    params = cond_denoiser_init(torch.Generator().manual_seed(run.seed), spec,
                                device=device)
    per_row = mesh is not None and spec.encoder == "conv"
    placed = place_params(params, mesh, grad_sum=per_row)
    state = init_state(params, make_optimizer(
        run.lr, params=placed, kind="adamw",
        weight_decay=run.weight_decay, grad_clip=run.grad_clip))
    # the minibatch's rows (window_batches clamps the size to the split),
    # sharded over the ranks where they divide (else whole on every rank)
    rows = min(run.batch_size, len(past_fut["train"][0]))
    sharded = per_row and rows % mesh.size == 0

    def loss_fn(p, generator, past, fut):
        if not sharded:
            return cond_diffusion_loss(p, spec, sched, past, fut, generator)
        # this rank's rows: the single-device draws for the whole
        # minibatch, then this rank's block of them
        t_idx = torch.randint(0, sched.T, (rows,), generator=generator,
                              device=fut.device)
        eps = torch.randn((rows,) + tuple(fut.shape[1:]), generator=generator,
                          device=fut.device, dtype=fut.dtype)
        t_idx, eps = shard_rows((t_idx, eps), mesh)
        return cond_diffusion_loss(p, spec, sched, past, fut, t_idx=t_idx,
                                   eps=eps)

    epoch_fn = make_minibatch_epoch(loss_fn, keyed=True)
    pv, fv = (torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in past_fut["val"])
    noise_seed = derived_seed(run.seed, _NOISE)
    best = (np.inf, copy.deepcopy(state.params))
    dl, start_ep, state, best, _ = resume_run(run, state, best, log)
    history = {"train": [], "val": []}
    t0 = time.perf_counter()
    for ep in range(start_ep, run.epochs):
        bp, bf = window_batches(*past_fut["train"], run.batch_size,
                                seed=run.seed + ep)
        batches = (torch.as_tensor(bp, device=device),
                   torch.as_tensor(bf, device=device))
        if sharded:
            batches = shard_rows(batches, mesh, batch_axis=1)
        state, losses = epoch_fn(state, (noise_seed, ep), batches)
        g = torch.Generator(device=device).manual_seed(
            derived_seed(run.seed, _EVAL, ep))
        with torch.no_grad():
            vl = float(cond_diffusion_loss(state.params, spec, sched, pv,
                                           fv, g))
        history["train"].append(float(losses.mean()))
        history["val"].append(vl)
        if vl < best[0]:
            best = (vl, copy.deepcopy(state.params))
        dl.save(ep + 1, state=state, best_crit=best[0], best_params=best[1],
                last=ep + 1 == run.epochs)
        if log is not None and ep % run.log_every == 0:
            log(f"epoch {ep:3d} | eps-loss {history['train'][-1]:.5f} | "
                f"val {vl:.5f}")
    history["wall_seconds"] = time.perf_counter() - t0
    return best[1], history


def sample_forecasts(params, spec: CondDenoiserSpec,
                     sched: DiffusionSchedule, past: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     n_samples: int = 10, *,
                     y0: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, B, Ly, D) posterior samples of the reverse chain, no autograd.
    The conditioning is encoded once and repeated for the S samples,
    folded into rows ``s*B + b`` of one chain.  ``y0`` (S, B, Ly, D) and
    ``noise`` (S, T, B, Ly, D) are the draws of each sample's own chain,
    else drawn from ``generator`` in that order."""
    S, B = n_samples, past.shape[0]
    shape = (S, B, spec.pred_len, spec.d_in)
    kw = dict(generator=generator, device=past.device, dtype=past.dtype)
    with torch.no_grad():
        cond = cond_denoiser_encode(params, spec, past)
        if y0 is None:
            y0 = torch.randn(shape, **kw)
        if noise is None:
            noise = torch.randn((S, sched.T) + shape[1:], **kw)
        y = cond_denoiser_sample_loop(
            params, spec, sched, cond.repeat(S, 1), y0=y0.reshape(
                (S * B,) + shape[2:]),
            noise=noise.transpose(0, 1).reshape((sched.T, S * B) + shape[2:]))
    return y.reshape(shape)


def evaluate_forecast(params, spec: CondDenoiserSpec, run: CondDiffusionRun,
                      past, fut, generator: Optional[torch.Generator] = None,
                      n_samples: Optional[int] = None):
    """MSE and MAE of the sample mean over a split, and the samples (S, B,
    Ly, D) as numpy."""
    device = next(params.parameters()).device
    past, fut = (torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (past, fut))
    samples = sample_forecasts(params, spec, _schedule(run, device), past,
                               generator, n_samples or run.eval_samples)
    mean_pred = samples.mean(0)
    return {"mse": float(torch.mean((mean_pred - fut) ** 2)),
            "mae": float(torch.mean(torch.abs(mean_pred - fut))),
            "samples": samples.cpu().numpy()}
