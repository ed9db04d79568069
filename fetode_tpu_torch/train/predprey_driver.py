"""End-to-end predator-prey trainer, one trajectory (counterpart of
``fetode_tpu/train/predprey_driver.py``).

The reference's published configuration
(``train_kanfet_node_predprey.py:20-27``: lr 2e-3, Adam, 10k epochs,
KANFET [2,10,2] grid 5, dopri5), with the JAX package's additions that
are ported: global-norm clipping and cosine decay, the KAN regulariser
(``reg_lambda``), validation-window best-snapshot selection
(``val_points``) and the consistent time base.  On the card the training
solve is the discrete-adjoint kernel pair and the evaluation solves the
serving kernel; a stack whose largest in·out·K reaches
``WIDE_DISPATCH_FERRO_N`` (``--layers 2,32,2`` and wider) takes the wide
stack's kernels instead, the recording forward and replay to train and
the forward alone to evaluate.  On the CPU both are the eager solves.

The other ``PredPreyRun`` knobs keep their fields and defaults; setting
one raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from dataclasses import dataclass

import torch

from fetode_tpu_torch.models.predprey import (
    PredPreyNODE,
    PredPreyTask,
    generate_data,
    predict,
    predprey_init,
    trajectory_loss,
)
from fetode_tpu_torch.nn.kan import kan_regularization
from fetode_tpu_torch.train.loop import init_state, make_epoch_scanner
from fetode_tpu_torch.train.optim import cosine_decay_schedule, make_optimizer
from fetode_tpu_torch.utils.device import resolve_device

# Knobs of the JAX driver that are not ported yet, with where they are
# queued.  Each keeps its field and default in PredPreyRun.
_NOT_PORTED = {
    "step_budget_schedule": "ROADMAP A.5 (step-budget ladder)",
    "budget_headroom": "ROADMAP A.5 (step-budget ladder)",
    "grid_update_every": "ROADMAP A.2 (kan_update_grid)",
    "shooting_points": "ROADMAP A.5 (multiple shooting)",
    "shooting_devices": "ROADMAP A.5 (multiple shooting) and A.11 "
                        "(multi-device)",
    "select_anchor_k": "ROADMAP A.5 (anchored training and selection)",
    "dense_anchor": "ROADMAP A.5 (anchored training and selection)",
    "jitter_anchor": "ROADMAP A.5 (anchored training and selection)",
    "phase_anchor_periods": "ROADMAP A.5 (anchored training and selection)",
    "anchor_cycles": "ROADMAP A.5 (anchored training and selection)",
    "ckpt_dir": "ROADMAP A.5 (checkpoint/resume)",
    "ckpt_every": "ROADMAP A.5 (checkpoint/resume)",
    "resume": "ROADMAP A.5 (checkpoint/resume)",
    "aot_cache": "ROADMAP A.5 (aot_cache)",
}


@dataclass
class PredPreyRun:
    task: PredPreyTask = PredPreyTask()
    spec: PredPreyNODE = None  # default: KANFET [2,10,2]
    lr: float = 2e-3
    epochs: int = 10_000
    epochs_per_call: int = 100
    seed: int = 0
    eval_every_call: bool = True
    dtype: torch.dtype = torch.float32
    # Stability: clip + cosine decay (the reference's bare Adam at 2e-3
    # oscillates).
    grad_clip: float = 1.0
    cosine_decay: bool = True
    # KAN regulariser weight, and the number of learn-window points held
    # out as the best-snapshot criterion.
    reg_lambda: float = 0.0
    val_points: int = 0
    # Not ported (see _NOT_PORTED): step-budget ladder, grid refit.
    step_budget_schedule: bool = False
    budget_headroom: float = 0.75
    grid_update_every: int = 0
    # Warm start from trained parameters (a KAN) instead of a fresh init.
    init_params: object = None
    # Not ported (see _NOT_PORTED): shooting, anchors, checkpoints, AOT.
    shooting_points: int = 0
    shooting_devices: int = 0
    select_anchor_k: int = 0
    dense_anchor: int = 0
    jitter_anchor: bool = False
    phase_anchor_periods: int = 0
    anchor_cycles: tuple = ()
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    aot_cache: str = ""
    # True = fit at the times the window targets were sampled
    # (ts[:n_train]); False = the reference's t_learn grid, which runs
    # 2.2% slow (see the JAX driver's docstring of this knob).
    consistent_time_base: bool = False
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"

    def __post_init__(self):
        if self.spec is None:
            self.spec = PredPreyNODE.kanfet()


def _check_ported(run: PredPreyRun) -> None:
    for f in dataclasses.fields(run):
        if f.name in _NOT_PORTED and getattr(run, f.name) != f.default:
            raise NotImplementedError(
                f"PredPreyRun.{f.name}={getattr(run, f.name)!r} is not "
                f"ported yet: {_NOT_PORTED[f.name]}")


def train_predprey(run: PredPreyRun, log=print):
    """Train; returns (best params, history dict)."""
    _check_ported(run)
    task, spec = run.task, run.spec
    device = resolve_device(run.device)
    ts, ts_learn, truth = generate_data(task, device=device, dtype=run.dtype)
    target_train = truth[:task.n_train]
    x0 = torch.tensor([task.x0, task.y0], dtype=run.dtype, device=device)

    # Optional held-out validation tail inside the learn window.
    n_fit = task.n_train - run.val_points
    ts_fit = (ts[:n_fit] if run.consistent_time_base
              else ts_learn[:n_fit])        # see the knob's comment
    target_fit = target_train[:n_fit]

    params = (copy.deepcopy(run.init_params) if run.init_params is not None
              else predprey_init(torch.Generator().manual_seed(run.seed),
                                 spec, device=device, dtype=run.dtype))
    lr = (cosine_decay_schedule(run.lr, run.epochs, alpha=0.05)
          if run.cosine_decay else run.lr)
    opt = make_optimizer(lr, params=params.parameters(), kind="adam",
                         grad_clip=run.grad_clip if run.grad_clip > 0
                         else None)
    state = init_state(params, opt)
    fit_args = (x0, ts_fit, target_fit)

    def loss_fn(p, x0_, ts_, target_):
        loss = trajectory_loss(p, spec, x0_, ts_, target_)
        if run.reg_lambda > 0.0:
            loss = loss + run.reg_lambda * kan_regularization(p)
        return loss

    scanner = make_epoch_scanner(loss_fn, run.epochs_per_call)

    # Evaluation solves, no gradient: on the card the serving kernel, on
    # the CPU the eager while solve.
    eval_spec = spec._replace(max_steps=4 * spec.max_steps, solver_mode="auto")

    @torch.no_grad()
    def test_loss(p):
        pred = predict(p, eval_spec, x0, ts)
        return torch.mean((pred[task.n_train:] - truth[task.n_train:]) ** 2)

    @torch.no_grad()
    def val_loss(p):
        pred = predict(p, eval_spec, x0, ts_learn)
        return torch.mean((pred[n_fit:] - target_train[n_fit:]) ** 2)

    history = {"train": [], "test": [], "val": [], "epoch": [], "budget": []}
    best = (math.inf, copy.deepcopy(state.params))
    n_calls = run.epochs // run.epochs_per_call

    # Warm call outside the timed window, on a copy of the state: PyTorch
    # compiles nothing per call, so one step builds the kernels (nvcc, on
    # first use) and warms CUDA and the allocator.
    warm = copy.deepcopy(state)
    make_epoch_scanner(loss_fn, 1)(warm, *fit_args)
    _ = float(test_loss(warm.params)) if run.eval_every_call else None
    _ = float(val_loss(warm.params)) if run.val_points > 0 else None
    del warm

    t0 = time.perf_counter()
    for call in range(n_calls):
        state, losses = scanner(state, *fit_args)
        tr = float(losses[-1])
        history["train"].append(tr)
        history["epoch"].append((call + 1) * run.epochs_per_call)
        history["budget"].append(spec.max_steps)
        if run.eval_every_call:
            history["test"].append(float(test_loss(state.params)))
        crit = tr
        if run.val_points > 0:
            va = float(val_loss(state.params))
            history["val"].append(va)
            crit = va
        if crit < best[0]:
            best = (crit, copy.deepcopy(state.params))
        if log is not None:
            msg = f"epoch {history['epoch'][-1]:6d}  train {tr:.6f}"
            if run.val_points > 0:
                msg += f"  val {history['val'][-1]:.6f}"
            if run.eval_every_call:
                msg += f"  test {history['test'][-1]:.6f}"
            log(msg)
    history["wall_seconds"] = time.perf_counter() - t0
    epochs_run = max(1, n_calls * run.epochs_per_call)
    history["epochs_per_sec"] = epochs_run / history["wall_seconds"]
    return best[1], history
