"""End-to-end predator-prey trainer, one trajectory (counterpart of
``fetode_tpu/train/predprey_driver.py``).

The reference's published configuration
(``train_kanfet_node_predprey.py:20-27``: lr 2e-3, Adam, 10k epochs,
KANFET [2,10,2] grid 5, dopri5), with the JAX package's additions:
global-norm clipping and cosine decay, the KAN regulariser
(``reg_lambda``), validation-window best-snapshot selection
(``val_points``), the consistent time base, and

* the step-budget ladder (``step_budget_schedule``, ``budget_headroom``):
  training starts at a small dopri5 attempt budget and climbs the ladder
  (256 -> 64, 128, 256) when a probe after a call (the eager while solve
  with ``Dopri5Stats``) uses more than the headroom's share of it or
  stops short of the window's end; the training step is rebuilt at the
  new budget;
* multiple shooting (``shooting_points``): the fit window cut into
  segments of that many samples, overlapping by one, each solved from
  its observed first value at its own times, all in one batch;
* periodicity anchoring (``phase_anchor_periods``, ``anchor_cycles``),
  dense and jittered collocation (``dense_anchor``, ``jitter_anchor``)
  and selection by a held-out anchored loss (``select_anchor_k``);
* the live grid refit (``grid_update_every``, ``nn/kan.py:
  kan_update_grid``) on the states the eval solve visits over the fit
  window;
* durable checkpoint/resume (``ckpt_dir``, ``ckpt_every``, ``resume``;
  ``train/checkpoint.py``): train state, best snapshot and budget stage,
  and on resume the jitter draws fast-forwarded, so a resumed run
  continues the exact curve of an unbroken one.  ``aot_cache`` is
  accepted and logged (the port compiles nothing per run).

On the card the training solve is the discrete-adjoint kernel pair (B.2)
and the evaluation, validation and selection solves the serving kernel
(B.1); a stack whose largest in·out·K reaches ``WIDE_DISPATCH_FERRO_N``
(``--layers 2,32,2`` and wider) takes the wide stack's kernels (B.3) for
its one trajectory instead.  Multiple shooting solves its segments
through ``predict_batch`` at every width: B.2 with a row of times a
segment (the kernels' time operand of stride T), since B.3 takes one
row of times shared by its batch and at most one cluster (ROADMAP C,
F6).  On the CPU every solve is eager.  ``shooting_devices`` spreads the
segments over the 'data' axis of a mesh of that many ranks (the process
group must be up): every rank solves its block of segments (B.2 on the
card) and the parameters' gradients are summed over the ranks in the
backward (``parallel.shard_map_rows``); each segment keeps its own step
control, so the curve is the single-device one.  Rank 0 alone writes
checkpoints.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fetode_tpu_torch.models.predprey import (
    PredPreyNODE,
    PredPreyTask,
    generate_data,
    lotka_volterra_field,
    predict,
    predict_batch,
    predprey_init,
    trajectory_loss,
)
from fetode_tpu_torch.nn.kan import kan_regularization, kan_update_grid
from fetode_tpu_torch.parallel import driver_mesh, shard_map_rows
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.train.checkpoint import aot_cache_note, resume_run
from fetode_tpu_torch.train.loop import init_state, make_epoch_scanner
from fetode_tpu_torch.train.optim import cosine_decay_schedule, make_optimizer
from fetode_tpu_torch.utils.device import resolve_device


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
    # Step-budget ladder ending at spec.max_steps; escalates when the probe
    # uses more than budget_headroom of the budget or fails.
    step_budget_schedule: bool = False
    budget_headroom: float = 0.75
    # Every N calls, refit the KAN grids to the states along the current
    # predicted trajectory (0 disables).
    grid_update_every: int = 0
    # Warm start from trained parameters (a KAN) instead of a fresh init.
    init_params: object = None
    # Multiple shooting (0 disables): segments of shooting_points samples,
    # overlapping by one, each solved from its observed first value;
    # requires (n_fit - 1) % (shooting_points - 1) == 0.
    shooting_points: int = 0
    # Parallel in time (0 disables; requires shooting_points > 1): the
    # segments over the 'data' axis of a mesh of this many ranks;
    # requires n_segments % shooting_devices == 0.
    shooting_devices: int = 0
    # Best-model selection by the loss k periods out (0 disables).
    select_anchor_k: int = 0
    # Cubic-spline densification of the fit window (0 disables), in log
    # space when every target is positive.
    dense_anchor: int = 0
    # Stratified jitter of the dense fit times every call (needs
    # dense_anchor).
    jitter_anchor: bool = False
    # Fit the window and its shift by k periods (0 disables), or by every
    # j of anchor_cycles.
    phase_anchor_periods: int = 0
    anchor_cycles: tuple = ()
    # Durable checkpoint/resume: every ckpt_every epochs into ckpt_dir;
    # resume restores the latest and continues exactly.
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    # Accepted and logged: the port has no compiled program to cache.
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


def _budget_ladder(max_steps: int) -> list:
    """E.g. 256 -> [64, 128, 256]; never below 32."""
    ladder = [max_steps]
    while ladder[0] // 2 >= 32:
        ladder.insert(0, ladder[0] // 2)
    return ladder[-3:]


def _estimate_period(task: PredPreyTask, dtype) -> float:
    """Orbit period from a dense ground-truth solve over the train window
    only ([0, tf_learn]), in float64: the first return of the trajectory
    to x0 after t > tf_learn / 2, read on the 4,001-point grid in
    ``dtype`` as the JAX package reads it.  Requires tf_learn to cover at
    least one period (the reference's task: T ~ 3.317 < 3.5)."""
    n_dense = 4001
    ts = torch.linspace(0.0, task.tf_learn, n_dense, dtype=torch.float64)
    y0 = torch.tensor([task.x0, task.y0], dtype=torch.float64)
    traj = odeint_dopri5(lotka_volterra_field(task), y0, ts, rtol=1e-10,
                         atol=1e-12, max_steps=8192, mode="while").numpy()
    d = np.linalg.norm(traj - y0.numpy(), axis=1)
    half = n_dense // 2
    i = half + int(np.argmin(d[half:]))
    if d[i] > 0.05:
        raise ValueError("train window does not cover a full period; "
                         "phase_anchor_periods requires tf_learn >= T")
    return float(torch.linspace(0.0, task.tf_learn, n_dense, dtype=dtype)[i])


class FitProblem(NamedTuple):
    """What ``train_predprey`` fits: the spec (its budget scaled for
    anchors), the segments' spec under shooting (else None), the fit
    arguments of the loss (``(x0, ts, target)``, or under shooting the
    segments' first values (S, D), times (S, P) and targets (S, P, D)),
    the fit window's times, and the draw of a jittered grid for each call
    (else None)."""

    spec: PredPreyNODE
    spec_shoot: Optional[PredPreyNODE]
    fit_args: tuple
    ts_fit: torch.Tensor
    resample_fit: Optional[Callable]


def fit_problem(run: PredPreyRun, x0: torch.Tensor, ts: torch.Tensor,
                ts_learn: torch.Tensor, target_train: torch.Tensor
                ) -> FitProblem:
    """The fit construction of the JAX driver: the held-out tail, the
    spline densification, the periodicity anchors, the jitter and the
    shooting segments, with its ``ValueError``s."""
    spec, dtype, device = run.spec, run.dtype, x0.device
    n_fit = run.task.n_train - run.val_points
    ts_fit = (ts[:n_fit] if run.consistent_time_base
              else ts_learn[:n_fit])        # see the knob's comment
    target_fit = target_train[:n_fit]

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    window_spline = None
    if run.dense_anchor > 0:
        # Host-side spline densification of the fit window, on the
        # observed samples only.
        from scipy.interpolate import CubicSpline

        ts_np = ts_fit.cpu().numpy().astype(np.float64)
        tgt_np = target_fit.cpu().numpy().astype(np.float64)
        if np.all(tgt_np > 0):
            _cs = CubicSpline(ts_np, np.log(tgt_np), axis=0)
            window_spline = lambda t: np.exp(_cs(t))  # noqa: E731
        else:
            window_spline = CubicSpline(ts_np, tgt_np, axis=0)
        n_dense = (ts_np.shape[0] - 1) * run.dense_anchor + 1
        t_dense = np.linspace(ts_np[0], ts_np[-1], n_dense)
        ts_fit = tensor(t_dense)
        target_fit = tensor(window_spline(t_dense))

    anchor_shifts = (tuple(run.anchor_cycles) if run.anchor_cycles
                     else ((run.phase_anchor_periods,)
                           if run.phase_anchor_periods > 0 else ()))
    t_period = None
    if anchor_shifts:
        # The same target values at output times shifted by whole periods;
        # the solve's horizon grows (1 + max k)-fold, and so does its
        # attempt budget.
        t_period = _estimate_period(run.task, dtype)
        ts_aug = torch.cat([ts_fit] + [ts_fit + j * t_period
                                       for j in anchor_shifts])
        order = torch.argsort(ts_aug, stable=True)
        ts_fit = ts_aug[order]
        target_fit = torch.cat([target_fit]
                               * (1 + len(anchor_shifts)))[order]
        spec = spec._replace(
            max_steps=(1 + max(anchor_shifts)) * spec.max_steps)

    resample_fit = None
    if run.jitter_anchor:
        if window_spline is None:
            raise ValueError("jitter_anchor requires dense_anchor > 0")
        t_grid = t_dense     # the pre-shift dense window grid
        h_j = float(t_grid[1] - t_grid[0])
        rng = np.random.default_rng(run.seed + 17)

        def resample_fit():
            # interior points jittered within +-0.49h: order preserved,
            # endpoints pinned, a fresh continuum sample every call
            t_w = t_grid.copy()
            t_w[1:-1] = t_w[1:-1] + rng.uniform(
                -0.49, 0.49, t_grid.shape[0] - 2) * h_j
            tg = window_spline(t_w)
            if anchor_shifts:
                t_all = np.concatenate(
                    [t_w] + [t_w + j * t_period for j in anchor_shifts])
                order = np.argsort(t_all)
                tg = np.concatenate([tg] * (1 + len(anchor_shifts)))[order]
                t_all = t_all[order]
            else:
                t_all = t_w
            return (x0, tensor(t_all), tensor(tg))

    fit_args = (x0, ts_fit, target_fit)
    spec_shoot = None
    if run.shooting_points > 1:
        if anchor_shifts or run.step_budget_schedule:
            raise ValueError("shooting_points is incompatible with "
                             "anchoring / step_budget_schedule")
        P = run.shooting_points
        n_pts = int(ts_fit.shape[0])
        if (n_pts - 1) % (P - 1):
            raise ValueError(f"(n_fit-1)={n_pts - 1} intervals not divisible "
                             f"by shooting_points-1={P - 1}")
        n_seg = (n_pts - 1) // (P - 1)
        idx = torch.as_tensor(np.stack(
            [np.arange(i * (P - 1), i * (P - 1) + P) for i in range(n_seg)]),
            device=device)
        # Per-segment budget: the segment's share of the full budget with
        # 4x headroom.
        seg_budget = max(32, int(4 * spec.max_steps * (P - 1) / (n_pts - 1)))
        spec_shoot = spec._replace(max_steps=seg_budget)
        fit_args = (target_fit[idx[:, 0]], ts_fit[idx], target_fit[idx])
        if run.shooting_devices > 0 and n_seg % run.shooting_devices:
            raise ValueError(f"{n_seg} shooting segments not divisible "
                             f"by shooting_devices={run.shooting_devices}")
    elif run.shooting_devices > 0:
        raise ValueError("shooting_devices requires shooting_points > 1")
    return FitProblem(spec, spec_shoot, fit_args, ts_fit, resample_fit)


def make_loss(run: PredPreyRun, fit: FitProblem, budget: int,
              mesh=None) -> Callable:
    """The training loss at an attempt budget: ``loss(params, *fit_args)``,
    the window's trajectory MSE or, under shooting, the segments' MSE
    (``predict_batch`` with a row of times a segment; with a ``mesh``,
    each rank's block of segments), plus the KAN regulariser."""
    spec_b = fit.spec._replace(max_steps=budget)

    def segments(p, x0_, ts_):
        return predict_batch(p, fit.spec_shoot, x0_, ts_)

    def loss_fn(p, x0_, ts_, target_):
        if fit.spec_shoot is not None:
            pred = (segments(p, x0_, ts_) if mesh is None else
                    shard_map_rows(segments, mesh, p, x0_, ts_))
            loss = torch.mean((pred - target_) ** 2)
        else:
            loss = trajectory_loss(p, spec_b, x0_, ts_, target_)
        if run.reg_lambda > 0.0:
            loss = loss + run.reg_lambda * kan_regularization(p)
        return loss
    return loss_fn


def train_predprey(run: PredPreyRun, log=print):
    """Train; returns (best params, history dict)."""
    task = run.task
    device = resolve_device(run.device)
    ts, ts_learn, truth = generate_data(task, device=device, dtype=run.dtype)
    target_train = truth[:task.n_train]
    x0 = torch.tensor([task.x0, task.y0], dtype=run.dtype, device=device)
    n_fit = task.n_train - run.val_points
    fit = fit_problem(run, x0, ts, ts_learn, target_train)
    spec, fit_args = fit.spec, fit.fit_args
    aot_cache_note(run.aot_cache, log)

    params = (copy.deepcopy(run.init_params) if run.init_params is not None
              else predprey_init(torch.Generator().manual_seed(run.seed),
                                 spec, device=device, dtype=run.dtype))
    lr = (cosine_decay_schedule(run.lr, run.epochs, alpha=0.05)
          if run.cosine_decay else run.lr)
    opt = make_optimizer(lr, params=params.parameters(), kind="adam",
                         grad_clip=run.grad_clip if run.grad_clip > 0
                         else None)
    state = init_state(params, opt)

    budgets = (_budget_ladder(spec.max_steps) if run.step_budget_schedule
               and spec.method == "dopri5" else [spec.max_steps])

    mesh = driver_mesh(run.shooting_devices)

    def make_scanner(budget):
        return make_epoch_scanner(make_loss(run, fit, budget, mesh),
                                  run.epochs_per_call)

    def make_probe(budget):
        # The eager while solve with its attempt counts (the kernels keep
        # none), on the fit window.
        pspec = spec._replace(max_steps=budget, solver_mode="while")

        @torch.no_grad()
        def probe(p):
            _, stats = predict(p, pspec, x0, fit.ts_fit, full_output=True)
            return int(stats.n_accepted + stats.n_rejected), bool(
                stats.success)
        return probe

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

    sel_loss = None
    if run.select_anchor_k > 0:
        ks = run.select_anchor_k
        t_sel = _estimate_period(task, run.dtype)
        # t = 0 heads the grid: the field is autonomous, so a solve started
        # at k*T from x0 would only reproduce the window's solution.
        ts_sel = torch.cat([torch.zeros(1, dtype=run.dtype, device=device),
                            ts_learn + ks * t_sel])
        sel_spec = spec._replace(max_steps=4 * (1 + ks) * run.spec.max_steps,
                                 solver_mode="auto")

        @torch.no_grad()
        def sel_loss(p):
            pred = predict(p, sel_spec, x0, ts_sel)
            return torch.mean((pred[1:] - target_train) ** 2)

    stage = 0
    history = {"train": [], "test": [], "val": [], "epoch": [], "budget": []}
    best = (math.inf, copy.deepcopy(state.params))
    n_calls = run.epochs // run.epochs_per_call

    dl, start_ep, state, best, saved = resume_run(run, state, best, None)
    start_call = start_ep // run.epochs_per_call
    if saved is not None:
        stage = int(saved["stage"])
        if log is not None:
            log(f"[ckpt] resumed at epoch {start_ep} (budget stage {stage}) "
                f"from {run.ckpt_dir}")
        if fit.resample_fit is not None:
            # fast-forward the jitter draws, so that the resumed run fits
            # the grids the unbroken run would
            for _ in range(start_call):
                fit.resample_fit()

    scanner = make_scanner(budgets[stage])
    probe = (make_probe(budgets[stage])
             if len(budgets) > 1 and stage < len(budgets) - 1 else None)

    # Warm call outside the timed window, on a copy of the state: PyTorch
    # compiles nothing per call, so one step builds the kernels (nvcc, on
    # first use) and warms CUDA and the allocator.
    warm = copy.deepcopy(state)
    make_epoch_scanner(make_loss(run, fit, budgets[stage], mesh), 1)(warm,
                                                               *fit_args)
    _ = float(test_loss(warm.params)) if run.eval_every_call else None
    _ = float(val_loss(warm.params)) if run.val_points > 0 else None
    _ = float(sel_loss(warm.params)) if sel_loss is not None else None
    del warm

    t0 = time.perf_counter()
    for call in range(start_call, n_calls):
        if fit.resample_fit is not None:
            fit_args = fit.resample_fit()
        state, losses = scanner(state, *fit_args)
        tr = float(losses[-1])
        history["train"].append(tr)
        history["epoch"].append((call + 1) * run.epochs_per_call)
        history["budget"].append(budgets[stage])
        if run.eval_every_call:
            history["test"].append(float(test_loss(state.params)))
        crit = tr
        if run.val_points > 0:
            va = float(val_loss(state.params))
            history["val"].append(va)
            crit = va
        if sel_loss is not None:
            crit = float(sel_loss(state.params))
            history.setdefault("sel", []).append(crit)
        if crit < best[0]:
            best = (crit, copy.deepcopy(state.params))
        if run.grid_update_every and (call + 1) % run.grid_update_every == 0 \
                and call < n_calls - 1:
            # Refit the grids to the states the field visits (the predicted
            # trajectory over the fit window); the refit keeps shapes and
            # writes in place, so the optimiser's state stays attached.
            with torch.no_grad():
                samples = predict(state.params, eval_spec, x0, fit.ts_fit)
            kan_update_grid(state.params, samples)
        # Escalate the step budget when the probe shows near-exhaustion
        # (or the forward no longer reaches the window's end).
        if probe is not None and stage < len(budgets) - 1:
            used, ok = probe(state.params)
            if (not ok) or used > run.budget_headroom * budgets[stage]:
                stage += 1
                scanner = make_scanner(budgets[stage])
                probe = (make_probe(budgets[stage])
                         if stage < len(budgets) - 1 else None)
                if log is not None:
                    log(f"[budget] escalating max_steps -> {budgets[stage]} "
                        f"(probe used {used}, success={ok})")
        dl.save((call + 1) * run.epochs_per_call, state=state,
                best_crit=best[0], best_params=best[1], stage=stage,
                last=call == n_calls - 1)
        if log is not None:
            msg = f"epoch {history['epoch'][-1]:6d}  train {tr:.6f}"
            if run.val_points > 0:
                msg += f"  val {history['val'][-1]:.6f}"
            if run.eval_every_call:
                msg += f"  test {history['test'][-1]:.6f}"
            log(msg)
    history["wall_seconds"] = time.perf_counter() - t0
    epochs_run = max(1, (n_calls - start_call) * run.epochs_per_call)
    history["epochs_per_sec"] = epochs_run / history["wall_seconds"]
    return best[1], history
