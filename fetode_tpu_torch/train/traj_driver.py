"""Trajectory-parallel predprey training: a population of initial
conditions trained in one batched solve per step (counterpart of
``fetode_tpu/train/traj_driver.py``).

The hysteresis state is explicit, so a batch of trajectories trains as
one (B, D) solve.  With ``solver_mode="pallas"`` (or ``"auto"``) on the
card each step is one launch of the discrete-adjoint forward kernel and
one of its backward, every trajectory with its own step control; on the
CPU it is the eager per-row scan solve.

``n_devices`` trains over a ('data', 'model') mesh of that many ranks
(``parallel/``; the process group must be up: torchrun, or
``parallel.spawn_local``).  Every rank solves its block of the
trajectories (the JAX package's ``shard_map``, ``parallel.shard_map_rows``:
the kernel pair on the block on the card, the eager per-row solve on the
CPU) and the parameters' gradients are summed over the data ranks in the
backward.  Every trajectory keeps its own step control, so the curves are
the single-device ones.  With ``model_axis`` > 1 the KAN weights' output
features are sharded over 'model' (``kan_stack_param_specs``); tensor
parallelism is refused under "pallas", as in the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from fetode_tpu_torch.models.predprey import (
    PredPreyNODE,
    PredPreyTask,
    lotka_volterra_field,
    predict_batch,
    predprey_init,
)
from fetode_tpu_torch.parallel import (
    driver_mesh,
    kan_stack_param_specs,
    shard_map_rows,
    shard_params,
)
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.train.loop import init_state, make_epoch_scanner
from fetode_tpu_torch.train.optim import cosine_decay_schedule, make_optimizer
from fetode_tpu_torch.utils.device import resolve_device
from fetode_tpu_torch.utils.init import uniform


@dataclass
class TrajParallelRun:
    task: PredPreyTask = PredPreyTask()
    spec: PredPreyNODE = None
    n_traj: int = 256
    x0_low: float = 0.5
    x0_high: float = 2.0
    lr: float = 2e-3
    epochs: int = 1000
    epochs_per_call: int = 50
    seed: int = 0
    grad_clip: float = 1.0
    cosine_decay: bool = True
    # Pin x0s[0] to the task's canonical initial condition so the
    # single-trajectory workload is a strict subset of the population.
    include_canonical: bool = True
    # Mesh: None = single device (no sharding); otherwise the number of
    # ranks to use, with model_axis-way tensor parallelism inside it.
    n_devices: int = None
    model_axis: int = 1
    dtype: torch.dtype = torch.float32
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"

    def __post_init__(self):
        if self.spec is None:
            self.spec = PredPreyNODE.kanfet()


def make_batched_data(run: TrajParallelRun, device=None):
    """Sample x0s from ``U[x0_low, x0_high)`` with a ``torch.Generator``
    seeded by ``run.seed`` and solve the ground-truth LV system per
    trajectory (tight-tolerance dopri5, the per-row while solve).
    Returns ``(ts_learn (T,), x0s (B, 2), targets (B, T, 2))``."""
    task = run.task
    ts_learn = torch.linspace(0.0, task.tf_learn, task.n_train,
                              dtype=run.dtype, device=device)
    x0s = uniform(torch.Generator().manual_seed(run.seed), (run.n_traj, 2),
                  run.x0_low, run.x0_high, device=device, dtype=run.dtype)
    if run.include_canonical:
        x0s[0] = torch.tensor([task.x0, task.y0], dtype=run.dtype)
    targets = odeint_dopri5(lotka_volterra_field(task), x0s, ts_learn,
                            rtol=1e-8, atol=1e-10, max_steps=2048,
                            mode="while", per_row=True)
    return ts_learn, x0s, targets


def train_traj_parallel(run: TrajParallelRun, log=print):
    """Train on a population of trajectories; returns (params, history)."""
    spec = run.spec
    device = resolve_device(run.device)
    ts_learn, x0s, targets = make_batched_data(run, device)

    params = predprey_init(torch.Generator().manual_seed(run.seed), spec,
                           device=device, dtype=run.dtype)
    lr = (cosine_decay_schedule(run.lr, run.epochs, alpha=0.05)
          if run.cosine_decay else run.lr)

    mesh = None
    placed = params.parameters()
    if run.n_devices is not None:
        if spec.solver_mode == "pallas" and run.model_axis > 1:
            raise ValueError("solver_mode='pallas' shards trajectories over "
                             "'data' only; tensor parallelism needs scan "
                             "mode")
        mesh = driver_mesh(run.n_devices, run.model_axis)
        specs = (kan_stack_param_specs(params) if run.model_axis > 1
                 else None)
        placed = shard_params(params, mesh, specs)
    opt = make_optimizer(lr, params=placed, kind="adam",
                         grad_clip=run.grad_clip)
    state = init_state(params, opt)

    def loss_fn(p, x0s_, targets_):
        if mesh is None:
            pred = predict_batch(p, spec, x0s_, ts_learn)
        else:
            pred = shard_map_rows(
                lambda q, x: predict_batch(q, spec, x, ts_learn), mesh, p,
                x0s_)
        return torch.mean((pred - targets_) ** 2)

    scanner = make_epoch_scanner(loss_fn, run.epochs_per_call)

    history = {"train": [], "epoch": []}
    n_calls = run.epochs // run.epochs_per_call
    t0 = time.perf_counter()
    for call in range(n_calls):
        state, losses = scanner(state, x0s, targets)
        tr = float(losses[-1])
        history["train"].append(tr)
        history["epoch"].append((call + 1) * run.epochs_per_call)
        if log is not None:
            log(f"epoch {history['epoch'][-1]:6d}  batch-train {tr:.6f}")
    history["wall_seconds"] = time.perf_counter() - t0
    history["epochs_per_sec"] = run.epochs / history["wall_seconds"]
    history["traj_epochs_per_sec"] = (run.epochs * run.n_traj
                                      / history["wall_seconds"])
    return state.params, history
