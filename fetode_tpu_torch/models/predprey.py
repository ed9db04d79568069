"""Lotka-Volterra predator-prey system identification with KAN-FET NODEs.

Counterpart of ``fetode_tpu/models/predprey.py``: learn the vector field of

    dx/dt = alpha*x - beta*x*y
    dy/dt = delta*x*y - gamma*y

with a KANFET [2,10,2] neural ODE integrated by adaptive dopri5.

Solver dispatch in ``predict`` / ``predict_batch`` (by ``solver_mode``
and the tensor's device; a failure on CUDA raises, nothing falls back):

* ``"pallas"`` — the whole-solve CUDA kernels, the mode string of the
  JAX package.  CUDA tensors only.  ``predict`` (one trajectory) takes,
  for a stack whose largest in·out·K is below ``WIDE_DISPATCH_FERRO_N``,
  the discrete-adjoint kernels (``ops/kanfet_adjoint.py:
  kanfet_solve_train``) under autograd (a parameter or x0 that requires
  grad) and otherwise the serving kernel (``ops/kanfet_node.py:
  kanfet_solve``), both the same solve; from that width up the wide
  stack's batch-shared kernels (``ops/kanfet_wide.py:
  kanfet_wide_solve_train``), recording and replaying under autograd,
  the forward alone otherwise, for every stack whose parameters and
  gradients one thread-block cluster holds (``kanfet_wide.holds``); a
  wider or deeper stack takes the per-trajectory kernels (at B = 1 the
  same step control).  ``predict_batch`` steps each trajectory under its
  own controller, so it takes the per-trajectory kernels at every width,
  as the JAX trajectory driver does; they take every pure-KANFET stack
  with D <= 32, and others raise.
* ``"auto"`` — the kernels on a CUDA tensor; on a CPU tensor the eager
  solve, ``"scan"`` under autograd and ``"while"`` otherwise.
* ``"while"`` — the eager early-exit solve on any device, no gradient.
* ``"scan"`` — the eager solve that autograd differentiates.

The fixed-step methods and the head and RNN variants arrive in later
slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fetode_tpu_torch.nn.kan import (
    KAN,
    KANConfig,
    kan_apply,
    kan_init,
    kan_state_init,
    kanfet_config,
)
from fetode_tpu_torch.ops.kanfet_adjoint import kanfet_solve_train
from fetode_tpu_torch.ops.kanfet_node import kanfet_solve
from fetode_tpu_torch.ops.kanfet_wide import (
    holds as wide_holds,
    kanfet_wide_solve_train,
)
from fetode_tpu_torch.solvers.dopri5 import _under_autograd, odeint_dopri5

# ``predict`` sends stacks with max(in*out*K) >= this to the wide stack's
# kernels, as the JAX package does (its crossover, measured on a TPU),
# those that the kernels' cluster holds (``uses_wide_kernel``).  On
# the H100 the crossover at B = 1 lies below 160: chip_smoke.py phase 33
# times both kernels at ferro N = 160, 512, 4,608 and 32,768 and B.3 is
# the faster at each.  The value stays the JAX package's until a benchmark
# sets it (ROADMAP A.6).
WIDE_DISPATCH_FERRO_N = 512


class PredPreyTask(NamedTuple):
    """Task constants (the reference's published config)."""

    alpha: float = 1.5
    beta: float = 1.0
    gamma: float = 3.0
    delta: float = 1.0
    x0: float = 1.0
    y0: float = 1.0
    tf: float = 14.0
    tf_learn: float = 3.5
    n_train: int = 35
    n_t: int = 140


def lotka_volterra_field(task: PredPreyTask):
    def f(t, s):
        x, y = s[..., 0], s[..., 1]
        dx = task.alpha * x - task.beta * x * y
        dy = task.delta * x * y - task.gamma * y
        return torch.stack([dx, dy], dim=-1)
    return f


def generate_data(task: PredPreyTask = PredPreyTask(), *, device=None,
                  dtype=torch.float32):
    """Ground-truth trajectory on the full horizon (tight-tolerance dopri5).

    Returns ``(ts, ts_learn, traj)`` with traj (n_t, 2).
    """
    ts = torch.linspace(0.0, task.tf, task.n_t, device=device, dtype=dtype)
    ts_learn = torch.linspace(0.0, task.tf_learn, task.n_train, device=device,
                              dtype=dtype)
    y0 = torch.tensor([task.x0, task.y0], device=device, dtype=dtype)
    traj = odeint_dopri5(lotka_volterra_field(task), y0, ts, rtol=1e-8,
                         atol=1e-10, max_steps=4096, mode="while")
    return ts, ts_learn, traj


class PredPreyNODE(NamedTuple):
    """Static model+solver spec for the predprey neural ODE."""

    kan: KANConfig
    method: str = "dopri5"
    rtol: float = 1e-7
    atol: float = 1e-9
    max_steps: int = 256            # attempt budget of the adaptive solve
    solver_mode: str = "auto"       # see the module docstring

    @classmethod
    def kanfet(cls, layers_hidden=(2, 10, 2), grid_size: int = 5,
               ferro_num_basis: int = 8, **kw) -> "PredPreyNODE":
        return cls(kan=kanfet_config(list(layers_hidden), grid_size=grid_size,
                                     ferro_num_basis=ferro_num_basis), **kw)


def predprey_init(generator: torch.Generator, spec: PredPreyNODE, *,
                  device=None, dtype=torch.float32) -> KAN:
    return kan_init(generator, spec.kan, device=device, dtype=dtype)


def _use_kernel(params: KAN, spec: PredPreyNODE, x: torch.Tensor) -> bool:
    """Resolve the solver: True for the CUDA kernels, False for eager."""
    if spec.method != "dopri5":
        raise NotImplementedError(
            f"method={spec.method!r}: predprey's fixed-step methods "
            "(solvers/fixed.py under checkpointing) are not wired yet "
            "(ROADMAP A.3)")
    mode = spec.solver_mode
    if mode not in ("auto", "pallas", "while", "scan"):
        raise ValueError(f"solver_mode={mode!r}: expected 'auto', 'pallas', "
                         "'while' or 'scan'")
    if mode == "pallas" and x.device.type != "cuda":
        raise ValueError("solver_mode='pallas' is the CUDA kernel and takes "
                         f"CUDA tensors, got one on {x.device}; use 'auto' "
                         "or 'while' for the eager solve")
    return mode == "pallas" or (mode == "auto" and x.device.type == "cuda")


def max_ferro_n(spec: PredPreyNODE) -> int:
    """The largest in*out*K of the stack's layers."""
    return max(c.in_features * c.out_features * c.ferro_num_basis
               for c in spec.kan.layers)


def uses_wide_kernel(spec: PredPreyNODE) -> bool:
    """Whether ``predict``'s kernel solve takes the wide stack's kernels
    (B.3): a stack whose largest in*out*K reaches
    ``WIDE_DISPATCH_FERRO_N`` and whose one trajectory their cluster
    holds; the others take the per-trajectory kernels (B.1 / B.2)."""
    return (max_ferro_n(spec) >= WIDE_DISPATCH_FERRO_N
            and wide_holds(spec.kan, 1))


def predict(params: KAN, spec: PredPreyNODE, x0: torch.Tensor,
            ts: torch.Tensor, ferro_state=None) -> torch.Tensor:
    """Solve the NODE from ``x0`` reporting states at ``ts``.

    ``x0`` is ``(..., D)`` and the eager solve steps all of it under one
    controller, as the JAX ``predict`` does; the kernel takes one
    trajectory, ``x0`` of shape ``(D,)``.  Hysteresis state is held
    frozen during the solve (fresh unless ``ferro_state`` is given).
    Returns ``(T, ..., D)``.
    """
    if _use_kernel(params, spec, x0):
        if x0.ndim != 1 or ferro_state is not None:
            raise ValueError("the kernel solve takes one (D,) trajectory from "
                             "the fresh hysteresis state; use predict_batch "
                             "for a batch")
        if uses_wide_kernel(spec):
            return kanfet_wide_solve_train(
                params, spec.kan, x0[None], ts, rtol=spec.rtol,
                atol=spec.atol, max_steps=spec.max_steps)[0]
        return predict_batch(params, spec, x0[None], ts)[0]
    if ferro_state is None:
        ferro_state = kan_state_init(x0.shape[:-1], spec.kan, device=x0.device,
                                     dtype=x0.dtype)

    def rhs(t, z):
        return kan_apply(params, z, ferro_state)[0]

    return odeint_dopri5(rhs, x0, ts, rtol=spec.rtol, atol=spec.atol,
                         max_steps=spec.max_steps, mode=spec.solver_mode)


def predict_batch(params: KAN, spec: PredPreyNODE, x0s: torch.Tensor,
                  ts: torch.Tensor) -> torch.Tensor:
    """``(B, D)`` initial conditions -> ``(B, T, D)`` trajectories, each
    stepped on its own: ``jax.vmap(lambda x0: predict(params, spec, x0,
    ts))`` of the JAX package, written out for PyTorch."""
    if _use_kernel(params, spec, x0s):
        solve = (kanfet_solve_train
                 if _under_autograd(x0s, *params.parameters())
                 else kanfet_solve)
        return solve(params, spec.kan, x0s, ts, rtol=spec.rtol,
                     atol=spec.atol, max_steps=spec.max_steps)
    state = kan_state_init((x0s.shape[0],), spec.kan, device=x0s.device,
                           dtype=x0s.dtype)

    def rhs(t, z):
        return kan_apply(params, z, state)[0]

    return odeint_dopri5(rhs, x0s, ts, rtol=spec.rtol, atol=spec.atol,
                         max_steps=spec.max_steps, mode=spec.solver_mode,
                         per_row=True)


def trajectory_loss(params: KAN, spec: PredPreyNODE, x0: torch.Tensor,
                    ts: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE over the trajectory window (the reference's training loss,
    ``train_kanfet_node_predprey.py:254``)."""
    pred = predict(params, spec, x0, ts)
    return torch.mean((pred - target) ** 2)
