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

A fixed-step ``method`` (``rk4``, ``rk2``, ``euler``, ...;
``solvers/fixed.py``, ``n_substeps`` steps an interval) runs eager on the
tensors' device in every ``solver_mode``, as the JAX package runs no
Pallas kernel for it.  ``full_output=True`` (dopri5 only) also returns
the eager solve's ``Dopri5Stats``; the kernels keep no such counts, so
``solver_mode="pallas"`` refuses it and ``"auto"`` takes the eager solve
for it, as the JAX package's ``"auto"`` does.

The variants of the reference's other predprey scripts follow the JAX
package: ``euler_rollout_predict`` (the Euler rollout with dt = 1/steps,
eager on any device), ``PredPreyNODEWithHead`` / ``predict_with_head``
(a residual MLP head after the solve, which then takes ``predict``'s
dispatch, or inside the field, which no kernel computes: eager) and the
logistic KAN-RNN delta model ``PredPreyRNN`` with its autoregressive
``predprey_rnn_rollout``.  On the card each KAN layer's spline term
still goes to B.12 (``nn/kan.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from fetode_tpu_torch.nn.kan import (
    KAN,
    KANConfig,
    kan_apply,
    kan_init,
    kan_state_init,
    kanfet_config,
)
from fetode_tpu_torch.nn.mlp import (
    ResidualHeadConfig,
    residual_head_apply,
    residual_head_init,
)
from fetode_tpu_torch.nn.rnn import (
    LogisticKANRNNConfig,
    ParamTree,
    logistic_kan_rnn_apply,
    logistic_kan_rnn_init,
)
from fetode_tpu_torch.ops.kanfet_adjoint import kanfet_solve_train
from fetode_tpu_torch.ops.kanfet_node import kanfet_solve
from fetode_tpu_torch.ops.kanfet_wide import (
    holds as wide_holds,
    kanfet_wide_solve_train,
)
from fetode_tpu_torch.solvers.dopri5 import _under_autograd, odeint_dopri5
from fetode_tpu_torch.solvers.fixed import odeint_fixed, rollout_discrete

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
    n_substeps: int = 1             # steps an interval of a fixed method
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
    """Resolve the dopri5 solver: True for the CUDA kernels, False for
    eager."""
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


def _field(params: KAN, spec: PredPreyNODE, x0: torch.Tensor,
           ferro_state=None):
    """The eager solves' vector field for states shaped like ``x0``
    ``(..., D)``, the hysteresis state frozen (fresh unless given)."""
    if ferro_state is None:
        ferro_state = kan_state_init(x0.shape[:-1], spec.kan, device=x0.device,
                                     dtype=x0.dtype)

    def rhs(t, z):
        return kan_apply(params, z, ferro_state)[0]
    return rhs


def _fixed_solve(params: KAN, spec: PredPreyNODE, x0: torch.Tensor,
                 ts: torch.Tensor, ferro_state=None) -> torch.Tensor:
    """A fixed-step ``spec.method`` from ``x0`` ``(..., D)`` ->
    ``(T, ..., D)``."""
    return odeint_fixed(_field(params, spec, x0, ferro_state), x0, ts,
                        method=spec.method, n_substeps=spec.n_substeps)


def predict(params: KAN, spec: PredPreyNODE, x0: torch.Tensor,
            ts: torch.Tensor, ferro_state=None, full_output: bool = False):
    """Solve the NODE from ``x0`` reporting states at ``ts``.

    ``x0`` is ``(..., D)`` and the eager solve steps all of it under one
    controller, as the JAX ``predict`` does; the kernel takes one
    trajectory, ``x0`` of shape ``(D,)``.  Hysteresis state is held
    frozen during the solve (fresh unless ``ferro_state`` is given).
    Returns ``(T, ..., D)``, and with ``full_output`` (dopri5 only) the
    eager solve's ``Dopri5Stats`` beside it.
    """
    if spec.method != "dopri5":
        if full_output:
            raise ValueError("full_output is only meaningful for dopri5")
        return _fixed_solve(params, spec, x0, ts, ferro_state)
    if full_output and spec.solver_mode == "pallas":
        raise ValueError("full_output is not available in pallas mode")
    if not full_output and _use_kernel(params, spec, x0):
        if x0.ndim != 1 or ferro_state is not None:
            raise ValueError("the kernel solve takes one (D,) trajectory from "
                             "the fresh hysteresis state; use predict_batch "
                             "for a batch")
        if uses_wide_kernel(spec):
            return kanfet_wide_solve_train(
                params, spec.kan, x0[None], ts, rtol=spec.rtol,
                atol=spec.atol, max_steps=spec.max_steps)[0]
        return predict_batch(params, spec, x0[None], ts)[0]
    return odeint_dopri5(_field(params, spec, x0, ferro_state), x0, ts,
                         rtol=spec.rtol, atol=spec.atol,
                         max_steps=spec.max_steps, mode=spec.solver_mode,
                         full_output=full_output)


def predict_batch(params: KAN, spec: PredPreyNODE, x0s: torch.Tensor,
                  ts: torch.Tensor) -> torch.Tensor:
    """``(B, D)`` initial conditions -> ``(B, T, D)`` trajectories, each
    stepped on its own: ``jax.vmap(lambda x0: predict(params, spec, x0,
    ts))`` of the JAX package, written out for PyTorch (a fixed-step
    method steps the batch as one, the same per row).  ``ts`` is ``(T,)``,
    shared, or ``(B, T)``, row b's own times (``jax.vmap`` over x0 and ts,
    as multiple shooting solves its segments; the kernels take it as a
    time operand of stride T)."""
    if spec.method != "dopri5":
        if ts.ndim == 2:
            return torch.stack([_fixed_solve(params, spec, x0, t)
                                for x0, t in zip(x0s, ts)])
        return _fixed_solve(params, spec, x0s, ts).transpose(0, 1)
    if _use_kernel(params, spec, x0s):
        solve = (kanfet_solve_train
                 if _under_autograd(x0s, *params.parameters())
                 else kanfet_solve)
        return solve(params, spec.kan, x0s, ts, rtol=spec.rtol,
                     atol=spec.atol, max_steps=spec.max_steps)
    return odeint_dopri5(_field(params, spec, x0s), x0s, ts, rtol=spec.rtol,
                         atol=spec.atol, max_steps=spec.max_steps,
                         mode=spec.solver_mode, per_row=True)


def trajectory_loss(params: KAN, spec: PredPreyNODE, x0: torch.Tensor,
                    ts: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE over the trajectory window (the reference's training loss,
    ``train_kanfet_node_predprey.py:254``)."""
    pred = predict(params, spec, x0, ts)
    return torch.mean((pred - target) ** 2)


def euler_rollout_predict(params: KAN, spec: PredPreyNODE, x0: torch.Tensor,
                          n_steps: int) -> torch.Tensor:
    """Euler trajectory rollout with dt = 1/steps (the
    ``train_kanfet_predprey.py:181-189`` integration scheme), the
    hysteresis state fresh and frozen: ``(n_steps + 1, ..., D)``."""
    state = kan_state_init(x0.shape[:-1], spec.kan, device=x0.device,
                           dtype=x0.dtype)
    return rollout_discrete(lambda z: kan_apply(params, z, state)[0], x0,
                            n_steps, residual_dt=1.0 / n_steps)


# -------------------------------------------------- MLP-head NODE variants


class PredPreyNODEWithHead(NamedTuple):
    """KANFET NODE with a residual-MLP refinement head, in the reference's
    two placements: ``head_inside=False``, the head on the solved
    trajectory (``train_kanfet_mlp_node_predprey.py:206-218``);
    ``head_inside=True``, the head on the field's output
    (``train_kanfet_mlp_predprey.py:179-183``)."""

    node: PredPreyNODE
    head: ResidualHeadConfig
    head_inside: bool = False

    @classmethod
    def make(cls, head_inside: bool = False, bottleneck: int = 32,
             **node_kw) -> "PredPreyNODEWithHead":
        return cls(node=PredPreyNODE.kanfet(**node_kw),
                   head=ResidualHeadConfig(dim=2, bottleneck=bottleneck),
                   head_inside=head_inside)


def predprey_head_init(generator: torch.Generator, spec: PredPreyNODEWithHead,
                       *, device=None, dtype=torch.float32) -> nn.ModuleDict:
    """``{"kan": KAN, "head": the head's layers}``, the JAX package's dict."""
    kw = dict(device=device, dtype=dtype)
    return nn.ModuleDict({"kan": predprey_init(generator, spec.node, **kw),
                          "head": residual_head_init(generator, spec.head,
                                                     **kw)})


def predict_with_head(params: nn.ModuleDict, spec: PredPreyNODEWithHead,
                      x0: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Trajectories ``(T, ..., D)`` of the NODE with its head.

    ``head_inside=False``: the solve is ``predict``'s, with its dispatch
    (a batch ``(B, D)`` through ``predict_batch`` where the kernels take
    it: each trajectory under its own controller, where the JAX function
    steps the batch under one), then the head on every state.  On the
    card under ``"auto"`` / ``"pallas"`` that is B.1, or B.2 under
    autograd: the JAX function's trajectory to the solver's tolerance.

    ``head_inside=True``: the field is the KAN plus the head, which no
    kernel computes, so the solve is eager on the tensors' device in
    every ``solver_mode`` (``"pallas"`` runs as ``"auto"``): dopri5, or
    the fixed-step ``method``, each KAN layer's spline term on B.12 on
    the card.
    """
    node = spec.node
    kan, head = params["kan"], params["head"]
    if not spec.head_inside:
        if (node.method == "dopri5" and x0.ndim == 2
                and _use_kernel(kan, node, x0)):
            traj = predict_batch(kan, node, x0, ts).transpose(0, 1)
        else:
            traj = predict(kan, node, x0, ts)
        return residual_head_apply(head, spec.head, traj)
    state = kan_state_init(x0.shape[:-1], node.kan, device=x0.device,
                           dtype=x0.dtype)

    def rhs(t, z):
        return residual_head_apply(head, spec.head,
                                   kan_apply(kan, z, state)[0])
    if node.method == "dopri5":
        mode = "auto" if node.solver_mode == "pallas" else node.solver_mode
        return odeint_dopri5(rhs, x0, ts, rtol=node.rtol, atol=node.atol,
                             max_steps=node.max_steps, mode=mode)
    return odeint_fixed(rhs, x0, ts, method=node.method,
                        n_substeps=node.n_substeps)


# ------------------------------------------------------- RNN delta model


class PredPreyRNN(NamedTuple):
    """Logistic-basis KAN-RNN predicting state deltas, rolled out
    autoregressively (``train_kanfet_rnn_predprey.py:119-225``)."""

    seq_len: int = 16
    hidden_size: int = 64
    num_basis: int = 10

    @property
    def rnn_cfg(self) -> LogisticKANRNNConfig:
        return LogisticKANRNNConfig(input_size=3, hidden_size=self.hidden_size,
                                    out_dim=2, num_basis=self.num_basis)


def predprey_rnn_init(generator: torch.Generator, spec: PredPreyRNN, *,
                      device=None, dtype=torch.float32) -> ParamTree:
    return logistic_kan_rnn_init(generator, spec.rnn_cfg, device=device,
                                 dtype=dtype)


def make_txy_seq(t_scalar: torch.Tensor, xy: torch.Tensor,
                 seq_len: int) -> torch.Tensor:
    """(B,) times + (B, 2) states -> (B, seq_len, 3) repeated [t, x, y]
    feature sequences (``train_kanfet_rnn_predprey.py:199-208``)."""
    feat = torch.cat([t_scalar[:, None], xy], dim=-1)
    return feat[:, None, :].expand(feat.shape[0], seq_len, 3)


def predprey_rnn_delta(params: ParamTree, spec: PredPreyRNN,
                       t_scalar: torch.Tensor, xy: torch.Tensor
                       ) -> torch.Tensor:
    """The predicted state delta (B, 2) at times (B,) from states (B, 2)."""
    return logistic_kan_rnn_apply(params, spec.rnn_cfg,
                                  make_txy_seq(t_scalar, xy, spec.seq_len))


def predprey_rnn_rollout(params: ParamTree, spec: PredPreyRNN,
                         x0y0: torch.Tensor, t_grid: torch.Tensor
                         ) -> torch.Tensor:
    """The autoregressive rollout pred[k+1] = pred[k] + delta(t_k, pred[k])
    over ``t_grid`` (T,) from ``x0y0`` (2,): (T, 2)
    (``train_kanfet_rnn_predprey.py:210-225``)."""
    out, xy = [x0y0], x0y0
    for k in range(t_grid.shape[0] - 1):
        xy = xy + predprey_rnn_delta(params, spec, t_grid[k:k + 1],
                                     xy[None])[0]
        out.append(xy)
    return torch.stack(out)
