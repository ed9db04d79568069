"""Forecasting models: the latent neural-ODE point forecaster and the
conditional-diffusion forecasters (counterpart of
``fetode_tpu/models/forecasting.py``).

Parameters live in ``nn.ModuleDict``s keyed as the JAX package's dicts
(``encoder``, ``dynamics``, ``decoder`` | ``eps_head``); an MLP is an
``nn.ModuleList`` of ``Dense`` layers (``nn/mlp.py``) and the KAN
encoder the port's ``KAN``, so ``convert.forecast_params_from_numpy``
loads a JAX tree.

Latent solve dispatch (``solver_mode``), as the port's other models:
``"pallas"`` takes the whole-solve CUDA kernels (``ops/ode_dyn.py``) and
raises for a CPU tensor; ``"auto"`` takes them for a CUDA tensor and the
eager solve for a CPU one; ``"scan"`` / ``"while"`` are the eager solves
(``odeint_dopri5``; ``"auto"`` there is scan under autograd, while
otherwise).  On the kernel path a call under autograd runs the kernel
pair (the forward with records, the replay backward), a call without it
the forward kernel alone.  The diffusion sampler is the whole-chain
kernel of ``ops/ddpm.py``.

A fixed-step ``solver`` takes ``odeint_fixed`` (``n_substeps`` steps an
interval) in every mode, as the JAX package does.  The diffusion
forecaster's context encoder is an MLP (``"mlp"``), a two-layer KAN
(``"kan"``) or the logistic KAN-RNN of ``nn/rnn.py`` (``"kanrnn"``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from fetode_tpu_torch.nn.diffusion import (
    DiffusionSchedule,
    EpsHeadConfig,
    eps_head_apply,
    eps_head_init,
    q_sample,
)
from fetode_tpu_torch.nn.kan import KANConfig, kan_init, kan_linear_apply
from fetode_tpu_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from fetode_tpu_torch.nn.rnn import (
    KANRNNEncoderConfig,
    kan_rnn_encoder_apply,
    kan_rnn_encoder_init,
)
from fetode_tpu_torch.ops.ddpm import eps_head_sample
from fetode_tpu_torch.ops.logistic import (
    LogisticParams,
    logistic_basis,
    logistic_init,
)
from fetode_tpu_torch.ops.node_common import use_kernel
from fetode_tpu_torch.ops.ode_dyn import ode_dyn_solve
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.solvers.fixed import odeint_fixed
from fetode_tpu_torch.utils.init import kaiming_uniform

# -------------------------------------------------------------- dynamics


class ODEDynamicsConfig(NamedTuple):
    """Time-conditioned latent field f([z, t]) (2-layer tanh MLP)."""

    latent_dim: int
    hidden: int = 128

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig((self.latent_dim + 1, self.hidden, self.hidden,
                          self.latent_dim), activation="tanh")


def ode_dynamics_init(generator: torch.Generator, cfg: ODEDynamicsConfig,
                      *, device=None, dtype=torch.float32) -> nn.ModuleList:
    return mlp_init(generator, cfg.mlp, device=device, dtype=dtype)


def ode_dynamics_apply(params: nn.ModuleList, cfg: ODEDynamicsConfig, t,
                       z: torch.Tensor) -> torch.Tensor:
    t_in = torch.as_tensor(t, dtype=z.dtype, device=z.device).expand(
        z.shape[:-1] + (1,))
    return mlp_apply(params, cfg.mlp, torch.cat([z, t_in], dim=-1))


def _solve_latent(params: nn.ModuleList, cfg: ODEDynamicsConfig,
                  z0: torch.Tensor, t_fut: torch.Tensor, spec
                  ) -> torch.Tensor:
    """The latent trajectory (T, B, D) at ``t_fut`` from ``z0`` (B, D)."""
    if use_kernel(spec, z0):
        return ode_dyn_solve(params, z0, t_fut, rtol=spec.rtol,
                             atol=spec.atol, max_steps=spec.max_steps)

    def rhs(t, z):
        return ode_dynamics_apply(params, cfg, t, z)

    if spec.solver != "dopri5":
        return odeint_fixed(rhs, z0, t_fut, method=spec.solver,
                            n_substeps=spec.n_substeps)
    return odeint_dopri5(rhs, z0, t_fut, rtol=spec.rtol, atol=spec.atol,
                         max_steps=spec.max_steps, mode=spec.solver_mode)


def _t_fut(spec, x: torch.Tensor, t_fut) -> torch.Tensor:
    if t_fut is None:
        return torch.arange(spec.pred_len, dtype=x.dtype, device=x.device)
    return t_fut


# --------------------------------------------------- point forecaster


class LatentODEForecasterSpec(NamedTuple):
    num_features: int
    context_len: int = 96
    pred_len: int = 8
    latent_dim: int = 64
    enc_hidden: int = 128
    dec_hidden: int = 128
    dyn_hidden: int = 128
    solver: str = "dopri5"
    rtol: float = 1e-3
    atol: float = 1e-4
    max_steps: int = 32
    n_substeps: int = 4
    solver_mode: str = "auto"   # see the module docstring

    @property
    def enc(self) -> MLPConfig:
        return MLPConfig((self.context_len * self.num_features,
                          self.enc_hidden, self.latent_dim), activation="relu")

    @property
    def dec(self) -> MLPConfig:
        return MLPConfig((self.latent_dim, self.dec_hidden, 1),
                         activation="relu")

    @property
    def dyn(self) -> ODEDynamicsConfig:
        return ODEDynamicsConfig(self.latent_dim, self.dyn_hidden)


def latent_ode_forecaster_init(generator: torch.Generator,
                               spec: LatentODEForecasterSpec, *, device=None,
                               dtype=torch.float32) -> nn.ModuleDict:
    kw = dict(device=device, dtype=dtype)
    return nn.ModuleDict({
        "encoder": mlp_init(generator, spec.enc, **kw),
        "dynamics": ode_dynamics_init(generator, spec.dyn, **kw),
        "decoder": mlp_init(generator, spec.dec, **kw),
    })


def latent_ode_forecast(params: nn.ModuleDict, spec: LatentODEForecasterSpec,
                        x_ctx: torch.Tensor, t_fut=None) -> torch.Tensor:
    """x_ctx (B, context_len, F) -> y_hat (B, pred_len)."""
    B = x_ctx.shape[0]
    z0 = mlp_apply(params["encoder"], spec.enc, x_ctx.reshape(B, -1))
    z_traj = _solve_latent(params["dynamics"], spec.dyn, z0,
                           _t_fut(spec, x_ctx, t_fut), spec)    # (T, B, D)
    y = mlp_apply(params["decoder"], spec.dec, z_traj)          # (T, B, 1)
    return y[..., 0].transpose(0, 1)                            # (B, T)


# ----------------------------------------------- diffusion forecasters


class DiffusionForecasterSpec(NamedTuple):
    num_features: int
    context_len: int = 96
    pred_len: int = 8
    latent_dim: int = 64
    enc_hidden: int = 128
    dyn_hidden: int = 128
    diff_T: int = 100
    diff_hidden: int = 256
    encoder: str = "mlp"        # 'mlp' | 'kan' | 'kanrnn'
    rnn_hidden: int = 64
    num_basis: int = 10
    solver: str = "dopri5"
    rtol: float = 1e-3
    atol: float = 1e-4
    max_steps: int = 32
    n_substeps: int = 4
    solver_mode: str = "auto"   # see the module docstring

    @property
    def enc_mlp(self) -> MLPConfig:
        return MLPConfig((self.context_len * self.num_features,
                          self.enc_hidden, self.latent_dim), activation="relu")

    @property
    def enc_kan(self) -> KANConfig:
        return KANConfig.make([self.context_len * self.num_features,
                               self.enc_hidden, self.latent_dim])

    @property
    def enc_rnn(self) -> KANRNNEncoderConfig:
        return KANRNNEncoderConfig(self.num_features, self.rnn_hidden,
                                   self.latent_dim, self.num_basis)

    @property
    def dyn(self) -> ODEDynamicsConfig:
        return ODEDynamicsConfig(self.latent_dim, self.dyn_hidden)

    @property
    def eps_cfg(self) -> EpsHeadConfig:
        return EpsHeadConfig(pred_len=self.pred_len,
                             cond_dim=self.pred_len * self.latent_dim,
                             hidden=self.diff_hidden)


def _check_encoder(spec: DiffusionForecasterSpec) -> None:
    if spec.encoder not in ("mlp", "kan", "kanrnn"):
        raise ValueError(f"unknown encoder {spec.encoder!r}")


def diffusion_forecaster_init(generator: torch.Generator,
                              spec: DiffusionForecasterSpec, *, device=None,
                              dtype=torch.float32) -> nn.ModuleDict:
    _check_encoder(spec)
    kw = dict(device=device, dtype=dtype)
    if spec.encoder == "mlp":
        enc = mlp_init(generator, spec.enc_mlp, **kw)
    elif spec.encoder == "kan":
        enc = kan_init(generator, spec.enc_kan, **kw)
    else:
        enc = kan_rnn_encoder_init(generator, spec.enc_rnn, **kw)
    return nn.ModuleDict({
        "encoder": enc,
        "dynamics": ode_dynamics_init(generator, spec.dyn, **kw),
        "eps_head": eps_head_init(generator, spec.eps_cfg, **kw),
    })


def _encode(params: nn.ModuleDict, spec: DiffusionForecasterSpec,
            x_ctx: torch.Tensor) -> torch.Tensor:
    _check_encoder(spec)
    if spec.encoder == "kanrnn":
        return kan_rnn_encoder_apply(params["encoder"], spec.enc_rnn, x_ctx)
    x = x_ctx.reshape(x_ctx.shape[0], -1)
    if spec.encoder == "mlp":
        return mlp_apply(params["encoder"], spec.enc_mlp, x)
    # Flatten -> KAN -> ReLU -> KAN, the reference's two KAN blocks.
    first, *rest = params["encoder"].layers
    h = torch.relu(kan_linear_apply(first, x)[0])
    for layer in rest:
        h = kan_linear_apply(layer, h)[0]
    return h


def _cond(params: nn.ModuleDict, spec: DiffusionForecasterSpec,
          x_ctx: torch.Tensor, t_fut: torch.Tensor) -> torch.Tensor:
    z0 = _encode(params, spec, x_ctx)
    z_traj = _solve_latent(params["dynamics"], spec.dyn, z0, t_fut, spec)
    return z_traj.transpose(0, 1).reshape(x_ctx.shape[0], -1)  # (B, T*D)


def diffusion_forecaster_loss(params: nn.ModuleDict,
                              spec: DiffusionForecasterSpec,
                              sched: DiffusionSchedule, x_ctx: torch.Tensor,
                              y_fut: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              t_fut=None, *,
                              t_idx: Optional[torch.Tensor] = None,
                              eps: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Epsilon-prediction MSE; the steps ``t_idx`` (B,) and the noise
    ``eps`` are drawn from ``generator`` (in that order) unless given."""
    cond = _cond(params, spec, x_ctx, _t_fut(spec, x_ctx, t_fut))
    B = y_fut.shape[0]
    if t_idx is None:
        t_idx = torch.randint(0, sched.T, (B,), generator=generator,
                              device=y_fut.device)
    y_noisy, eps = q_sample(sched, y_fut, t_idx, generator, eps=eps)
    eps_hat = eps_head_apply(params["eps_head"], spec.eps_cfg, y_noisy, t_idx,
                             cond)
    return torch.mean((eps_hat - eps) ** 2)


def diffusion_forecaster_sample(params: nn.ModuleDict,
                                spec: DiffusionForecasterSpec,
                                sched: DiffusionSchedule, x_ctx: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                t_fut=None,
                                n_samples: int = 1) -> torch.Tensor:
    """Sample future sequences: (B, P), or (n_samples, B, P), through the
    whole-chain kernel (``ops/ddpm.py``; its plain version on the CPU),
    the samples folded into its rows."""
    with torch.no_grad():
        cond = _cond(params, spec, x_ctx, _t_fut(spec, x_ctx, t_fut))
        return eps_head_sample(params["eps_head"], spec.eps_cfg, sched, cond,
                               generator, n_samples=n_samples)


# --------------------------------------------------- logistic linear


class LogisticLinear(nn.Module):
    """``basis`` (the logistic ``a``, ``b``), ``w`` and ``b``, named as
    the JAX dict."""

    def __init__(self, basis: LogisticParams, w, b):
        super().__init__()
        self.basis = nn.ParameterDict({"a": nn.Parameter(basis.a),
                                       "b": nn.Parameter(basis.b)})
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def logistic_linear_init(generator: torch.Generator, in_dim: int,
                         out_dim: int, num_basis: int, *, device=None,
                         dtype=torch.float32) -> LogisticLinear:
    kw = dict(device=device, dtype=dtype)
    basis = logistic_init(generator, in_dim, num_basis, **kw)
    w = kaiming_uniform(generator, (out_dim, in_dim * num_basis), **kw)
    return LogisticLinear(basis, w, torch.zeros(out_dim, **kw))


def logistic_linear_apply(params: LogisticLinear,
                          x: torch.Tensor) -> torch.Tensor:
    phi = logistic_basis(LogisticParams(params.basis["a"],
                                        params.basis["b"]), x)
    return phi.reshape(*x.shape[:-1], -1) @ params.w.T + params.b
