"""ECG200 classification models: the KAN-FET neural-ODE classifiers
(counterpart of ``fetode_tpu/models/ecg.py``).

Ported: ``KanFetNODE`` with the 'plain' latent field (logistic mixer and
a projection; its whole-solve kernels are ``ops/logistic_node.py``) and
with the 'mlp' field (layer norm, tanh bound, logistic mixer, a two-layer
B-spline KAN and an output layer; ``ops/mlp_node.py``), and
``KanFetMLPNODE``, the two-layer ferro field (``ops/ferro_node.py``),
all with the adaptive dopri5 latent solve over [0, 1].  Parameters live
in ``nn.Module``s whose ``state_dict`` keys are the JAX package's dict
keys (``encoder_w``, ``field_mixer.a``, ``kan.layers.0.base_weight``,
``fc1.k`` ...), so ``convert.ecg_params_from_numpy`` loads a JAX tree.

Solver dispatch (``solver_mode``): ``"pallas"`` takes the whole-solve
CUDA kernels and raises for a CPU tensor; ``"auto"`` takes them for a
CUDA tensor and the eager solve for a CPU one; ``"scan"`` / ``"while"``
are the eager solves (``odeint_dopri5``; ``"auto"`` there is scan under
autograd, while otherwise).  On the kernel path a call under autograd
runs the kernel pair (forward with records, replay backward), a call
without it the forward kernel alone.

Not ported yet, each raising an error that names its ROADMAP item: the
fixed-step solvers (A.3), the ``mesh`` argument (A.11), and the RNN
models (A.7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from fetode_tpu_torch.nn.kan import KANConfig, kan_apply, kan_init
from fetode_tpu_torch.nn.mlp import layer_norm
from fetode_tpu_torch.ops.ferro import (
    FerroConfig,
    ferro_apply,
    ferro_init,
    ferro_state_init,
)
from fetode_tpu_torch.ops.ferro_node import (
    basis_layout,
    ferro_node_solve,
    frozen_solve_noise,
)
from fetode_tpu_torch.ops.logistic import (
    LogisticParams,
    logistic_basis,
    logistic_init,
)
from fetode_tpu_torch.ops.logistic_node import logistic_node_solve
from fetode_tpu_torch.ops.mlp_node import mlp_node_solve
from fetode_tpu_torch.ops.node_common import use_kernel
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.utils.init import kaiming_uniform, normal


def _final_state(rhs, h0: torch.Tensor, spec) -> torch.Tensor:
    """The eager latent solve over [0, 1] -> the final state."""
    ts = torch.tensor([0.0, 1.0], dtype=h0.dtype, device=h0.device)
    return odeint_dopri5(rhs, h0, ts, rtol=spec.rtol, atol=spec.atol,
                         max_steps=spec.max_steps, mode=spec.solver_mode)[-1]


# ---------------------------------------------------------- feature mixer


class Mixer(nn.Module):
    """KANFeatureMixer parameters: logistic slope ``a`` and centre ``b``,
    each ``(dim, num_basis)``."""

    def __init__(self, params: LogisticParams):
        super().__init__()
        self.a = nn.Parameter(params.a)
        self.b = nn.Parameter(params.b)


def mixer_init(generator: torch.Generator, dim: int, num_basis: int, *,
               device=None, dtype=torch.float32) -> Mixer:
    return Mixer(logistic_init(generator, dim, num_basis, device=device,
                               dtype=dtype))


def mixer_apply(params: Mixer, x: torch.Tensor) -> torch.Tensor:
    """x -> sigmoid of the logistic basis, flattened to (..., D*K)."""
    phi = torch.sigmoid(logistic_basis(LogisticParams(params.a, params.b), x))
    return phi.reshape(*x.shape[:-1], -1)


# ------------------------------------------------ KanFet NODE (logistic)


class KanFetNODESpec(NamedTuple):
    T: int = 96
    num_classes: int = 2
    latent_dim: int = 64
    num_basis: int = 10
    ode_hidden: int = 128
    field: str = "plain"        # No_MLP_KANODEFunc; 'mlp': MLPKANODEFunc
    solver: str = "dopri5"
    rtol: float = 1e-2
    atol: float = 1e-3
    max_steps: int = 16
    h_bound: float = 1.0
    init_out_std: float = 1e-3
    solver_mode: str = "auto"   # see the module docstring

    @property
    def kan_cfg(self) -> KANConfig:
        """The 'mlp' field's KAN: [D*K, hidden, hidden]."""
        return KANConfig.make([self.latent_dim * self.num_basis,
                               self.ode_hidden, self.ode_hidden])


_FIELDS = ("plain", "mlp")


def _check_field(spec: KanFetNODESpec) -> None:
    if spec.field not in _FIELDS:
        raise ValueError(f"KanFetNODESpec.field={spec.field!r}: expected one "
                         f"of {_FIELDS}")


class KanFetNODEParams(nn.Module):
    """Parameters of a KanFetNODE, named as the JAX dict: the encoder, the
    two mixers and the classifier, then the field's own (``field``):
    'plain' ``proj_w``, ``proj_b``; 'mlp' ``ln_scale``, ``ln_bias``,
    ``kan`` (a ``KAN``), ``out_w``, ``out_b``, ``log_alpha``, ``scale``.
    A tensor becomes a parameter, a module a submodule."""

    def __init__(self, encoder_w, encoder_b, field_mixer: Mixer,
                 cls_mixer: Mixer, cls_w, cls_b, **field):
        super().__init__()
        self.encoder_w = nn.Parameter(encoder_w)
        self.encoder_b = nn.Parameter(encoder_b)
        self.field_mixer = field_mixer
        self.cls_mixer = cls_mixer
        self.cls_w = nn.Parameter(cls_w)
        self.cls_b = nn.Parameter(cls_b)
        for name, value in field.items():
            setattr(self, name, value if isinstance(value, nn.Module)
                    else nn.Parameter(value))


def kanfet_node_init(generator: torch.Generator, spec: KanFetNODESpec, *,
                     device=None, dtype=torch.float32) -> KanFetNODEParams:
    _check_field(spec)
    D, K = spec.latent_dim, spec.num_basis
    kw = dict(device=device, dtype=dtype)
    encoder_w = kaiming_uniform(generator, (D, spec.T), **kw)
    field_mixer = mixer_init(generator, D, K, **kw)
    cls_mixer = mixer_init(generator, D, K, **kw)
    cls_w = kaiming_uniform(generator, (spec.num_classes, D * K), **kw)
    if spec.field == "plain":
        # small-init projection (B, D*K) -> (B, D)
        field = dict(proj_w=normal(generator, (D, D * K), **kw) * 0.01,
                     proj_b=torch.zeros(D, **kw))
    else:
        field = dict(
            ln_scale=torch.ones(D, **kw), ln_bias=torch.zeros(D, **kw),
            kan=kan_init(generator, spec.kan_cfg, **kw),
            out_w=normal(generator, (D, spec.ode_hidden), **kw)
            * spec.init_out_std,
            out_b=torch.zeros(D, **kw),
            log_alpha=torch.tensor(-3.0, **kw), scale=torch.tensor(1.0, **kw))
    return KanFetNODEParams(
        encoder_w, torch.zeros(D, **kw), field_mixer, cls_mixer, cls_w,
        torch.zeros(spec.num_classes, **kw), **field)


def kanfet_node_field(params: KanFetNODEParams, spec: KanFetNODESpec, t,
                      h: torch.Tensor) -> torch.Tensor:
    _check_field(spec)
    if spec.field == "plain":
        phi = mixer_apply(params.field_mixer, h)
        return phi @ params.proj_w.T + params.proj_b
    h = layer_norm(h, params.ln_scale, params.ln_bias)
    h = spec.h_bound * torch.tanh(h / spec.h_bound)
    phi = mixer_apply(params.field_mixer, h)
    z, _ = kan_apply(params.kan, phi)
    dh = F.silu(z) @ params.out_w.T + params.out_b
    return params.scale * F.softplus(params.log_alpha) * dh


def kanfet_node_apply(params: KanFetNODEParams, spec: KanFetNODESpec,
                      x: torch.Tensor) -> torch.Tensor:
    """x (B, T) -> logits (B, num_classes); latent NODE over [0, 1]."""
    _check_field(spec)
    h0 = x @ params.encoder_w.T + params.encoder_b
    if use_kernel(spec, x):
        solve = logistic_node_solve if spec.field == "plain" \
            else mlp_node_solve
        hT = solve(params, h0, spec)
    else:
        hT = _final_state(lambda t, h: kanfet_node_field(params, spec, t, h),
                          h0, spec)
    feat = mixer_apply(params.cls_mixer, hT)
    return feat @ params.cls_w.T + params.cls_b


# ---------------------------------------------- KanFet MLP NODE (ferro)


class KanFetMLPNODESpec(NamedTuple):
    T: int = 96
    num_classes: int = 2
    latent_dim: int = 64
    num_basis: int = 10
    ode_hidden: int = 128
    solver: str = "dopri5"      # fixed-step rollouts wait for ROADMAP A.3
    rtol: float = 1e-2
    atol: float = 1e-3
    max_steps: int = 16
    n_steps: int = 8            # fixed-step count for rollout variants
    h_bound: float = 1.0
    dh_clip: float = 50.0
    noise_std: float = 0.0      # >0: frozen per-solve device noise
    solver_mode: str = "auto"   # see the module docstring
    state_dtype: str = ""       # "" = input dtype, or e.g. "bfloat16"
    # The two TPU kernel layouts, "loop" (per-sample loop) and "vec"
    # (3-D batch blocks), are one computation; both take the one CUDA
    # kernel pair.
    pallas_layout: str = "loop"
    gate_impl: str = "sigmoid"  # "tanh": the eager solves only

    @property
    def fc1_cfg(self) -> FerroConfig:
        return FerroConfig(self.latent_dim, self.ode_hidden, self.num_basis,
                           noise_std=self.noise_std, gate_impl=self.gate_impl)

    @property
    def fc2_cfg(self) -> FerroConfig:
        return FerroConfig(self.ode_hidden, self.latent_dim, self.num_basis,
                           noise_std=self.noise_std, gate_impl=self.gate_impl)


class KanFetMLPNODEParams(nn.Module):
    """Parameters of the ferro KanFetMLPNODE, named as the JAX dict."""

    def __init__(self, encoder_w, encoder_b, fc1, fc2, cls_w, cls_b):
        super().__init__()
        self.encoder_w = nn.Parameter(encoder_w)
        self.encoder_b = nn.Parameter(encoder_b)
        self.fc1 = fc1
        self.fc2 = fc2
        self.cls_w = nn.Parameter(cls_w)
        self.cls_b = nn.Parameter(cls_b)


def kanfet_mlp_node_init(generator: torch.Generator,
                         spec: KanFetMLPNODESpec, *, device=None,
                         dtype=torch.float32) -> KanFetMLPNODEParams:
    kw = dict(device=device, dtype=dtype)
    D = spec.latent_dim
    encoder_w = kaiming_uniform(generator, (D, spec.T), **kw)
    fc1 = ferro_init(generator, spec.fc1_cfg, coef_scale=0.1, **kw)
    fc2 = ferro_init(generator, spec.fc2_cfg, coef_scale=0.1, **kw)
    cls_w = kaiming_uniform(generator, (spec.num_classes, D), **kw)
    return KanFetMLPNODEParams(encoder_w, torch.zeros(D, **kw), fc1, fc2,
                               cls_w, torch.zeros(spec.num_classes, **kw))


def kanfet_mlp_node_field(params: KanFetMLPNODEParams,
                          spec: KanFetMLPNODESpec, t, h: torch.Tensor,
                          states, noise=None) -> torch.Tensor:
    """Two-layer ferro field with the reference's stability armor: latent
    tanh bound, ferro, tanh, ferro, non-finite scrub, slope clamp.
    Hysteresis state is frozen during the solve.  ``noise``: the frozen
    per-solve draws of both layers in the basis shape, or None (the
    adaptive solve cannot budget fresh noise per evaluation)."""
    s1, s2 = states
    n1, n2 = noise if noise is not None else (None, None)
    h = spec.h_bound * torch.tanh(h / spec.h_bound)
    z, _ = ferro_apply(params.fc1, s1, h, spec.fc1_cfg, noise=n1)
    z = torch.tanh(z)
    dh, _ = ferro_apply(params.fc2, s2, z, spec.fc2_cfg, noise=n2)
    dh = torch.nan_to_num(dh, nan=0.0, posinf=1e3, neginf=-1e3)
    return torch.clamp(dh, -spec.dh_clip, spec.dh_clip)


def kanfet_mlp_node_apply(params: KanFetMLPNODEParams,
                          spec: KanFetMLPNODESpec, x: torch.Tensor, *,
                          generator: torch.Generator | None = None,
                          noise_std=None, mesh=None) -> torch.Tensor:
    """x (B, T) -> logits.  One batched latent solve.

    Device noise (``spec.noise_std > 0``, or ``noise_std`` overriding
    it) is frozen per solve: ``frozen_solve_noise`` draws it once from
    ``generator``, and the kernels and the eager solve add the same
    draws."""
    if mesh is not None:
        raise NotImplementedError("kanfet_mlp_node_apply(mesh=...): the "
                                  "multi-device solve is not ported yet "
                                  "(ROADMAP A.11)")
    if noise_std is not None and spec.solver_mode == "pallas" \
            and generator is None:
        raise ValueError("an overriding noise_std on the pallas path requires "
                         "a generator (std-0 members ride zero-valued noise "
                         "operands)")
    if spec.gate_impl != "sigmoid" and spec.solver_mode == "pallas":
        raise ValueError("gate_impl='tanh' requires an eager solve: the "
                         "whole-solve kernel implements the sigmoid form")
    kernel = use_kernel(spec, x) and spec.gate_impl == "sigmoid"
    B = x.shape[0]
    h0 = x @ params.encoder_w.T + params.encoder_b
    noise = None
    if spec.noise_std > 0.0 or noise_std is not None:
        if generator is None:
            raise ValueError("noise_std > 0 requires a generator")
        noise = frozen_solve_noise(generator, B, spec.fc1_cfg, spec.fc2_cfg,
                                   noise_std=noise_std, device=x.device)
    if kernel:
        hT = ferro_node_solve(params.fc1, params.fc2, h0, spec, noise=noise)
    else:
        sdt = getattr(torch, spec.state_dtype) if spec.state_dtype \
            else x.dtype
        states = tuple(ferro_state_init((B,), cfg, device=x.device, dtype=sdt)
                       for cfg in (spec.fc1_cfg, spec.fc2_cfg))
        if noise is not None:
            noise = (basis_layout(noise[0], spec.latent_dim),
                     basis_layout(noise[1], spec.ode_hidden))
        hT = _final_state(lambda t, h: kanfet_mlp_node_field(
            params, spec, t, h, states, noise), h0, spec)
    return hT @ params.cls_w.T + params.cls_b
