"""ECG200 classification models: the KAN-FET neural-ODE classifiers
(counterpart of ``fetode_tpu/models/ecg.py``).

Ported: ``KanFetNODE`` with the 'plain' latent field (logistic mixer and
a projection; its whole-solve kernels are ``ops/logistic_node.py``) and
with the 'mlp' field (layer norm, tanh bound, logistic mixer, a two-layer
B-spline KAN and an output layer; ``ops/mlp_node.py``), and
``KanFetMLPNODE``, the two-layer ferro field (``ops/ferro_node.py``),
all with the adaptive dopri5 latent solve over [0, 1];
``kanfet_mlp_node_apply_members`` applies P members of a population (the
noise study) at once, their latent solves one member launch of the
kernels.  Parameters live in ``nn.Module``s whose ``state_dict`` keys
are the JAX package's dict keys (``encoder_w``, ``field_mixer.a``,
``kan.layers.0.base_weight``, ``fc1.k`` ...), so
``convert.ecg_params_from_numpy`` loads a JAX tree.

Solver dispatch (``solver_mode``): ``"pallas"`` takes the whole-solve
CUDA kernels and raises for a CPU tensor; ``"auto"`` takes them for a
CUDA tensor and the eager solve for a CPU one; ``"scan"`` / ``"while"``
are the eager solves (``odeint_dopri5``; ``"auto"`` there is scan under
autograd, while otherwise).  On the kernel path a call under autograd
runs the kernel pair (forward with records, replay backward), a call
without it the forward kernel alone.

A fixed-step ``solver`` (euler, rk2, rk4 ...) takes the eager
final-state integration of ``solvers/fixed.py`` in every mode, as the JAX
package does (its whole-solve kernels are dopri5 only); there a noisy
``KanFetMLPNODE`` draws fresh device noise at every right-hand-side
evaluation.

The input-driven NODE encoders: ``NodeRNN`` (dh/dt = tanh(ferro([h,
x(t)])) gain + bias by rk4, then one ferro KAN cell and a linear head; its
ferro layer ops are ``ops/ferro_fused.py`` on the card) and
``OdeRnnEncoder``.  The RNN classifiers themselves are ``nn/rnn.py``.

``kanfet_mlp_node_apply(mesh=)`` runs its whole-solve data-parallel,
one block of the batch a rank (``ops/ferro_node.py:
ferro_node_solve_sharded``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from fetode_tpu_torch.nn.kan import KANConfig, kan_apply, kan_init
from fetode_tpu_torch.nn.mlp import layer_norm
from fetode_tpu_torch.nn.rnn import (
    FerroKANCellConfig,
    LogisticKANCellConfig,
    ParamTree,
    ferro_kan_cell_apply,
    ferro_kan_cell_init,
    ferro_kan_cell_state,
    ferro_layer,
    logistic_kan_cell_apply,
    logistic_kan_cell_init,
)
from fetode_tpu_torch.ops.ferro import (
    FerroConfig,
    ferro_apply,
    ferro_init,
    ferro_state_init,
)
from fetode_tpu_torch.ops.ferro_node import (
    basis_layout,
    ferro_node_solve,
    ferro_node_solve_members,
    ferro_node_solve_sharded,
    frozen_solve_noise,
    frozen_solve_noise_members,
)
from fetode_tpu_torch.ops.logistic import (
    LogisticParams,
    logistic_basis,
    logistic_init,
)
from fetode_tpu_torch.ops.interp import linear_interp
from fetode_tpu_torch.ops.logistic_node import logistic_node_solve
from fetode_tpu_torch.ops.mlp_node import mlp_node_solve
from fetode_tpu_torch.ops.node_common import use_kernel
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.solvers.fixed import integrate_final
from fetode_tpu_torch.utils.init import kaiming_uniform, normal


def _final_state(rhs, h0: torch.Tensor, spec, n_steps: int = 8
                 ) -> torch.Tensor:
    """The eager latent solve over [0, 1] -> the final state: dopri5, or
    ``n_steps`` steps of a fixed-step ``spec.solver``."""
    if spec.solver != "dopri5":
        return integrate_final(rhs, h0, 0.0, 1.0, method=spec.solver,
                               n_steps=n_steps)
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
    solver: str = "dopri5"      # or euler/rk2/rk4 -> final-state rollout
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
                          states, noise=None, generator=None,
                          noise_std=None) -> torch.Tensor:
    """Two-layer ferro field with the reference's stability armor: latent
    tanh bound, ferro, tanh, ferro, non-finite scrub, slope clamp.
    Hysteresis state is frozen during the solve.  ``noise``: the frozen
    per-solve draws of both layers in the basis shape (the adaptive solve
    cannot budget fresh noise per evaluation); else, with ``generator``,
    fresh draws at this evaluation (the fixed-step solves), scaled by
    ``noise_std`` when given."""
    s1, s2 = states
    n1, n2 = noise if noise is not None else (None, None)
    kw = dict(generator=generator, noise_std=noise_std)
    h = spec.h_bound * torch.tanh(h / spec.h_bound)
    z, _ = ferro_apply(params.fc1, s1, h, spec.fc1_cfg, noise=n1, **kw)
    z = torch.tanh(z)
    dh, _ = ferro_apply(params.fc2, s2, z, spec.fc2_cfg, noise=n2, **kw)
    dh = torch.nan_to_num(dh, nan=0.0, posinf=1e3, neginf=-1e3)
    return torch.clamp(dh, -spec.dh_clip, spec.dh_clip)


def kanfet_mlp_node_apply(params: KanFetMLPNODEParams,
                          spec: KanFetMLPNODESpec, x: torch.Tensor, *,
                          generator: torch.Generator | None = None,
                          noise_std=None, mesh=None) -> torch.Tensor:
    """x (B, T) -> logits.  One batched latent solve.

    Device noise (``spec.noise_std > 0``, or ``noise_std`` overriding
    it) comes from ``generator``.  Under dopri5 it is frozen per solve:
    ``frozen_solve_noise`` draws it once, and the kernels and the eager
    solve add the same draws.  A fixed-step solve draws it afresh at every
    right-hand-side evaluation.

    With ``mesh`` the whole-solve path (dopri5, ``solver_mode`` "pallas"
    or "auto") runs data-parallel: every rank solves its block of the
    batch (``ferro_node_solve_sharded``: B.4 on the card, its plain
    version on the CPU), the noise drawn for the global batch; encoder
    and classifier run on the whole batch, so every rank returns the
    global logits.  The eager "scan" / "while" solves ignore the mesh (a
    pure layout, as GSPMD leaves the JAX package's scan path)."""
    if noise_std is not None and mesh is not None:
        raise ValueError("an overriding noise_std with a mesh is not wired; "
                         "population runs shard the member axis instead "
                         "(train/ecg_driver.py)")
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
    noisy = spec.noise_std > 0.0 or noise_std is not None
    if noisy and generator is None:
        raise ValueError("noise_std > 0 requires a generator")
    noise = None
    if noisy and spec.solver == "dopri5":
        noise = frozen_solve_noise(generator, B, spec.fc1_cfg, spec.fc2_cfg,
                                   noise_std=noise_std, device=x.device)
    if mesh is not None and spec.solver == "dopri5" \
            and spec.gate_impl == "sigmoid" \
            and spec.solver_mode in ("pallas", "auto"):
        hT = ferro_node_solve_sharded(params.fc1, params.fc2, h0, spec,
                                      mesh, noise=noise)
        return hT @ params.cls_w.T + params.cls_b
    if kernel:
        hT = ferro_node_solve(params.fc1, params.fc2, h0, spec, noise=noise)
        return hT @ params.cls_w.T + params.cls_b
    sdt = getattr(torch, spec.state_dtype) if spec.state_dtype else x.dtype
    states = tuple(ferro_state_init((B,), cfg, device=x.device, dtype=sdt)
                   for cfg in (spec.fc1_cfg, spec.fc2_cfg))
    fresh = {}
    if noise is not None:
        noise = (basis_layout(noise[0], spec.latent_dim),
                 basis_layout(noise[1], spec.ode_hidden))
    elif noisy:
        fresh = dict(generator=generator, noise_std=noise_std)
    hT = _final_state(lambda t, h: kanfet_mlp_node_field(
        params, spec, t, h, states, noise, **fresh), h0, spec,
        n_steps=spec.n_steps)
    return hT @ params.cls_w.T + params.cls_b


def kanfet_mlp_node_apply_members(params, spec: KanFetMLPNODESpec,
                                  x: torch.Tensor, *, generators=None,
                                  noise_stds=None) -> torch.Tensor:
    """P members' ``kanfet_mlp_node_apply``: ``params`` the members'
    ``KanFetMLPNODEParams``, x (P, B, T) -> logits (P, B, classes); member
    m's device noise from ``generators[m]`` at ``noise_stds[m]`` (which
    overrides ``spec.noise_std``, as ``noise_std`` does there), so that
    member m's logits are ``kanfet_mlp_node_apply`` of its own.

    On the kernel path (``use_kernel``) the encoders and classifiers run
    per member and the latent solves go through
    ``ferro_node_solve_members``, every member's noise drawn and scaled
    up front (a std-0 member rides zero-valued noise operands, as in the
    JAX package's population).  Otherwise each member's eager solve runs
    in turn: one batched eager solve would share step control across the
    members."""
    P = len(params)
    if x.ndim != 3 or x.shape[0] != P:
        raise ValueError(f"x must be (P, B, T) for {P} members, got "
                         f"{tuple(x.shape)}")
    gens = [None] * P if generators is None else list(generators)
    stds = [None] * P if noise_stds is None else [float(s) for s in
                                                  noise_stds]
    noisy = spec.noise_std > 0.0 or noise_stds is not None
    if noise_stds is not None and spec.solver_mode == "pallas" \
            and None in gens:
        raise ValueError("an overriding noise_std on the pallas path requires "
                         "a generator for every member (std-0 members ride "
                         "zero-valued noise operands)")
    if spec.gate_impl != "sigmoid" and spec.solver_mode == "pallas":
        raise ValueError("gate_impl='tanh' requires an eager solve: the "
                         "whole-solve kernel implements the sigmoid form")
    kernel = use_kernel(spec, x) and spec.gate_impl == "sigmoid"
    if not kernel or spec.solver != "dopri5":
        return torch.stack([kanfet_mlp_node_apply(p, spec, x[m],
                                                  generator=gens[m],
                                                  noise_std=stds[m])
                            for m, p in enumerate(params)])
    if noisy and None in gens:
        raise ValueError("noise_std > 0 requires a generator for every "
                         "member")
    h0 = torch.stack([x[m] @ p.encoder_w.T + p.encoder_b
                      for m, p in enumerate(params)])
    noise = None
    if noisy:
        noise = frozen_solve_noise_members(
            gens, x.shape[1], spec.fc1_cfg, spec.fc2_cfg,
            [spec.noise_std if s is None else s for s in stds],
            device=x.device)
    hT = ferro_node_solve_members([p.fc1 for p in params],
                                  [p.fc2 for p in params], h0, spec,
                                  noise=noise)
    return torch.stack([hT[m] @ p.cls_w.T + p.cls_b
                        for m, p in enumerate(params)])


# --------------------------------------------- input-driven NODE encoders


class NodeRNNSpec(NamedTuple):
    """OneODEEncoder + ferro KAN cell + linear head (NODE_RNN):
    dh/dt = tanh(ferro([h, x(t)])) * gain + bias."""

    input_size: int = 1
    hidden_size: int = 64
    num_classes: int = 2
    num_basis: int = 10
    solver: str = "rk4"
    n_steps: int = 96
    noise_std: float = 0.0

    @property
    def basis_cfg(self) -> FerroConfig:
        return FerroConfig(self.hidden_size + self.input_size,
                           self.hidden_size, self.num_basis,
                           noise_std=self.noise_std)

    @property
    def cell_cfg(self) -> FerroKANCellConfig:
        return FerroKANCellConfig(self.hidden_size, self.hidden_size,
                                  self.num_basis, noise_std=self.noise_std)


def node_rnn_init(generator: torch.Generator, spec: NodeRNNSpec, *,
                  device=None, dtype=torch.float32) -> ParamTree:
    """Parameters named as the JAX dict: ``lift_w``, ``lift_b``, ``basis``
    (a ferro layer), ``gain``, ``bias``, ``cell``, ``head_w``, ``head_b``."""
    kw = dict(device=device, dtype=dtype)
    H = spec.hidden_size
    return ParamTree(
        lift_w=kaiming_uniform(generator, (H, spec.input_size), **kw),
        lift_b=torch.zeros(H, **kw),
        basis=ferro_init(generator, spec.basis_cfg, coef_scale=0.1, **kw),
        gain=torch.ones(H, **kw), bias=torch.zeros(H, **kw),
        cell=ferro_kan_cell_init(generator, spec.cell_cfg, **kw),
        head_w=kaiming_uniform(generator, (spec.num_classes, H), **kw),
        head_b=torch.zeros(spec.num_classes, **kw))


def node_rnn_encode(params: ParamTree, spec: NodeRNNSpec, x: torch.Tensor, *,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """x (B, T, D) -> (B, H): the JAX package's per-sample encoder over a
    batch axis.  The hysteresis state is fresh and frozen at every
    right-hand-side evaluation; device noise is drawn afresh at each one
    (per sample and per evaluation, as the reference draws it; the JAX
    package's key folding shares a draw between evaluations at one time)."""
    T = x.shape[1]
    t_grid = torch.linspace(0.0, 1.0, T, dtype=x.dtype, device=x.device)
    h0 = x[:, 0] @ params.lift_w.T + params.lift_b
    state = ferro_state_init((x.shape[0],), spec.basis_cfg, device=x.device,
                             dtype=x.dtype)

    def rhs(t, h):
        hx = torch.cat([h, linear_interp(t_grid, x, t)], dim=-1)
        phi, _ = ferro_layer(params.basis, state, hx, spec.basis_cfg,
                             generator)
        return torch.tanh(phi) * params.gain + params.bias

    return integrate_final(rhs, h0, 0.0, 1.0, method=spec.solver,
                           n_steps=spec.n_steps)


def node_rnn_apply(params: ParamTree, spec: NodeRNNSpec, x: torch.Tensor, *,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, T) or (B, T, D) -> logits: the encoder, one ferro KAN cell
    refinement from h = 0, the head.  With rk4 that is 4 n_steps + 2
    ferro layer ops."""
    if x.ndim == 2:
        x = x[..., None]
    B = x.shape[0]
    hT = node_rnn_encode(params, spec, x, generator=generator)
    kw = dict(device=x.device, dtype=x.dtype)
    h1, _ = ferro_kan_cell_apply(
        params.cell, spec.cell_cfg, hT, torch.zeros((B, spec.hidden_size),
                                                    **kw),
        ferro_kan_cell_state((B,), spec.cell_cfg, **kw), generator=generator)
    return h1 @ params.head_w.T + params.head_b


class OdeRnnEncoderSpec(NamedTuple):
    """ODE-integrated RNN encoder: dh/dt = alpha (cell(lift(x(t)), h) - h)."""

    input_size: int = 1
    hidden_size: int = 64
    num_basis: int = 10
    alpha: float = 10.0
    solver: str = "rk4"
    n_steps: int = 96

    @property
    def cell_cfg(self) -> LogisticKANCellConfig:
        return LogisticKANCellConfig(self.hidden_size, self.hidden_size,
                                     self.num_basis)


def ode_rnn_encoder_init(generator: torch.Generator, spec: OdeRnnEncoderSpec,
                         *, device=None, dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    H = spec.hidden_size
    return ParamTree(
        lift_w=kaiming_uniform(generator, (H, spec.input_size), **kw),
        lift_b=torch.zeros(H, **kw),
        h0_w=kaiming_uniform(generator, (H, spec.input_size), **kw),
        h0_b=torch.zeros(H, **kw),
        cell=logistic_kan_cell_init(generator, spec.cell_cfg, **kw))


def ode_rnn_encode(params: ParamTree, spec: OdeRnnEncoderSpec,
                   x_seq: torch.Tensor) -> torch.Tensor:
    """x_seq (..., T, D) -> (..., H): relaxation toward the cell's discrete
    update (the JAX package's single-sample encoder, with batch axes)."""
    T = x_seq.shape[-2]
    t_grid = torch.linspace(0.0, 1.0, T, dtype=x_seq.dtype,
                            device=x_seq.device)
    h0 = x_seq[..., 0, :] @ params.h0_w.T + params.h0_b

    def rhs(t, h):
        z_t = linear_interp(t_grid, x_seq, t) @ params.lift_w.T \
            + params.lift_b
        h_next = logistic_kan_cell_apply(params.cell, spec.cell_cfg, z_t, h)
        return spec.alpha * (h_next - h)

    return integrate_final(rhs, h0, 0.0, 1.0, method=spec.solver,
                           n_steps=spec.n_steps)
