"""Conditional DDPM forecasting over full future sequences (B, Ly, D)
(counterpart of ``fetode_tpu/models/cond_diffusion.py``).

The five denoiser variants are one spec over two axes:

| name                 | CondDenoiserSpec(encoder, net) |
|----------------------|--------------------------------|
| ``mlp``              | ('conv', 'mlp')                |
| ``kan``              | ('conv', 'kan')                |
| ``kan_fet_linear_ode`` | ('conv', 'kanfet')           |
| ``kan_node``         | ('node', 'kan')                |
| ``kan_fet_all_node`` | ('node', 'kanfet')             |

The past encoder is a conv1d stack (``ConvEncoder``) or a NODE
(``NodeEncoder``: dz/dt = MLP([LN(z), x(t)]) with x(t) the linearly
interpolated projected past).  The denoiser net acts on ``[y_flat, cond,
sin-emb(t)]``.  Parameters are ``nn.Module``s named as the JAX package's
dicts (``encoder``, ``net``), so ``convert.cond_diffusion_params_from_numpy``
loads a JAX tree.

Node-encoder solve dispatch (``solver_mode``, through ``ops/node_common.py:
use_kernel``): ``"pallas"``, and ``"auto"`` on a CUDA tensor, take the
whole-solve CUDA kernels of ``ops/node_enc.py`` (its solve over the output
times [0, 1]); ``"pallas"`` raises for a CPU tensor; ``"auto"`` on the CPU,
``"scan"`` and ``"while"`` take the eager dopri5 over ``linspace(0, 1,
n_eval)``, as the JAX package's XLA path does.  The JAX package takes its
kernel only under ``"pallas"``; the port follows the rule that a CUDA
tensor goes to the kernel by default.  A fixed-step ``solver`` takes
``odeint_fixed`` over the same times in every mode, as the JAX package
does.

The samplers take their draws from a ``torch.Generator`` or explicitly
(``y0``, ``noise``), so a test can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fetode_tpu_torch.nn.diffusion import (
    DiffusionSchedule,
    _draws,
    p_sample_loop,
    sinusoidal_emb,
)
from fetode_tpu_torch.nn.kan import (
    KANConfig,
    KANLinear,
    _scaled_spline_weight,
    kan_apply,
    kan_init,
    kan_linear_apply,
    kan_state_init,
    kanfet_config,
)
from fetode_tpu_torch.nn.mlp import MLPConfig, layer_norm, mlp_apply, mlp_init
from fetode_tpu_torch.ops.spline import spline_matmul_fused
from fetode_tpu_torch.ops.interp import linear_interp
from fetode_tpu_torch.ops.node_common import use_kernel
from fetode_tpu_torch.ops.node_enc import node_enc_solve
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.solvers.fixed import odeint_fixed
from fetode_tpu_torch.utils.init import kaiming_uniform

# ------------------------------------------------------- past encoders


class ConvEncoderCfg(NamedTuple):
    d_in: int
    hidden: int = 128
    out_dim: int = 128
    kernel: int = 5


class ConvEncoder(nn.Module):
    """conv1_w (hidden, d_in, k), conv1_b, conv2_w (hidden, hidden, k),
    conv2_b, proj_w (out_dim, hidden), proj_b: the JAX dict's keys."""

    def __init__(self, cfg: ConvEncoderCfg, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, k = cfg.hidden, cfg.kernel
        self.conv1_w = nn.Parameter(torch.empty(h, cfg.d_in, k, **kw))
        self.conv1_b = nn.Parameter(torch.zeros(h, **kw))
        self.conv2_w = nn.Parameter(torch.empty(h, h, k, **kw))
        self.conv2_b = nn.Parameter(torch.zeros(h, **kw))
        self.proj_w = nn.Parameter(torch.empty(cfg.out_dim, h, **kw))
        self.proj_b = nn.Parameter(torch.zeros(cfg.out_dim, **kw))


def conv_encoder_init(generator: torch.Generator, cfg: ConvEncoderCfg, *,
                      device=None, dtype=torch.float32) -> ConvEncoder:
    enc = ConvEncoder(cfg, device=device, dtype=dtype)
    kw = dict(device=device, dtype=dtype)
    with torch.no_grad():
        enc.conv1_w.copy_(kaiming_uniform(
            generator, tuple(enc.conv1_w.shape), fan_in=cfg.d_in * cfg.kernel,
            **kw))
        enc.conv2_w.copy_(kaiming_uniform(
            generator, tuple(enc.conv2_w.shape),
            fan_in=cfg.hidden * cfg.kernel, **kw))
        enc.proj_w.copy_(kaiming_uniform(generator, tuple(enc.proj_w.shape),
                                         **kw))
    return enc


def conv_encoder_apply(params: ConvEncoder, cfg: ConvEncoderCfg,
                       past: torch.Tensor) -> torch.Tensor:
    """past (B, L, D) -> (B, out_dim): conv1d(k=5) SiLU x2, mean-pool,
    proj."""
    x = past.transpose(1, 2)                                   # (B, D, L)
    pad = cfg.kernel // 2
    h = F.silu(F.conv1d(x, params.conv1_w, params.conv1_b, padding=pad))
    h = F.silu(F.conv1d(h, params.conv2_w, params.conv2_b, padding=pad))
    return h.mean(-1) @ params.proj_w.T + params.proj_b


class NodeEncoderCfg(NamedTuple):
    d_in: int
    cond_dim: int = 128
    x_proj_dim: int = 128
    ode_hidden: int = 128
    n_eval: int = 5
    solver: str = "dopri5"
    rtol: float = 1e-3
    atol: float = 1e-4
    max_steps: int = 24
    solver_mode: str = "auto"   # see the module docstring

    @property
    def field_mlp(self) -> MLPConfig:
        return MLPConfig((self.cond_dim + self.x_proj_dim, self.ode_hidden,
                          self.ode_hidden, self.cond_dim), activation="silu")


class NodeEncoder(nn.Module):
    """x_proj_w (P, d_in), x_proj_b, ``field`` (the (C+P, H, H, C) SiLU
    MLP), ln_scale, ln_bias (C), z0_w (C, P), z0_b: the JAX dict's keys."""

    def __init__(self, cfg: NodeEncoderCfg, field: nn.ModuleList, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        C, P = cfg.cond_dim, cfg.x_proj_dim
        self.x_proj_w = nn.Parameter(torch.empty(P, cfg.d_in, **kw))
        self.x_proj_b = nn.Parameter(torch.zeros(P, **kw))
        self.field = field
        self.ln_scale = nn.Parameter(torch.ones(C, **kw))
        self.ln_bias = nn.Parameter(torch.zeros(C, **kw))
        self.z0_w = nn.Parameter(torch.empty(C, P, **kw))
        self.z0_b = nn.Parameter(torch.zeros(C, **kw))


def node_encoder_init(generator: torch.Generator, cfg: NodeEncoderCfg, *,
                      device=None, dtype=torch.float32) -> NodeEncoder:
    kw = dict(device=device, dtype=dtype)
    x_proj_w = kaiming_uniform(generator, (cfg.x_proj_dim, cfg.d_in), **kw)
    enc = NodeEncoder(cfg, mlp_init(generator, cfg.field_mlp, **kw), **kw)
    with torch.no_grad():
        enc.x_proj_w.copy_(x_proj_w)
        enc.z0_w.copy_(kaiming_uniform(
            generator, (cfg.cond_dim, cfg.x_proj_dim), **kw))
    return enc


def node_encoder_apply(params: NodeEncoder, cfg: NodeEncoderCfg,
                       past: torch.Tensor) -> torch.Tensor:
    """past (B, L, D) -> (B, cond_dim) via dz/dt = f(LN(z), x(t))."""
    x_seq = past @ params.x_proj_w.T + params.x_proj_b         # (B, L, P)
    z0 = x_seq[:, 0] @ params.z0_w.T + params.z0_b
    if use_kernel(cfg, past):
        return node_enc_solve(params, cfg, z0, x_seq)
    L = x_seq.shape[1]
    t_grid = torch.linspace(0.0, 1.0, L, dtype=past.dtype,
                            device=past.device)

    def rhs(t, z):
        x_t = linear_interp(t_grid, x_seq, t)                  # (B, P)
        zn = layer_norm(z, params.ln_scale, params.ln_bias)
        return mlp_apply(params.field, cfg.field_mlp,
                         torch.cat([zn, x_t], dim=-1))

    ts = torch.linspace(0.0, 1.0, cfg.n_eval, dtype=past.dtype,
                        device=past.device)
    if cfg.solver != "dopri5":
        return odeint_fixed(rhs, z0, ts, method=cfg.solver)[-1]
    return odeint_dopri5(rhs, z0, ts, rtol=cfg.rtol, atol=cfg.atol,
                         max_steps=cfg.max_steps, mode=cfg.solver_mode)[-1]


# ------------------------------------------------------------ denoisers


class CondDenoiserSpec(NamedTuple):
    d_in: int
    pred_len: int
    seq_len: int = 96
    cond_dim: int = 128
    time_dim: int = 128
    hidden: int = 256
    encoder: str = "conv"     # 'conv' | 'node'
    net: str = "mlp"          # 'mlp' | 'kan' | 'kanfet'
    ferro_num_basis: int = 4
    solver_mode: str = "auto"   # the node encoder's; see the docstring

    @property
    def conv_cfg(self) -> ConvEncoderCfg:
        return ConvEncoderCfg(self.d_in, 128, self.cond_dim)

    @property
    def node_cfg(self) -> NodeEncoderCfg:
        return NodeEncoderCfg(self.d_in, self.cond_dim,
                              solver_mode=self.solver_mode)

    @property
    def in_dim(self) -> int:
        return self.pred_len * self.d_in + self.cond_dim + self.time_dim

    @property
    def out_dim(self) -> int:
        return self.pred_len * self.d_in

    @property
    def net_cfg(self):
        sizes = [self.in_dim, self.hidden, self.hidden, self.out_dim]
        if self.net == "kan":
            return KANConfig.make(sizes)
        if self.net == "kanfet":
            return kanfet_config(sizes, ferro_num_basis=self.ferro_num_basis)
        return MLPConfig(tuple(sizes), activation="silu")


def _check_spec(spec: CondDenoiserSpec) -> None:
    if spec.encoder not in ("conv", "node"):
        raise ValueError(f"unknown encoder {spec.encoder!r}: expected 'conv' "
                         "or 'node'")
    if spec.net not in ("mlp", "kan", "kanfet"):
        raise ValueError(f"unknown net {spec.net!r}: expected 'mlp', 'kan' "
                         "or 'kanfet'")


def cond_denoiser_init(generator: torch.Generator, spec: CondDenoiserSpec, *,
                       device=None, dtype=torch.float32) -> nn.ModuleDict:
    _check_spec(spec)
    kw = dict(device=device, dtype=dtype)
    enc = (conv_encoder_init(generator, spec.conv_cfg, **kw)
           if spec.encoder == "conv"
           else node_encoder_init(generator, spec.node_cfg, **kw))
    net = (mlp_init(generator, spec.net_cfg, **kw) if spec.net == "mlp"
           else kan_init(generator, spec.net_cfg, **kw))
    return nn.ModuleDict({"encoder": enc, "net": net})


def cond_denoiser_encode(params: nn.ModuleDict, spec: CondDenoiserSpec,
                         past: torch.Tensor) -> torch.Tensor:
    """The past conditioning (B, cond_dim); constant across diffusion
    steps, so the samplers hoist it out of the reverse chain."""
    _check_spec(spec)
    if spec.encoder == "conv":
        return conv_encoder_apply(params["encoder"], spec.conv_cfg, past)
    return node_encoder_apply(params["encoder"], spec.node_cfg, past)


def cond_denoiser_eps(params: nn.ModuleDict, spec: CondDenoiserSpec,
                      x_t: torch.Tensor, cond: torch.Tensor,
                      t_idx: torch.Tensor) -> torch.Tensor:
    """eps_hat (B, Ly, D) from the noisy future and the conditioning.  The
    KANFET net starts every call from a fresh hysteresis state."""
    B = x_t.shape[0]
    temb = sinusoidal_emb(t_idx, spec.time_dim).to(x_t.dtype)
    h = torch.cat([x_t.reshape(B, -1), cond, temb], dim=-1)
    if spec.net == "mlp":
        eps = mlp_apply(params["net"], spec.net_cfg, h)
    else:
        state = (kan_state_init((B,), spec.net_cfg, device=x_t.device,
                                dtype=x_t.dtype)
                 if spec.net == "kanfet" else None)
        eps, _ = kan_apply(params["net"], h, state)
    return eps.reshape(B, spec.pred_len, spec.d_in)


def cond_denoiser_apply(params: nn.ModuleDict, spec: CondDenoiserSpec,
                        x_t: torch.Tensor, past: torch.Tensor,
                        t_idx: torch.Tensor) -> torch.Tensor:
    """eps_hat (B, Ly, D) from the noisy future, the past and the step."""
    cond = cond_denoiser_encode(params, spec, past)
    return cond_denoiser_eps(params, spec, x_t, cond, t_idx)


def _chain(spec: CondDenoiserSpec, sched: DiffusionSchedule, cond, first,
           rest, generator, y0, noise) -> torch.Tensor:
    """The reverse chain of a hoisted denoiser: ``first(y, i)`` is the first
    layer's output of loop step i, ``rest(h)`` the net after it."""
    B, P = cond.shape[0], spec.pred_len * spec.d_in
    y, noise = _draws(generator, (B, spec.pred_len, spec.d_in), sched.T,
                      cond.device, cond.dtype, y0, noise)
    y = y.reshape(B, P)
    for i, t in enumerate(range(sched.T - 1, -1, -1)):
        eps_hat = rest(first(y, i))
        mu = sched.sqrt_recip_alphas[t] * (
            y - sched.betas[t] * eps_hat / sched.sqrt_one_minus_alphas_bar[t])
        scale = 0.0 if t == 0 else torch.sqrt(torch.clamp(
            sched.posterior_variance[t], min=1e-20))
        y = mu + scale * noise[i].reshape(B, P)
    return y.reshape(B, spec.pred_len, spec.d_in)


def _t_rev_emb(spec: CondDenoiserSpec, sched: DiffusionSchedule,
               cond: torch.Tensor) -> torch.Tensor:
    """Every step's sinusoidal embedding in loop order (t = T-1 first)."""
    t_rev = torch.arange(sched.T - 1, -1, -1, device=cond.device)
    return sinusoidal_emb(t_rev, spec.time_dim).to(cond.dtype)


def cond_denoiser_mlp_sample_loop(params: nn.ModuleDict,
                                  spec: CondDenoiserSpec,
                                  sched: DiffusionSchedule,
                                  cond: torch.Tensor,
                                  generator: Optional[torch.Generator] = None,
                                  *, y0: Optional[torch.Tensor] = None,
                                  noise: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The full reverse chain of the ``net='mlp'`` denoiser with the first
    layer's ``cond`` term computed once and every step's t-embedding term
    in one product up front; the same math and draws as ``p_sample_loop``
    over ``cond_denoiser_eps``.  ``y0`` (B, Ly, D) and ``noise`` (T, B,
    Ly, D), ``noise[i]`` the draw of loop step i, else drawn from
    ``generator`` in that order."""
    if spec.net != "mlp":
        raise ValueError("cond_denoiser_mlp_sample_loop requires net='mlp'")
    P, C = spec.pred_len * spec.d_in, spec.cond_dim
    (l1, l2, l3) = params["net"]
    W1y, W1c, W1t = l1.w[:, :P], l1.w[:, P:P + C], l1.w[:, P + C:]
    cond_h = cond @ W1c.T + l1.b                            # (B, H) once
    temb_h = _t_rev_emb(spec, sched, cond) @ W1t.T          # (T, H) once

    def rest(h):
        return F.silu(F.silu(h) @ l2.w.T + l2.b) @ l3.w.T + l3.b
    return _chain(spec, sched, cond,
                  lambda y, i: y @ W1y.T + cond_h + temb_h[i], rest,
                  generator, y0, noise)


def _kan_partial(layer: KANLinear, x: torch.Tensor, sl: slice
                 ) -> torch.Tensor:
    """One KANLinear layer restricted to the input dims in ``sl``.  The
    layer is additive over its inputs (silu base and B-spline terms), so
    the full layer is the sum of partial applications over a partition
    of them.  Plain layers only (no logistic or ferro branch).  The spline
    term takes B.12 (``ops/spline.py``) as ``kan_linear_apply`` does, on
    the column slice of the scaled weight as it lies."""
    base = F.silu(x) @ layer.base_weight[:, sl].T
    return base + spline_matmul_fused(x, layer.grid[sl],
                                      _scaled_spline_weight(layer)[:, sl, :],
                                      layer.cfg.spline_order)


def cond_denoiser_kan_sample_loop(params: nn.ModuleDict,
                                  spec: CondDenoiserSpec,
                                  sched: DiffusionSchedule,
                                  cond: torch.Tensor,
                                  generator: Optional[torch.Generator] = None,
                                  *, y0: Optional[torch.Tensor] = None,
                                  noise: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The full reverse chain of the ``net='kan'`` denoiser: through the
    first KAN layer's additivity over its inputs (``_kan_partial``) the
    cond dims' contribution is computed once and the t-embedding dims'
    for all T steps up front, so a step's first layer acts on the P
    ``y_flat`` dims alone.  The same math (up to float reassociation) and
    draws as ``p_sample_loop`` over ``cond_denoiser_eps``."""
    if spec.net != "kan":
        raise ValueError("cond_denoiser_kan_sample_loop requires net='kan'")
    P, C, E = spec.pred_len * spec.d_in, spec.cond_dim, spec.time_dim
    first, *layers = params["net"].layers
    cond_h = _kan_partial(first, cond, slice(P, P + C))        # (B, H) once
    temb_h = _kan_partial(first, _t_rev_emb(spec, sched, cond),
                          slice(P + C, P + C + E))             # (T, H) once

    def rest(h):
        for layer in layers:
            h = kan_linear_apply(layer, h)[0]
        return h
    return _chain(spec, sched, cond,
                  lambda y, i: _kan_partial(first, y, slice(0, P)) + cond_h
                  + temb_h[i], rest, generator, y0, noise)


def cond_denoiser_sample_loop(params: nn.ModuleDict, spec: CondDenoiserSpec,
                              sched: DiffusionSchedule, cond: torch.Tensor,
                              generator: Optional[torch.Generator] = None, *,
                              y0: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The reverse chain (B, Ly, D) on a precomputed condition: the hoisted
    loop of the ``mlp`` and ``kan`` nets, the generic ``p_sample_loop``
    for the KANFET net (its ferro branch is stateful)."""
    if spec.net == "mlp":
        loop = cond_denoiser_mlp_sample_loop
    elif spec.net == "kan":
        loop = cond_denoiser_kan_sample_loop
    else:
        return p_sample_loop(
            sched, lambda y, t, c: cond_denoiser_eps(params, spec, y, c, t),
            (cond.shape[0], spec.pred_len, spec.d_in), cond, generator,
            device=cond.device, dtype=cond.dtype, y0=y0, noise=noise)
    return loop(params, spec, sched, cond, generator, y0=y0, noise=noise)


DENOISER_VARIANTS = {
    # name -> (encoder, net)
    "mlp": ("conv", "mlp"),
    "kan": ("conv", "kan"),
    "kan_fet_linear_ode": ("conv", "kanfet"),
    "kan_node": ("node", "kan"),
    "kan_fet_all_node": ("node", "kanfet"),
}


def make_denoiser_spec(name: str, d_in: int, pred_len: int, seq_len: int = 96,
                       **kw) -> CondDenoiserSpec:
    if name not in DENOISER_VARIANTS:
        raise ValueError(f"unknown denoiser {name!r}; expected one of "
                         f"{sorted(DENOISER_VARIANTS)}")
    enc, net = DENOISER_VARIANTS[name]
    return CondDenoiserSpec(d_in=d_in, pred_len=pred_len, seq_len=seq_len,
                            encoder=enc, net=net, **kw)
