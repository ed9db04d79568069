"""KAN layers: spline + base branch, optional logistic and ferroelectric
branches ("KANFET").

Counterpart of ``fetode_tpu/nn/kan.py``.  A layer is an ``nn.Module``
(``KANLinear``) with the JAX package's parameter names: ``base_weight``,
``spline_weight``, ``spline_scaler``, the knot ``grid`` as a buffer, a
``ferro`` submodule (``k``, ``ec``, ``ps``, ``bias``, ``coef``) and a
``logistic`` submodule when those branches are on.  A stack is ``KAN``.
Parameters initialised by the JAX package load one to one through
``fetode_tpu_torch.convert``.

Hysteresis state stays explicit (``kan_state_init``), passed in and
returned by ``kan_linear_apply`` / ``kan_apply``.  ``kan_regularization``
is the training penalty; ``kan_update_grid`` refits the knot grids to
the inputs a stack sees.  It writes the new grids and spline weights
into the layers' own tensors, so an optimiser keeps holding the same
``Parameter`` objects and their Adam moments, as the JAX package's
optimiser state stays valid across its pure refit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fetode_tpu_torch.ops.bsplines import (
    bspline_basis,
    curve2coeff,
    make_grid,
    refine_grid,
)
from fetode_tpu_torch.ops.ferro import (
    FerroConfig,
    FerroParams,
    ferro_basis,
    ferro_init,
    ferro_state_init,
)
from fetode_tpu_torch.ops.logistic import LogisticParams, logistic_basis
from fetode_tpu_torch.ops.spline import (
    spline_matmul_fused,
    spline_matmul_reference,
)
from fetode_tpu_torch.utils.init import kaiming_uniform, normal, uniform


class KANLinearConfig(NamedTuple):
    """Static layer hyper-parameters (field names as in the JAX package)."""

    in_features: int
    out_features: int
    grid_size: int = 5
    spline_order: int = 3
    scale_noise: float = 0.1
    scale_base: float = 1.0
    scale_spline: float = 1.0
    standalone_spline_scaler: bool = True
    grid_eps: float = 0.02
    grid_range: Tuple[float, float] = (-1.0, 1.0)
    logistic_num_basis: int = 0
    scale_logistic: float = 1.0
    standalone_logistic_scaler: bool = True
    ferro_num_basis: int = 0
    ferro_gate_slope: float = 10.0
    ferro_alpha: float = 0.8
    ferro_noise_std: float = 0.0
    ferro_coef_scale: float = 0.1
    # Hysteresis-state dtype override ("" = follow the input dtype).
    state_dtype: str = ""

    @property
    def n_coeff(self) -> int:
        return self.grid_size + self.spline_order

    @property
    def ferro_cfg(self) -> FerroConfig:
        return FerroConfig(in_dim=self.in_features, out_dim=self.out_features,
                           num_basis=self.ferro_num_basis,
                           gate_slope=self.ferro_gate_slope,
                           alpha=self.ferro_alpha,
                           noise_std=self.ferro_noise_std)


class KANConfig(NamedTuple):
    """A stack of KAN layers built from ``layers_hidden`` pairs."""

    layers: Tuple[KANLinearConfig, ...]

    @classmethod
    def make(cls, layers_hidden: Sequence[int], grid_size: int = 5,
             spline_order: int = 3, **layer_kw) -> "KANConfig":
        return cls(layers=tuple(
            KANLinearConfig(i, o, grid_size=grid_size,
                            spline_order=spline_order, **layer_kw)
            for i, o in zip(layers_hidden, layers_hidden[1:])))


class _Logistic(nn.Module):
    """The optional logistic branch: basis ``a``, ``b``, its ``weight`` and
    (standalone) ``scaler``."""

    def __init__(self, cfg: KANLinearConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = cfg.logistic_num_basis
        self.a = nn.Parameter(torch.empty(cfg.in_features, n, **kw))
        self.b = nn.Parameter(torch.empty(cfg.in_features, n, **kw))
        self.weight = nn.Parameter(
            torch.empty(cfg.out_features, cfg.in_features * n, **kw))
        if cfg.standalone_logistic_scaler:
            self.scaler = nn.Parameter(torch.empty(cfg.out_features, **kw))


class KANLinear(nn.Module):
    """One KAN layer.  The constructor allocates the parameters without
    values (a skeleton for ``load_state_dict``); ``kan_linear_init`` fills
    them."""

    def __init__(self, cfg: KANLinearConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.register_buffer("grid", make_grid(
            cfg.in_features, cfg.grid_size, cfg.spline_order,
            cfg.grid_range, **kw))
        self.base_weight = nn.Parameter(
            torch.empty(cfg.out_features, cfg.in_features, **kw))
        self.spline_weight = nn.Parameter(
            torch.empty(cfg.out_features, cfg.in_features, cfg.n_coeff, **kw))
        if cfg.standalone_spline_scaler:
            self.spline_scaler = nn.Parameter(
                torch.empty(cfg.out_features, cfg.in_features, **kw))
        if cfg.logistic_num_basis > 0:
            self.logistic = _Logistic(cfg, **kw)
        if cfg.ferro_num_basis > 0:
            self.ferro = FerroParams(cfg.ferro_cfg, **kw)

    def forward(self, x, state=None, *, generator=None):
        return kan_linear_apply(self, x, state, generator=generator)


def kan_linear_init(generator: torch.Generator, cfg: KANLinearConfig, *,
                    device=None, dtype=torch.float32) -> KANLinear:
    """Initialise one layer: kaiming-uniform base weight, spline weights
    fit to small uniform noise at the interior knots by least squares,
    kaiming spline scaler, ferro parameters in their physical ranges."""
    layer = KANLinear(cfg, device=device, dtype=dtype)
    kw = dict(device=device, dtype=dtype)
    with torch.no_grad():
        layer.base_weight.copy_(kaiming_uniform(
            generator, (cfg.out_features, cfg.in_features),
            a=math.sqrt(5) * cfg.scale_base, **kw))
        grid = layer.grid
        interior = grid.T[cfg.spline_order:-cfg.spline_order]   # (G+1, in)
        noise = (uniform(generator, (cfg.grid_size + 1, cfg.in_features,
                                     cfg.out_features), 0.0, 1.0, **kw)
                 - 0.5) * cfg.scale_noise / cfg.grid_size
        coeff = curve2coeff(interior, noise, grid, cfg.spline_order)
        if not cfg.standalone_spline_scaler:
            coeff = coeff * cfg.scale_spline
        layer.spline_weight.copy_(coeff)
        if cfg.standalone_spline_scaler:
            layer.spline_scaler.copy_(kaiming_uniform(
                generator, (cfg.out_features, cfg.in_features),
                a=math.sqrt(5) * cfg.scale_spline, **kw))
        if cfg.logistic_num_basis > 0:
            lg = layer.logistic
            shape = (cfg.in_features, cfg.logistic_num_basis)
            lg.a.copy_(normal(generator, shape, **kw))
            lg.b.copy_(normal(generator, shape, **kw))
            lg.weight.copy_(kaiming_uniform(
                generator, tuple(lg.weight.shape),
                a=math.sqrt(5) * cfg.scale_logistic, **kw))
            if cfg.standalone_logistic_scaler:
                lg.scaler.fill_(1.0)
    if cfg.ferro_num_basis > 0:
        layer.ferro = ferro_init(generator, cfg.ferro_cfg,
                                 coef_scale=cfg.ferro_coef_scale, **kw)
    return layer


def _scaled_spline_weight(layer: KANLinear) -> torch.Tensor:
    w = layer.spline_weight
    if layer.cfg.standalone_spline_scaler:
        w = w * layer.spline_scaler[..., None]
    return w


def kan_linear_apply(layer: KANLinear, x: torch.Tensor, state=None, *,
                     generator: torch.Generator | None = None,
                     plain: bool = False):
    """Forward pass of one layer.

    The spline term goes through ``ops/spline.py: spline_matmul_fused``
    (the B.12 kernel for CUDA float32 tensors, its plain version on the
    CPU); ``plain=True`` takes the plain version on every device, for the
    plain twins the other kernels are held against and for float64.

    Args:
      x: (..., in_features)
      state: ferro hysteresis state (required iff the ferro branch is on).

    Returns:
      ``(y, new_state)`` — new_state is None for branch-free layers.
    """
    cfg = layer.cfg
    lead = x.shape[:-1]
    x2 = x.reshape(-1, cfg.in_features)

    y = F.silu(x2) @ layer.base_weight.T
    spline = spline_matmul_reference if plain else spline_matmul_fused
    y = y + spline(x2, layer.grid, _scaled_spline_weight(layer),
                   cfg.spline_order)

    if cfg.logistic_num_basis > 0:
        lg = layer.logistic
        phi = logistic_basis(LogisticParams(lg.a, lg.b), x2)
        w = lg.weight * cfg.scale_logistic
        if cfg.standalone_logistic_scaler:
            w = w * lg.scaler[:, None]
        y = y + phi.reshape(x2.shape[0], -1) @ w.T

    new_state = None
    if cfg.ferro_num_basis > 0:
        if state is None:
            raise ValueError("ferro branch enabled: pass a FerroState "
                             "(use kan_linear_state / kan_state_init)")
        n = x2.shape[0]
        fstate = type(state)(*(s.reshape((n,) + s.shape[len(lead):])
                               for s in state))
        fb, new_fstate = ferro_basis(layer.ferro, fstate, x2, cfg.ferro_cfg,
                                     generator=generator)
        y = y + torch.einsum("biok,iok->bo", fb, layer.ferro.coef)
        new_state = type(new_fstate)(*(s.reshape(lead + s.shape[1:])
                                       for s in new_fstate))

    return y.reshape(lead + (cfg.out_features,)), new_state


def kan_linear_state(batch_shape, cfg: KANLinearConfig, *, device=None,
                     dtype=torch.float32):
    if cfg.ferro_num_basis == 0:
        return None
    if cfg.state_dtype:
        dtype = getattr(torch, cfg.state_dtype)
    return ferro_state_init(batch_shape, cfg.ferro_cfg, device=device,
                            dtype=dtype)


@torch.no_grad()
def kan_linear_update_grid(layer: KANLinear, x: torch.Tensor,
                           margin: float = 0.01) -> KANLinear:
    """Adaptive grid refit of one layer (``update_grid``,
    ``efficientkan.py:184-221``): move the knots toward the empirical
    distribution of ``x`` (``refine_grid``) and refit the spline
    coefficients so that the layer computes the same function.  The new
    grid and spline weight are copied into the layer's own buffer and
    ``Parameter`` (shapes unchanged), so optimiser state stays attached.
    Returns the layer."""
    cfg = layer.cfg
    x2 = x.reshape(-1, cfg.in_features).to(layer.grid.dtype)
    bases = bspline_basis(x2, layer.grid, cfg.spline_order)     # (B, in, C)
    sw = _scaled_spline_weight(layer)                           # (out, in, C)
    y_unreduced = torch.einsum("bic,oic->bio", bases, sw)       # (B, in, out)
    new_grid = refine_grid(x2, cfg.grid_size, cfg.spline_order,
                           cfg.grid_eps, margin)
    new_coeff = curve2coeff(x2, y_unreduced, new_grid, cfg.spline_order)
    # Fold the fit back into the raw weight so the scaled value is kept.
    if cfg.standalone_spline_scaler:
        scaler = layer.spline_scaler[..., None]
        new_coeff = new_coeff / torch.where(scaler == 0, 1.0, scaler)
    layer.grid.copy_(new_grid)
    layer.spline_weight.copy_(new_coeff)
    return layer


def kan_linear_regularization(layer: KANLinear,
                              regularize_activation: float = 1.0,
                              regularize_entropy: float = 1.0,
                              regularize_logistic_l1: float = 0.0):
    """L1 + entropy regulariser on spline weights
    (``efficientkan.py:223-237``)."""
    l1 = layer.spline_weight.abs().mean(-1)
    act = l1.sum()
    p = l1 / (act + 1e-12)
    ent = -torch.sum(p * torch.log(p + 1e-12))
    reg = regularize_activation * act + regularize_entropy * ent
    if layer.cfg.logistic_num_basis > 0 and regularize_logistic_l1 != 0.0:
        reg = reg + regularize_logistic_l1 * layer.logistic.weight.abs().mean()
    return reg


# --------------------------------------------------------------------- stacks


class KAN(nn.Module):
    """A stack of ``KANLinear`` layers (``layers``)."""

    def __init__(self, cfg: KANConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            KANLinear(c, device=device, dtype=dtype) for c in cfg.layers)

    def forward(self, x, state=None, *, generator=None):
        return kan_apply(self, x, state, generator=generator)


def kan_init(generator: torch.Generator, cfg: KANConfig, *, device=None,
             dtype=torch.float32) -> KAN:
    kan = KAN(cfg, device=device, dtype=dtype)
    kan.layers = nn.ModuleList(
        kan_linear_init(generator, c, device=device, dtype=dtype)
        for c in cfg.layers)
    return kan


def kan_state_init(batch_shape, cfg: KANConfig, *, device=None,
                   dtype=torch.float32) -> tuple:
    return tuple(kan_linear_state(batch_shape, c, device=device, dtype=dtype)
                 for c in cfg.layers)


def kan_apply(params: KAN, x: torch.Tensor, state=None, *,
              generator: torch.Generator | None = None, plain: bool = False):
    """Apply the stack; threads per-layer hysteresis state when present.
    ``plain`` as for ``kan_linear_apply``.

    Returns ``(y, new_state)`` (new_state a tuple aligned with layers).
    """
    if state is None:
        state = (None,) * len(params.layers)
    new_states = []
    for layer, s in zip(params.layers, state):
        x, s1 = kan_linear_apply(layer, x, s, generator=generator,
                                 plain=plain)
        new_states.append(s1)
    return x, tuple(new_states)


def kan_regularization(params: KAN, **kw):
    """The sum of every layer's ``kan_linear_regularization``."""
    return sum(kan_linear_regularization(layer, **kw)
               for layer in params.layers)


@torch.no_grad()
def kan_update_grid(params: KAN, x: torch.Tensor,
                    margin: float = 0.01) -> KAN:
    """Stack-level adaptive grid refit (``update_grid`` over the whole
    KAN): each layer refits its knots to the empirical distribution of
    its own input, ``x`` propagated through the layers already refit
    from the fresh hysteresis state, keeping the function the stack
    computes.  In place (``kan_linear_update_grid``): the optimiser's
    ``Parameter`` objects and moments stay as they are.  Returns
    ``params``."""
    state = kan_state_init(x.shape[:-1], params.cfg, device=x.device,
                           dtype=x.dtype)
    for layer, s in zip(params.layers, state):
        kan_linear_update_grid(layer, x, margin)
        x, _ = kan_linear_apply(layer, x, s)
    return params


# ---------------------------------------------------------------------- KANFET


def kanfet_config(layers_hidden: Sequence[int], grid_size: int = 5,
                  spline_order: int = 3, ferro_num_basis: int = 8,
                  noise_std: float = 0.0, **kw) -> KANConfig:
    """A KAN whose every layer carries the ferroelectric hysteresis branch
    (``KANFET(layers_hidden=[2,10,2], grid_size=5)``)."""
    return KANConfig.make(layers_hidden, grid_size=grid_size,
                          spline_order=spline_order,
                          ferro_num_basis=ferro_num_basis,
                          ferro_noise_std=noise_std, **kw)



kanfet_init = kan_init
kanfet_apply = kan_apply
kanfet_state_init = kan_state_init
