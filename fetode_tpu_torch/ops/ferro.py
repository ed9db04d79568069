"""Ferroelectric-hysteresis basis: the core analog-device primitive.

Counterpart of ``fetode_tpu/ops/ferro.py``.  The polarisation response

    P = Ps * tanh(k * (E + Ec * s)) + bias,   s in [-1, +1]

with a smooth up/down branch state machine for ``s`` (sigmoid gates of
slope ``gate_slope``, an EMA branch update of weight ``alpha``).

In the port the learnable device parameters are an ``nn.Module``
(``FerroParams``, the ``ferro`` submodule of a KAN layer), while the
hysteresis state stays an explicit ``FerroState`` passed in and returned,
as in the JAX package.  Device noise draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from fetode_tpu_torch.utils.init import normal, uniform


class FerroConfig(NamedTuple):
    """Static hyper-parameters of the basis."""

    in_dim: int
    out_dim: int
    num_basis: int
    gate_slope: float = 10.0
    alpha: float = 0.8
    noise_std: float = 0.0
    update_branch: bool = True
    # Branch-gate sigmoid: "sigmoid" (the bit-reference) or "tanh"
    # (sigma(z) = (1 + tanh(z/2)) / 2, equal to ~1 ulp).
    gate_impl: str = "sigmoid"


class FerroParams(nn.Module):
    """Learnable device parameters, each ``(in_dim, out_dim, num_basis)``:
    switching slope ``k``, coercive field ``ec``, saturation polarisation
    ``ps``, vertical offset ``bias`` and the basis -> output mixing
    coefficients ``coef``."""

    def __init__(self, cfg: FerroConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        shape = (cfg.in_dim, cfg.out_dim, cfg.num_basis)
        for name in ("k", "ec", "ps", "bias", "coef"):
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device,
                                               dtype=dtype)))


class FerroState(NamedTuple):
    """Hysteresis state carried between evaluations.

    prev_x : (..., in_dim)                   last field seen per input
    branch : (..., in_dim, out_dim, K)       branch sign in [-1, +1]
    """

    prev_x: torch.Tensor
    branch: torch.Tensor


def ferro_init(generator: torch.Generator, cfg: FerroConfig, *, device=None,
               dtype=torch.float32, coef_scale: float = 1.0) -> FerroParams:
    """Parameters in the physical ranges of the JAX package: k, Ec ~
    U[0.5, 2.5], Ps ~ U[0.5, 2.0], bias ~ 0.1*N(0,1), coef ~
    coef_scale*N(0,1)."""
    shape = (cfg.in_dim, cfg.out_dim, cfg.num_basis)
    p = FerroParams(cfg, device=device, dtype=dtype)
    kw = dict(device=device, dtype=dtype)
    with torch.no_grad():
        p.k.copy_(uniform(generator, shape, 0.5, 2.5, **kw))
        p.ec.copy_(uniform(generator, shape, 0.5, 2.5, **kw))
        p.ps.copy_(uniform(generator, shape, 0.5, 2.0, **kw))
        p.bias.copy_(normal(generator, shape, **kw) * 0.1)
        p.coef.copy_(normal(generator, shape, **kw) * coef_scale)
    return p


def ferro_state_init(batch_shape, cfg: FerroConfig, *, device=None,
                     dtype=torch.float32) -> FerroState:
    """Fresh state: zero field history, everything on the upper branch."""
    return FerroState(
        prev_x=torch.zeros((*batch_shape, cfg.in_dim), device=device,
                           dtype=dtype),
        branch=torch.ones((*batch_shape, cfg.in_dim, cfg.out_dim,
                           cfg.num_basis), device=device, dtype=dtype))


def ferro_basis(params: FerroParams, state: FerroState, x: torch.Tensor,
                cfg: FerroConfig, *, generator: torch.Generator | None = None,
                noise_std: float | torch.Tensor | None = None,
                noise: torch.Tensor | None = None):
    """Evaluate the hysteresis basis tensor and advance the state.

    Args:
      x: (..., in_dim) applied field.
      generator: draws the device noise; required iff ``cfg.noise_std > 0``
        or ``noise_std`` is given.
      noise_std: optional override of ``cfg.noise_std`` (a population run
        can carry a different noise level per member).
      noise: device noise drawn beforehand, the basis's shape with the
        scale multiplied in, used instead of a draw (the frozen per-solve
        noise of ``ops/ferro_node.py: frozen_solve_noise``).

    Returns:
      ``(basis, new_state)`` with ``basis: (..., in, out, K)``.
    """
    xe = x[..., :, None, None]                                   # (..., in, 1, 1)
    prev = state.prev_x.detach()[..., :, None, None]
    # The arithmetic runs in x's dtype whatever the state's (a bfloat16
    # state is read up once), as the fused kernels compute it.
    branch_prev = state.branch.detach().to(x.dtype)              # (..., in, out, K)

    if cfg.gate_impl == "tanh":
        def sig(z):
            return 0.5 + 0.5 * torch.tanh(0.5 * z)
    elif cfg.gate_impl == "sigmoid":
        sig = torch.sigmoid
    else:
        raise ValueError(f"FerroConfig.gate_impl={cfg.gate_impl!r}: "
                         "expected 'sigmoid' or 'tanh'")
    g = cfg.gate_slope
    moving_up = sig(g * (xe - prev))
    crossed_pos = sig(g * (xe - params.ec))
    crossed_neg = sig(g * (-xe - params.ec))

    switch_up = moving_up * crossed_pos
    switch_down = (1.0 - moving_up) * crossed_neg
    target = (switch_up - switch_down
              + (1.0 - switch_up - switch_down) * branch_prev)
    branch = cfg.alpha * branch_prev + (1.0 - cfg.alpha) * target

    basis = params.ps * torch.tanh(params.k * (xe + params.ec * branch)) \
        + params.bias

    if noise is not None:
        basis = basis + noise.detach()
    elif noise_std is not None or cfg.noise_std > 0.0:
        if generator is None:
            raise ValueError("noise_std > 0 requires a generator")
        std = cfg.noise_std if noise_std is None else noise_std
        noise = normal(generator, basis.shape, device=basis.device,
                       dtype=basis.dtype)
        basis = basis + (noise * std).detach()

    new_branch = (target.detach().to(state.branch.dtype)
                  if cfg.update_branch else state.branch)
    new_state = FerroState(prev_x=x.detach().to(state.prev_x.dtype),
                           branch=new_branch)
    return basis, new_state


def ferro_apply(params: FerroParams, state: FerroState, x: torch.Tensor,
                cfg: FerroConfig, *, generator: torch.Generator | None = None,
                noise_std: float | torch.Tensor | None = None,
                noise: torch.Tensor | None = None):
    """Full basis layer: ``y[..., o] = sum_{i,k} basis[..., i, o, k] *
    coef[i, o, k]``.  Returns ``(y, new_state)``.
    """
    basis, new_state = ferro_basis(params, state, x, cfg, generator=generator,
                                   noise_std=noise_std, noise=noise)
    return torch.einsum("...iok,iok->...o", basis, params.coef), new_state
