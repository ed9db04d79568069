"""Ferroelectric basis layers: linear, per-feature (2D) and convolutional
(counterpart of ``fetode_tpu/nn/ferro_layers.py``).

The linear layer is ``ops/ferro.py``'s (``ferro_linear_*``); the
reference's batched, noisy and buffer-free variants are its options.  The
per-feature basis (``ferro_feature_*``, parameters (in, K)) returns the
weighted basis tensor; the convolution (``ferro_conv2d_*``) evaluates
the hysteresis response on every patch element, as the reference's
``FerroelectricBasisConv2d`` does, with ``out_chunk`` for its
memory-bounded variant.

Parameters are NamedTuples of tensors drawn from an explicit
``torch.Generator``; hysteresis state is explicit, passed in and
returned, and carries no gradient; device noise draws from a generator
and stays outside the gradient.  ``nn/modules.py`` wraps these functions
in ``nn.Module``s with the reference's class names.

Patches are ``torch.nn.functional.unfold``'s (B, Cin*kH*kW, L): a
patch's features channel-major, (Cin, kH, kW), and L = Hout * Wout
row-major, the order of ``lax.conv_general_dilated_patches`` that the
JAX package flattens its parameters to (``transpose(0, 1, 3, 4, 2)``);
``tests/test_torch_ferro_layers.py`` holds the two at stride 1 and 2,
padding 0 and 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fetode_tpu_torch.ops.ferro import (
    ferro_apply,
    ferro_init,
    ferro_state_init,
)
from fetode_tpu_torch.utils.init import normal, uniform

# ---------------------------------------------------------------- linear

ferro_linear_init = ferro_init
ferro_linear_state = ferro_state_init
ferro_linear_apply = ferro_apply


def _device_params(generator, shape, device, dtype):
    """k, Ec ~ U[0.5, 2.5], Ps ~ U[0.5, 2.0], bias ~ 0.1 N(0, 1), coef ~
    N(0, 1), in that order."""
    kw = dict(device=device, dtype=dtype)
    return (uniform(generator, shape, 0.5, 2.5, **kw),
            uniform(generator, shape, 0.5, 2.5, **kw),
            uniform(generator, shape, 0.5, 2.0, **kw),
            normal(generator, shape, **kw) * 0.1,
            normal(generator, shape, **kw))


def _noise(generator, like: torch.Tensor, std: float) -> torch.Tensor:
    if generator is None:
        raise ValueError("noise_std > 0 requires a generator")
    return (normal(generator, like.shape, device=like.device,
                   dtype=like.dtype) * std).detach()


# ------------------------------------------------- per-feature (2D) basis


class Ferro2DParams(NamedTuple):
    """Per-(in_dim, num_basis) device parameters, no output dimension."""

    k: torch.Tensor
    ec: torch.Tensor
    ps: torch.Tensor
    bias: torch.Tensor
    coef: torch.Tensor


def ferro_feature_init(generator: torch.Generator, in_dim: int, num_basis: int,
                       *, device=None, dtype=torch.float32) -> Ferro2DParams:
    return Ferro2DParams(*_device_params(generator, (in_dim, num_basis),
                                         device, dtype))


class Ferro2DState(NamedTuple):
    prev_x: torch.Tensor   # (..., in)
    branch: torch.Tensor   # (..., in, K)


def ferro_feature_state(batch_shape, in_dim: int, num_basis: int, *,
                        device=None, dtype=torch.float32) -> Ferro2DState:
    return Ferro2DState(
        prev_x=torch.zeros((*batch_shape, in_dim), device=device, dtype=dtype),
        branch=torch.ones((*batch_shape, in_dim, num_basis), device=device,
                          dtype=dtype))


def ferro_feature_basis(params: Ferro2DParams, state: Ferro2DState,
                        x: torch.Tensor, *, gate_slope: float = 10.0,
                        alpha: float = 0.8, noise_std: float = 0.0,
                        generator: Optional[torch.Generator] = None):
    """The weighted hysteresis basis ``(..., in, K)`` and the new state (the
    reference's ``TwoDimensionFerroelectricBasis`` returns the weighted
    basis, not a summed output, ``ferro_class.py:583-592``)."""
    xe = x[..., None]
    prev = state.prev_x.detach()[..., None]
    br = state.branch.detach()

    up = torch.sigmoid(gate_slope * (xe - prev))
    cp = torch.sigmoid(gate_slope * (xe - params.ec))
    cn = torch.sigmoid(gate_slope * (-xe - params.ec))
    sw_up, sw_dn = up * cp, (1 - up) * cn
    target = sw_up - sw_dn + (1 - sw_up - sw_dn) * br
    mom = alpha * br + (1 - alpha) * target

    basis = params.ps * torch.tanh(params.k * (xe + params.ec * mom)) \
        + params.bias
    if noise_std > 0:
        basis = basis + _noise(generator, basis, noise_std)
    return basis * params.coef, Ferro2DState(prev_x=x.detach(),
                                             branch=target.detach())


# ------------------------------------------------------------------ conv2d


class FerroConv2DConfig(NamedTuple):
    in_channels: int
    out_channels: int
    kernel_size: Tuple[int, int] = (3, 3)
    num_basis: int = 3
    stride: int = 1
    padding: int = 0
    gate_slope: float = 10.0
    alpha: float = 0.8
    noise_std: float = 0.0
    stateful: bool = False     # default stateless (dx = 0, branch = +1)
    out_chunk: int = 0         # > 0: output channels in blocks of this size


class FerroConv2DParams(NamedTuple):
    """Each (Cout, Cin, K, kH, kW), and the output bias (Cout,)."""

    k: torch.Tensor
    ec: torch.Tensor
    ps: torch.Tensor
    bias: torch.Tensor
    coef: torch.Tensor
    out_bias: torch.Tensor


def ferro_conv2d_init(generator: torch.Generator, cfg: FerroConv2DConfig, *,
                      device=None, dtype=torch.float32) -> FerroConv2DParams:
    kH, kW = cfg.kernel_size
    shape = (cfg.out_channels, cfg.in_channels, cfg.num_basis, kH, kW)
    return FerroConv2DParams(
        *_device_params(generator, shape, device, dtype),
        out_bias=torch.zeros(cfg.out_channels, device=device, dtype=dtype))


class FerroConv2DState(NamedTuple):
    """Hysteresis state over the patch field, shared across Cout: prev_x
    (..., L, P), branch (..., L, P, K), P = Cin*kH*kW patch elements and L
    output positions."""

    prev_x: torch.Tensor
    branch: torch.Tensor


def conv_out_hw(cfg: FerroConv2DConfig, H: int, W: int) -> Tuple[int, int]:
    """(Hout, Wout) of an (H, W) input."""
    kH, kW = cfg.kernel_size
    return ((H + 2 * cfg.padding - kH) // cfg.stride + 1,
            (W + 2 * cfg.padding - kW) // cfg.stride + 1)


def _patches(x: torch.Tensor, cfg: FerroConv2DConfig):
    """(B, Cin, H, W) -> the (B, L, P) patch matrix and (Hout, Wout)."""
    p = F.unfold(x, cfg.kernel_size, padding=cfg.padding, stride=cfg.stride)
    return p.transpose(1, 2), conv_out_hw(cfg, x.shape[2], x.shape[3])


def ferro_conv2d_state(batch_shape, cfg: FerroConv2DConfig, out_hw, *,
                       device=None, dtype=torch.float32) -> FerroConv2DState:
    kH, kW = cfg.kernel_size
    P = cfg.in_channels * kH * kW
    L = out_hw[0] * out_hw[1]
    return FerroConv2DState(
        prev_x=torch.zeros((*batch_shape, L, P), device=device, dtype=dtype),
        branch=torch.ones((*batch_shape, L, P, cfg.num_basis), device=device,
                          dtype=dtype))


def ferro_conv2d_apply(params: FerroConv2DParams, cfg: FerroConv2DConfig,
                       x: torch.Tensor,
                       state: Optional[FerroConv2DState] = None, *,
                       generator: Optional[torch.Generator] = None):
    """Convolutional hysteresis response.

    out[b, o, l] = sum_{p, k} coef[o,p,k] * (Ps*tanh(k*(x_patch[b,l,p]
                   + Ec*branch)) + bias) + out_bias[o]

    The branch state lives on the patch field (independent of Cout), so
    memory is O(B*L*P*K).  ``out_chunk`` bounds the transient basis
    tensor to that many output channels at a time.  A stateful layer
    advances its state from the Cout-mean of Ec.

    Returns ``(y, new_state)``, y (B, Cout, Hout, Wout); new_state is None
    unless ``cfg.stateful``.
    """
    patches, out_hw = _patches(x, cfg)                  # (B, L, P)
    B, L, P = patches.shape
    K, Co = cfg.num_basis, cfg.out_channels

    def flat(a):                                         # -> (Cout, P, K)
        return a.permute(0, 1, 3, 4, 2).reshape(Co, P, K)

    pk, pec, pps, pbias, pcoef = map(flat, params[:5])

    if cfg.stateful and state is not None:
        prev = state.prev_x.detach()                     # (B, L, P)
        br = state.branch.detach()                       # (B, L, P, K)
    else:
        prev, br = patches, None                         # dx = 0, +1 branch

    g = cfg.gate_slope
    xe = patches[..., None]                              # (B, L, P, 1)
    up = torch.sigmoid(g * (xe - prev[..., None]))
    x5 = patches[:, :, None, :, None]                    # (B, L, 1, P, 1)
    up5 = up[:, :, None, :, :]
    br5 = 1.0 if br is None else br[:, :, None, :, :]

    def block(lo, hi):
        bk, bec, bps, bbias, bcoef = (a[lo:hi] for a in
                                      (pk, pec, pps, pbias, pcoef))
        cp = torch.sigmoid(g * (x5 - bec))
        cn = torch.sigmoid(g * (-x5 - bec))
        sw_up, sw_dn = up5 * cp, (1 - up5) * cn
        target = sw_up - sw_dn + (1 - sw_up - sw_dn) * br5
        mom = cfg.alpha * br5 + (1 - cfg.alpha) * target
        basis = bps * torch.tanh(bk * (x5 + bec * mom)) + bbias
        return torch.einsum("blopk,opk->bol", basis, bcoef)

    chunk = cfg.out_chunk if 0 < cfg.out_chunk < Co else Co
    y = torch.cat([block(lo, min(lo + chunk, Co))
                   for lo in range(0, Co, chunk)], dim=1)   # (B, Cout, L)

    if cfg.noise_std > 0:
        y = y + _noise(generator, y, cfg.noise_std)
    y = (y + params.out_bias[None, :, None]).reshape(B, Co, *out_hw)

    new_state = None
    if cfg.stateful:
        # The state is Cout-independent: its branch target uses the mean
        # of Ec over the output channels.
        ec_shared = pec.mean(0)                          # (P, K)
        cp = torch.sigmoid(g * (xe - ec_shared))
        cn = torch.sigmoid(g * (-xe - ec_shared))
        sw_up, sw_dn = up * cp, (1 - up) * cn
        br0 = br if br is not None else torch.ones_like(sw_up)
        target = sw_up - sw_dn + (1 - sw_up - sw_dn) * br0
        new_state = FerroConv2DState(prev_x=patches.detach(),
                                     branch=target.detach())
    return y, new_state
