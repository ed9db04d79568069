"""Plain MLP stacks, layer norm and the residual bottleneck head
(counterpart of ``fetode_tpu/nn/mlp.py``).

A stack is an ``nn.ModuleList`` of ``Dense`` layers, each holding ``w``
(out, in) and ``b`` (out,), so its ``state_dict`` keys (``0.w``,
``0.b``, ...) are the JAX package's ``[{"w", "b"}, ...]`` list.  The
activation runs between layers, ``final_activation`` after the last.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fetode_tpu_torch.utils.init import kaiming_uniform

_ACTS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


class MLPConfig(NamedTuple):
    sizes: Tuple[int, ...]          # (in, hidden..., out)
    activation: str = "tanh"
    final_activation: str = "identity"
    out_scale: float = 1.0          # small-init trick for ODE fields


class Dense(nn.Module):
    """One affine layer, ``x @ w.T + b``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def mlp_init(generator: torch.Generator, cfg: MLPConfig, *, device=None,
             dtype=torch.float32) -> nn.ModuleList:
    """Kaiming-uniform weights (the last scaled by ``out_scale``), zero
    biases."""
    layers = []
    for i, (din, dout) in enumerate(zip(cfg.sizes, cfg.sizes[1:])):
        w = kaiming_uniform(generator, (dout, din), device=device, dtype=dtype)
        if i == len(cfg.sizes) - 2:
            w = w * cfg.out_scale
        layers.append(Dense(w, torch.zeros(dout, device=device, dtype=dtype)))
    return nn.ModuleList(layers)


def mlp_apply(params: nn.ModuleList, cfg: MLPConfig,
              x: torch.Tensor) -> torch.Tensor:
    act = _ACTS[cfg.activation]
    for i, layer in enumerate(params):
        x = x @ layer.w.T + layer.b
        if i < len(params) - 1:
            x = act(x)
    return _ACTS[cfg.final_activation](x)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Plain layer norm over the last axis: the biased variance, as the
    JAX package takes it (the conditional-diffusion node encoder
    normalises its latent state with it)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class ResidualHeadConfig(NamedTuple):
    """y + W2 GELU(W1 y): dim -> bottleneck -> dim refinement head."""

    dim: int = 2
    bottleneck: int = 32

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig((self.dim, self.bottleneck, self.dim),
                         activation="gelu")


def residual_head_init(generator: torch.Generator, cfg: ResidualHeadConfig, *,
                       device=None, dtype=torch.float32) -> nn.ModuleList:
    return mlp_init(generator, cfg.mlp, device=device, dtype=dtype)


def residual_head_apply(params: nn.ModuleList, cfg: ResidualHeadConfig,
                        y: torch.Tensor) -> torch.Tensor:
    return y + mlp_apply(params, cfg.mlp, y)
