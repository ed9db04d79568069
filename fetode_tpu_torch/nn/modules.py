"""Classes with the reference's names and constructors (counterpart of
``fetode_tpu/nn/modules.py``).

In the JAX package these classes hold only static config and take their
parameters explicitly (``model(params, x)``).  Here each is an
``nn.Module`` that owns its parameters, drawn from ``generator`` (the
global ``torch.default_generator`` when None) at construction, and is
called as ``model(x)`` / ``model(state, x)``.  Hysteresis state stays
explicit: a class returns ``(y, new_state)`` where the JAX class does.

Name map (reference -> here):
  efficient_kan.KAN / the missing KANFET        -> KAN / KANFET
  ferro_class.FerroelectricBasis                -> FerroelectricBasis
  ferro_class.NoisyFerroelectricBasis           -> NoisyFerroelectricBasis
  ferro_class.{Original,}BatchedFerroelectric.. -> FerroelectricBasis
  ferro_class.TwoDimensionFerroelectricBasis    -> TwoDimensionFerroelectricBasis
  ferro_class.FerroelectricBasisConv2d          -> FerroelectricBasisConv2d
  ferro_class.MemEfficient_...Conv2d            -> FerroelectricBasisConv2d
                                                   (out_chunk=...)

``KAN`` here subclasses ``nn/kan.py: KAN``, the stack module every KAN
function of the port takes (``kan_apply``, ``models/predprey.py:
predict``, the B.1 / B.2 kernels), so the two share one layout and one
``state_dict``; only the constructor differs.  ``FerroelectricBasis``
goes through ``nn/rnn.py: ferro_layer``: B.13 on the card when clean,
the plain op with noise, and the plain op when activations are asked
for (B.13 returns none).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fetode_tpu_torch.nn import kan as K
from fetode_tpu_torch.nn.ferro_layers import (
    Ferro2DParams,
    FerroConv2DConfig,
    FerroConv2DParams,
    ferro_conv2d_apply,
    ferro_conv2d_init,
    ferro_conv2d_state,
    ferro_feature_basis,
    ferro_feature_init,
    ferro_feature_state,
)
from fetode_tpu_torch.nn.rnn import ferro_layer
from fetode_tpu_torch.ops.ferro import (
    FerroConfig,
    ferro_basis,
    ferro_init,
    ferro_state_init,
)

_FERRO = ("k", "ec", "ps", "bias", "coef")


def _gen(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.default_generator if generator is None else generator


def _own(module: nn.Module, names, values) -> None:
    for name, value in zip(names, values):
        module.register_parameter(name, nn.Parameter(value.detach()))


class KAN(K.KAN):
    """``KAN(layers_hidden, grid_size=5, spline_order=3, ...)``, the
    constructor of the reference's KAN (``efficientkan.py:240-284``);
    further keywords are ``KANLinearConfig`` fields."""

    def __init__(self, layers_hidden: Sequence[int], grid_size: int = 5,
                 spline_order: int = 3, *, generator=None, device=None,
                 dtype=torch.float32, **kw):
        self._build(K.KANConfig.make(list(layers_hidden), grid_size=grid_size,
                                     spline_order=spline_order, **kw),
                    generator, device, dtype)

    def _build(self, cfg: K.KANConfig, generator, device, dtype) -> None:
        super().__init__(cfg, device=device, dtype=dtype)
        self.layers = K.kan_init(_gen(generator), cfg, device=device,
                                 dtype=dtype).layers

    @property
    def stateful(self) -> bool:
        return any(c.ferro_num_basis > 0 for c in self.cfg.layers)

    def init_state(self, batch_shape=(), *, device=None, dtype=None):
        p = self.layers[0].base_weight
        return K.kan_state_init(batch_shape, self.cfg,
                                device=device or p.device,
                                dtype=dtype or p.dtype)

    def forward(self, x, state=None, *, generator=None, plain=False):
        """``(y, new_state)`` for a stack with ferro layers, else ``y``."""
        y, new_state = K.kan_apply(self, x, state, generator=generator,
                                   plain=plain)
        return (y, new_state) if self.stateful else y

    def regularization_loss(self, **kw):
        return K.kan_regularization(self, **kw)


class KANFET(KAN):
    """The symbol the reference imports but never defines: a KAN whose
    layers carry the ferroelectric hysteresis branch,
    ``KANFET(layers_hidden=[2, 10, 2], grid_size=5)``."""

    def __init__(self, layers_hidden: Sequence[int], grid_size: int = 5,
                 spline_order: int = 3, ferro_num_basis: int = 8,
                 noise_std: float = 0.0, *, generator=None, device=None,
                 dtype=torch.float32, **kw):
        self._build(K.kanfet_config(list(layers_hidden), grid_size=grid_size,
                                    spline_order=spline_order,
                                    ferro_num_basis=ferro_num_basis,
                                    noise_std=noise_std, **kw),
                    generator, device, dtype)


class FerroelectricBasis(nn.Module):
    """``FerroelectricBasis(in_dim, out_dim, num_basis, ...)``
    (``ferro_class.py:329-424``), batched over leading axes; parameters
    ``k``, ``ec``, ``ps``, ``bias``, ``coef``, each (in, out, K)."""

    def __init__(self, in_dim: int, out_dim: int, num_basis: int,
                 use_noise: bool = False, gate_slope: float = 10.0,
                 alpha: float = 0.8, noise_std: float = 0.05, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = FerroConfig(in_dim, out_dim, num_basis,
                               gate_slope=gate_slope, alpha=alpha,
                               noise_std=noise_std if use_noise else 0.0)
        p = ferro_init(_gen(generator), self.cfg, device=device, dtype=dtype)
        _own(self, _FERRO, (getattr(p, n) for n in _FERRO))

    def init_state(self, batch_shape=(), *, dtype=None):
        return ferro_state_init(batch_shape, self.cfg, device=self.k.device,
                                dtype=dtype or self.k.dtype)

    # reset_state == init_state: state is a value, not module memory
    reset_state = init_state

    def forward(self, state, x, *, generator=None,
                return_activations: bool = False):
        """``(y, new_state)``, with ``return_activations`` also the basis
        tensor (..., in, out, K)."""
        if not return_activations:
            return ferro_layer(self, state, x, self.cfg, generator)
        basis, new_state = ferro_basis(self, state, x, self.cfg,
                                       generator=generator)
        return (torch.einsum("...iok,iok->...o", basis, self.coef),
                new_state, basis)


class NoisyFerroelectricBasis(FerroelectricBasis):
    """Always-on device noise, default std 0.2 (``ferro_class.py:427-523``)."""

    def __init__(self, in_dim, out_dim, num_basis, noise_std: float = 0.2,
                 **kw):
        super().__init__(in_dim, out_dim, num_basis, use_noise=True,
                         noise_std=noise_std, **kw)


class TwoDimensionFerroelectricBasis(nn.Module):
    """Per-feature basis, parameters (in, K), returning the weighted basis
    tensor (``ferro_class.py:526-596``)."""

    def __init__(self, in_dim: int, num_basis: int, gate_slope: float = 10.0,
                 alpha: float = 0.8, noise_std: float = 0.0, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.in_dim, self.num_basis = in_dim, num_basis
        self.gate_slope, self.alpha, self.noise_std = gate_slope, alpha, \
            noise_std
        _own(self, Ferro2DParams._fields, ferro_feature_init(
            _gen(generator), in_dim, num_basis, device=device, dtype=dtype))

    @property
    def params(self) -> Ferro2DParams:
        return Ferro2DParams(*(getattr(self, n)
                               for n in Ferro2DParams._fields))

    def init_state(self, batch_shape=(), *, dtype=None):
        return ferro_feature_state(batch_shape, self.in_dim, self.num_basis,
                                   device=self.k.device,
                                   dtype=dtype or self.k.dtype)

    def forward(self, state, x, *, generator=None):
        return ferro_feature_basis(self.params, state, x,
                                   gate_slope=self.gate_slope,
                                   alpha=self.alpha, noise_std=self.noise_std,
                                   generator=generator)


class FerroelectricBasisConv2d(nn.Module):
    """Hysteresis conv layer (``ferro_class.py:601-944``); ``out_chunk``
    gives the memory-bounded variant."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 num_basis: int = 3, stride: int = 1, padding: int = 0,
                 use_noise: bool = False, noise_std: float = 0.2,
                 gate_slope: float = 10.0, alpha: float = 0.8,
                 stateful: bool = False, out_chunk: int = 0, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        ks = tuple(kernel_size) if isinstance(kernel_size, (tuple, list)) \
            else (kernel_size, kernel_size)
        self.cfg = FerroConv2DConfig(
            in_channels, out_channels, ks, num_basis, stride, padding,
            gate_slope, alpha, noise_std if use_noise else 0.0, stateful,
            out_chunk)
        _own(self, FerroConv2DParams._fields, ferro_conv2d_init(
            _gen(generator), self.cfg, device=device, dtype=dtype))

    @property
    def params(self) -> FerroConv2DParams:
        return FerroConv2DParams(*(getattr(self, n)
                                   for n in FerroConv2DParams._fields))

    def init_state(self, batch_shape, out_hw, *, dtype=None):
        return ferro_conv2d_state(batch_shape, self.cfg, out_hw,
                                  device=self.k.device,
                                  dtype=dtype or self.k.dtype)

    def forward(self, x, state=None, *, generator=None):
        return ferro_conv2d_apply(self.params, self.cfg, x, state,
                                  generator=generator)
