"""Recurrent cells and sequence encoders (counterpart of
``fetode_tpu/nn/rnn.py``): the logistic-basis KAN cell, its head and RNN,
the ferro-basis cell and its sequence classifier (the FEPA-RNN of the ECG
scripts), the KAN-RNN context encoder and the bidirectional tanh RNN
baseline.

Parameters are ``ParamTree`` modules whose ``state_dict`` keys are the
dotted paths of the JAX package's param dicts (``cell.input_basis.k``,
``head_weight``, ``fwd.w_ih`` ...), so ``convert.ecg_params_from_numpy``
loads a JAX tree.  Hysteresis state is an explicit ``FerroCellState`` of
``FerroState``s passed in and returned; device noise draws from an
explicit ``torch.Generator``.  The time loops are Python loops.

The ferro layers go through ``ops/ferro_fused.py: ferro_apply_fused``:
the CUDA kernel on the card, the plain ``ferro_apply`` on the CPU.  With
``noise_std > 0`` they take ``ferro_apply`` with the generator, as the
JAX package's fused kernel has no noise operand either.

With ``mix="truncate"`` (the reference's cell) the cell's output is
``tanh(concat[x_feat, h_feat])[..., :hidden]``, and since ``x_feat`` has
``hidden`` columns that is exactly ``tanh(x_feat)``: the port forms it so,
and the hidden op's output (and the all-zero cotangent the slice would
send down its chain) stays out of the graph.  The hidden op still runs
and carries its state, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from fetode_tpu_torch.ops.ferro import (
    FerroConfig,
    FerroState,
    ferro_apply,
    ferro_init,
    ferro_state_init,
)
from fetode_tpu_torch.ops.ferro_fused import ferro_apply_fused
from fetode_tpu_torch.ops.logistic import (
    LogisticParams,
    logistic_basis,
    logistic_init,
)
from fetode_tpu_torch.utils.init import kaiming_uniform, normal


class ParamTree(nn.Module):
    """Parameters named as a JAX param dict: a tensor becomes a parameter,
    a module a submodule and a dict a nested ``ParamTree``."""

    def __init__(self, **items):
        super().__init__()
        for name, value in items.items():
            if isinstance(value, dict):
                value = ParamTree(**value)
            setattr(self, name, value if isinstance(value, nn.Module)
                    else nn.Parameter(value))


def _logistic(generator, in_features, num_basis, kw) -> ParamTree:
    p = logistic_init(generator, in_features, num_basis, **kw)
    return ParamTree(a=p.a, b=p.b)


def _basis(params: ParamTree, x: torch.Tensor) -> torch.Tensor:
    return logistic_basis(LogisticParams(params.a, params.b), x)


def ferro_layer(params, state: FerroState, x: torch.Tensor, cfg: FerroConfig,
                generator: torch.Generator | None = None):
    """One stateful ferro layer op: ``ferro_apply_fused`` without noise,
    ``ferro_apply`` with the generator's noise when ``cfg.noise_std > 0``."""
    if cfg.noise_std > 0.0:
        return ferro_apply(params, state, x, cfg, generator=generator)
    return ferro_apply_fused(params, state, x, cfg)


# ------------------------------------------------------ logistic KAN cell


class LogisticKANCellConfig(NamedTuple):
    input_size: int
    hidden_size: int
    num_basis: int = 10
    mix: str = "truncate"   # reference behaviour | "sum"


def logistic_kan_cell_init(generator: torch.Generator,
                           cfg: LogisticKANCellConfig, *, device=None,
                           dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    return ParamTree(
        input_basis=_logistic(generator, cfg.input_size, cfg.num_basis, kw),
        hidden_basis=_logistic(generator, cfg.hidden_size, cfg.num_basis,
                               kw))


def logistic_kan_cell_apply(params: ParamTree, cfg: LogisticKANCellConfig,
                            x_t: torch.Tensor,
                            h_prev: torch.Tensor) -> torch.Tensor:
    """sigmoid(concat[phi(x), phi(h)]) truncated to hidden_size, or with
    ``mix="sum"`` folded back to hidden_size by summing aligned chunks."""
    x_phi = _basis(params.input_basis, x_t)
    h_phi = _basis(params.hidden_basis, h_prev)
    out = torch.sigmoid(torch.cat(
        [x_phi.reshape(*x_t.shape[:-1], -1),
         h_phi.reshape(*h_prev.shape[:-1], -1)], dim=-1))
    H = cfg.hidden_size
    if cfg.mix == "truncate":
        return out[..., :H]
    pad = (-out.shape[-1]) % H
    out = nn.functional.pad(out, (0, pad))
    return out.reshape(*out.shape[:-1], -1, H).sum(-2)


class KANHeadConfig(NamedTuple):
    """Logistic-basis linear head (classifier or regressor)."""

    in_dim: int
    out_dim: int
    num_basis: int = 10


def kan_head_init(generator: torch.Generator, cfg: KANHeadConfig, *,
                  device=None, dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    return ParamTree(
        basis=_logistic(generator, cfg.in_dim, cfg.num_basis, kw),
        output=normal(generator, (cfg.in_dim * cfg.num_basis, cfg.out_dim),
                      **kw))


def kan_head_apply(params: ParamTree, cfg: KANHeadConfig,
                   x: torch.Tensor) -> torch.Tensor:
    phi = torch.sigmoid(_basis(params.basis, x))
    return phi.reshape(*x.shape[:-1], -1) @ params.output


class LogisticKANRNNConfig(NamedTuple):
    input_size: int = 3
    hidden_size: int = 64
    out_dim: int = 2
    num_basis: int = 10
    mix: str = "truncate"

    @property
    def cell(self) -> LogisticKANCellConfig:
        return LogisticKANCellConfig(self.input_size, self.hidden_size,
                                     self.num_basis, self.mix)

    @property
    def head(self) -> KANHeadConfig:
        return KANHeadConfig(self.hidden_size, self.out_dim, self.num_basis)


def logistic_kan_rnn_init(generator: torch.Generator,
                          cfg: LogisticKANRNNConfig, *, device=None,
                          dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    return ParamTree(cell=logistic_kan_cell_init(generator, cfg.cell, **kw),
                     head=kan_head_init(generator, cfg.head, **kw))


def _run_logistic_cell(params: ParamTree, cfg: LogisticKANCellConfig,
                       x_seq: torch.Tensor) -> torch.Tensor:
    """The cell over the time axis of x_seq (B, T, F) from h = 0."""
    h = torch.zeros((x_seq.shape[0], cfg.hidden_size), dtype=x_seq.dtype,
                    device=x_seq.device)
    for t in range(x_seq.shape[1]):
        h = logistic_kan_cell_apply(params, cfg, x_seq[:, t], h)
    return h


def logistic_kan_rnn_apply(params: ParamTree, cfg: LogisticKANRNNConfig,
                           x_seq: torch.Tensor) -> torch.Tensor:
    """x_seq (B, T, input_size) -> (B, out_dim)."""
    hT = _run_logistic_cell(params.cell, cfg.cell, x_seq)
    return kan_head_apply(params.head, cfg.head, hT)


# --------------------------------------------------------- ferro KAN cell


class FerroKANCellConfig(NamedTuple):
    input_size: int
    hidden_size: int
    num_basis: int = 10
    gate_slope: float = 10.0
    alpha: float = 0.8
    noise_std: float = 0.0
    mix: str = "truncate"
    state_dtype: str = ""   # "" = the input's dtype, or e.g. "bfloat16"

    @property
    def input_cfg(self) -> FerroConfig:
        return FerroConfig(self.input_size, self.hidden_size, self.num_basis,
                           self.gate_slope, self.alpha, self.noise_std)

    @property
    def hidden_cfg(self) -> FerroConfig:
        return FerroConfig(self.hidden_size, self.hidden_size, self.num_basis,
                           self.gate_slope, self.alpha, self.noise_std)


class FerroCellState(NamedTuple):
    input_state: FerroState
    hidden_state: FerroState


def ferro_kan_cell_init(generator: torch.Generator, cfg: FerroKANCellConfig,
                        *, device=None, dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    return ParamTree(input_basis=ferro_init(generator, cfg.input_cfg, **kw),
                     hidden_basis=ferro_init(generator, cfg.hidden_cfg, **kw))


def ferro_kan_cell_state(batch_shape, cfg: FerroKANCellConfig, *,
                         device=None, dtype=torch.float32) -> FerroCellState:
    """A fresh state; ``cfg.state_dtype``, when set, overrides ``dtype``."""
    if cfg.state_dtype:
        dtype = getattr(torch, cfg.state_dtype)
    kw = dict(device=device, dtype=dtype)
    return FerroCellState(
        input_state=ferro_state_init(batch_shape, cfg.input_cfg, **kw),
        hidden_state=ferro_state_init(batch_shape, cfg.hidden_cfg, **kw))


def ferro_kan_cell_apply(params: ParamTree, cfg: FerroKANCellConfig,
                         x_t: torch.Tensor, h_prev: torch.Tensor,
                         state: FerroCellState, *,
                         generator: torch.Generator | None = None):
    """tanh(concat[ferro_x(x_t), ferro_h(h)]) truncated to hidden_size
    (``mix="sum"``: tanh(ferro_x + ferro_h)).  Cross-step memory flows
    through the hysteresis state.  Returns ``(h_next, new_state)``."""
    x_feat, s_in = ferro_layer(params.input_basis, state.input_state, x_t,
                               cfg.input_cfg, generator)
    h_feat, s_hid = ferro_layer(params.hidden_basis, state.hidden_state,
                                h_prev, cfg.hidden_cfg, generator)
    if cfg.mix == "truncate":
        h1 = torch.tanh(x_feat)     # = tanh(concat)[..., :hidden_size]
    else:
        h1 = torch.tanh(x_feat + h_feat)
    return h1, FerroCellState(s_in, s_hid)


class FerroKANRNNConfig(NamedTuple):
    """Ferro-basis sequence classifier (the FEPA-RNN of the ECG scripts)."""

    input_size: int = 1
    hidden_size: int = 64
    num_classes: int = 2
    num_basis: int = 10
    noise_std: float = 0.0
    state_dtype: str = ""

    @property
    def cell(self) -> FerroKANCellConfig:
        return FerroKANCellConfig(self.input_size, self.hidden_size,
                                  self.num_basis, noise_std=self.noise_std,
                                  state_dtype=self.state_dtype)

    @property
    def head_cfg(self) -> FerroConfig:
        return FerroConfig(self.hidden_size, self.hidden_size,
                           self.num_basis, noise_std=self.noise_std)


def ferro_kan_rnn_init(generator: torch.Generator, cfg: FerroKANRNNConfig, *,
                       device=None, dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    return ParamTree(
        cell=ferro_kan_cell_init(generator, cfg.cell, **kw),
        head_basis=ferro_init(generator, cfg.head_cfg, **kw),
        # a trained head (the reference resamples a random head every
        # forward, a fault the JAX package does not copy either)
        head_weight=kaiming_uniform(generator,
                                    (cfg.num_classes, cfg.hidden_size), **kw))


def ferro_kan_rnn_apply(params: ParamTree, cfg: FerroKANRNNConfig,
                        x_seq: torch.Tensor, *,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """x_seq (B, T) or (B, T, input_size) -> logits (B, num_classes).

    The hysteresis state is fresh per call (reset per sequence): 2 T + 1
    ferro layer ops, the cell's two at each step and the head's."""
    if x_seq.ndim == 2:
        x_seq = x_seq[..., None]
    B, T, _ = x_seq.shape
    kw = dict(device=x_seq.device, dtype=x_seq.dtype)
    h = torch.zeros((B, cfg.hidden_size), **kw)
    s = ferro_kan_cell_state((B,), cfg.cell, **kw)
    for t in range(T):
        h, s = ferro_kan_cell_apply(params.cell, cfg.cell, x_seq[:, t], h, s,
                                    generator=generator)
    head_state = ferro_state_init((B,), cfg.head_cfg, **kw)
    feat, _ = ferro_layer(params.head_basis, head_state, h, cfg.head_cfg,
                          generator)
    return torch.tanh(feat) @ params.head_weight.T


# ------------------------------------------------------ KAN-RNN encoder


class KANRNNEncoderConfig(NamedTuple):
    num_features: int
    hidden_size: int
    latent_dim: int
    num_basis: int = 10

    @property
    def cell(self) -> LogisticKANCellConfig:
        return LogisticKANCellConfig(self.num_features, self.hidden_size,
                                     self.num_basis)


def kan_rnn_encoder_init(generator: torch.Generator, cfg: KANRNNEncoderConfig,
                         *, device=None, dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    return ParamTree(
        cell=logistic_kan_cell_init(generator, cfg.cell, **kw),
        to_latent_w=kaiming_uniform(generator,
                                    (cfg.latent_dim, cfg.hidden_size), **kw),
        to_latent_b=torch.zeros(cfg.latent_dim, **kw))


def kan_rnn_encoder_apply(params: ParamTree, cfg: KANRNNEncoderConfig,
                          x_ctx: torch.Tensor) -> torch.Tensor:
    """(B, T, F) context -> (B, latent) initial latent state z0."""
    hT = _run_logistic_cell(params.cell, cfg.cell, x_ctx)
    return hT @ params.to_latent_w.T + params.to_latent_b


# ---------------------------------------------------------- digital RNN


class DigitalRNNConfig(NamedTuple):
    """Plain tanh RNN classifier baseline (bidirectional), the reference's
    ``Digital_RNN``."""

    input_size: int = 1
    hidden_size: int = 64
    num_classes: int = 2
    bidirectional: bool = True


def digital_rnn_init(generator: torch.Generator, cfg: DigitalRNNConfig, *,
                     device=None, dtype=torch.float32) -> ParamTree:
    kw = dict(device=device, dtype=dtype)
    H = cfg.hidden_size

    def cell():
        return dict(w_ih=kaiming_uniform(generator, (H, cfg.input_size), **kw),
                    w_hh=kaiming_uniform(generator, (H, H), **kw),
                    b=torch.zeros(H, **kw))

    dirs = 2 if cfg.bidirectional else 1
    cells = {"fwd": cell()}
    if cfg.bidirectional:
        cells["bwd"] = cell()
    return ParamTree(**cells,
                     head_w=kaiming_uniform(generator,
                                            (cfg.num_classes, dirs * H), **kw),
                     head_b=torch.zeros(cfg.num_classes, **kw))


def digital_rnn_apply(params: ParamTree, cfg: DigitalRNNConfig,
                      x_seq: torch.Tensor) -> torch.Tensor:
    """(B, T) or (B, T, F) -> logits (B, num_classes).  The products are
    ``torch.matmul`` (TF32 off on the card: ``utils/device.py``)."""
    if x_seq.ndim == 2:
        x_seq = x_seq[..., None]

    def run(cell, order):
        h = torch.zeros((x_seq.shape[0], cfg.hidden_size),
                        dtype=x_seq.dtype, device=x_seq.device)
        for t in order:
            h = torch.tanh(x_seq[:, t] @ cell.w_ih.T + h @ cell.w_hh.T
                           + cell.b)
        return h

    T = x_seq.shape[1]
    feats = [run(params.fwd, range(T))]
    if cfg.bidirectional:
        feats.append(run(params.bwd, reversed(range(T))))
    h = torch.cat(feats, dim=-1)
    return h @ params.head_w.T + params.head_b
