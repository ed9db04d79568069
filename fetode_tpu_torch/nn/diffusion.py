"""Gaussian diffusion (DDPM) over forecast sequences (counterpart of
``fetode_tpu/nn/diffusion.py``).

Linear beta schedule, closed-form ``q_sample``, posterior-mean reverse
steps, and the MLP epsilon head on ``[y_t, cond, sin-emb(t)]``.  The
JAX package's PRNG keys become ``torch.Generator``s; every function that
draws also takes the numbers explicitly (``t_idx``/``eps``, ``y0``/
``noise``), so a test can feed both packages the same draws.  The
whole-chain CUDA kernel of the eps-head sampler is ``ops/ddpm.py``;
``eps_head_sample_loop`` here is the eager chain with the same hoisting.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from fetode_tpu_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_bar: torch.Tensor
    sqrt_alphas_bar: torch.Tensor
    sqrt_one_minus_alphas_bar: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    posterior_variance: torch.Tensor

    @property
    def T(self) -> int:
        return self.betas.shape[0]


def make_schedule(T: int = 100, beta_start: float = 1e-4,
                  beta_end: float = 2e-2, *, device=None,
                  dtype=torch.float32) -> DiffusionSchedule:
    betas = torch.linspace(beta_start, beta_end, T, device=device,
                           dtype=dtype)
    alphas = 1.0 - betas
    alphas_bar = torch.cumprod(alphas, 0)
    prev_bar = torch.cat([alphas_bar[:1], alphas_bar[:-1]])
    return DiffusionSchedule(
        betas=betas,
        alphas=alphas,
        alphas_bar=alphas_bar,
        sqrt_alphas_bar=torch.sqrt(alphas_bar),
        sqrt_one_minus_alphas_bar=torch.sqrt(1.0 - alphas_bar),
        sqrt_recip_alphas=torch.sqrt(1.0 / alphas),
        posterior_variance=betas * (1.0 - prev_bar) / (1.0 - alphas_bar),
    )


def sinusoidal_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) step indices -> (B, dim) sinusoidal embeddings (float32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _bcast(coeff: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return coeff.reshape(coeff.shape + (1,) * (y.ndim - 1))


def q_sample(sched: DiffusionSchedule, y0: torch.Tensor, t_idx: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             eps: Optional[torch.Tensor] = None):
    """Forward noising y_t = sqrt(a_bar) y0 + sqrt(1 - a_bar) eps, with
    ``eps`` drawn from ``generator`` unless given.  Returns (y_t, eps)."""
    if eps is None:
        eps = torch.randn(y0.shape, generator=generator, device=y0.device,
                          dtype=y0.dtype)
    y_t = (_bcast(sched.sqrt_alphas_bar[t_idx], y0) * y0
           + _bcast(sched.sqrt_one_minus_alphas_bar[t_idx], y0) * eps)
    return y_t, eps


def p_sample_step(sched: DiffusionSchedule, eps_model: Callable, y_t, t_idx,
                  cond, generator: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None):
    """One reverse step (posterior mean + noise except at t = 0)."""
    eps_hat = eps_model(y_t, t_idx, cond)
    beta = _bcast(sched.betas[t_idx], y_t)
    sra = _bcast(sched.sqrt_recip_alphas[t_idx], y_t)
    somab = _bcast(sched.sqrt_one_minus_alphas_bar[t_idx], y_t)
    mu = sra * (y_t - beta * eps_hat / somab)
    var = torch.clamp(_bcast(sched.posterior_variance[t_idx], y_t), min=1e-20)
    if noise is None:
        noise = torch.randn(y_t.shape, generator=generator,
                            device=y_t.device, dtype=y_t.dtype)
    is_last = _bcast((t_idx == 0).to(y_t.dtype), y_t)
    return mu + (1.0 - is_last) * torch.sqrt(var) * noise


def _draws(generator, shape, T, device, dtype, y0, noise):
    """The chain's start ``y0`` (shape) and per-step ``noise`` (T, *shape):
    the given ones, else drawn from ``generator`` in that order."""
    if y0 is None:
        y0 = torch.randn(shape, generator=generator, device=device,
                         dtype=dtype)
    if noise is None:
        noise = torch.randn((T,) + tuple(shape), generator=generator,
                            device=device, dtype=dtype)
    return y0, noise


def p_sample_loop(sched: DiffusionSchedule, eps_model: Callable, shape, cond,
                  generator: Optional[torch.Generator] = None, *,
                  device=None, dtype=torch.float32,
                  y0: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The full reverse chain from N(0, 1); ``noise[i]`` is the draw of
    loop step i (t = T-1-i)."""
    y, noise = _draws(generator, tuple(shape), sched.T, device, dtype, y0,
                      noise)
    for i, t in enumerate(range(sched.T - 1, -1, -1)):
        t_idx = torch.full((shape[0],), t, dtype=torch.long, device=y.device)
        y = p_sample_step(sched, eps_model, y, t_idx, cond, noise=noise[i])
    return y


class EpsHeadConfig(NamedTuple):
    """MLP epsilon-predictor on [y_t, cond, sin-emb(t)]."""

    pred_len: int
    cond_dim: int
    hidden: int = 256
    t_emb_dim: int = 128

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig((self.pred_len + self.cond_dim + self.t_emb_dim,
                          self.hidden, self.hidden, self.pred_len),
                         activation="silu")


def eps_head_init(generator: torch.Generator, cfg: EpsHeadConfig, *,
                  device=None, dtype=torch.float32) -> nn.ModuleList:
    return mlp_init(generator, cfg.mlp, device=device, dtype=dtype)


def eps_head_apply(params: nn.ModuleList, cfg: EpsHeadConfig, y_t, t_idx,
                   cond) -> torch.Tensor:
    t_emb = sinusoidal_emb(t_idx, cfg.t_emb_dim).to(y_t.dtype)
    return mlp_apply(params, cfg.mlp, torch.cat([y_t, cond, t_emb], dim=-1))


def eps_head_tables(params: nn.ModuleList, cfg: EpsHeadConfig,
                    sched: DiffusionSchedule, cond: torch.Tensor):
    """What the eps-head chain hoists out of its loop: ``cond_h`` (B, H),
    the conditioning's first-layer contribution plus bias, and ``temb_h``
    (T, H), every step's t-embedding contribution, in loop order (t =
    T-1 first).  Also the first layer's y block ``W1y`` (H, P)."""
    P, C = cfg.pred_len, cfg.cond_dim
    W1, b1 = params[0].w, params[0].b
    W1y, W1c, W1t = W1[:, :P], W1[:, P:P + C], W1[:, P + C:]
    cond_h = cond @ W1c.T + b1
    t_rev = torch.arange(sched.T - 1, -1, -1, device=cond.device)
    temb_h = sinusoidal_emb(t_rev, cfg.t_emb_dim).to(cond.dtype) @ W1t.T
    return cond_h, temb_h, W1y


def chain_coefficients(sched: DiffusionSchedule) -> torch.Tensor:
    """(T, 3) posterior coefficients in loop order, y' = c1 y - c2 eps +
    c3 noise: c3 = 0 at t = 0, the variance clamped at 1e-20."""
    t_rev = torch.arange(sched.T - 1, -1, -1, device=sched.betas.device)
    c1 = sched.sqrt_recip_alphas[t_rev]
    c2 = c1 * sched.betas[t_rev] / sched.sqrt_one_minus_alphas_bar[t_rev]
    c3 = torch.where(t_rev == 0, torch.zeros_like(c1), torch.sqrt(
        torch.clamp(sched.posterior_variance[t_rev], min=1e-20)))
    return torch.stack([c1, c2, c3], dim=1)


def eps_head_sample_loop(params: nn.ModuleList, cfg: EpsHeadConfig,
                         sched: DiffusionSchedule, cond: torch.Tensor,
                         generator: Optional[torch.Generator] = None, *,
                         y0: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The eager reverse chain of the eps-head with the first layer's
    cond and t-embedding terms hoisted out of the loop: the same math
    and draws as ``p_sample_loop`` with ``eps_head_apply``."""
    cond_h, temb_h, W1y = eps_head_tables(params, cfg, sched, cond)
    (_, (W2, b2), (W3, b3)) = [(l.w, l.b) for l in params]
    y, noise = _draws(generator, (cond.shape[0], cfg.pred_len), sched.T,
                      cond.device, cond.dtype, y0, noise)
    for i, t in enumerate(range(sched.T - 1, -1, -1)):
        h = torch.nn.functional.silu(y @ W1y.T + cond_h + temb_h[i])
        h = torch.nn.functional.silu(h @ W2.T + b2)
        eps_hat = h @ W3.T + b3
        mu = sched.sqrt_recip_alphas[t] * (
            y - sched.betas[t] * eps_hat / sched.sqrt_one_minus_alphas_bar[t])
        scale = 0.0 if t == 0 else torch.sqrt(torch.clamp(
            sched.posterior_variance[t], min=1e-20))
        y = mu + scale * noise[i]
    return y
