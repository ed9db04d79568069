"""The whole DDPM reverse chain of the MLP eps-head forecaster, all T
steps in one CUDA kernel.

Counterpart of ``fetode_tpu/ops/pallas_ddpm.py: pallas_eps_head_sample``
(the TPU kernels ``_make_kernel`` :40 and ``_make_kernel_fm`` :59).  The
CUDA source is ``fetode_tpu_torch/csrc/ddpm.cu``; its header gives the
design and what bounds it: a thread-block cluster of four CTAs owns a
tile of rows for all T steps, each CTA keeps its quarter of W2 (and of
the other tables) in shared memory, and the CTAs exchange the hidden
activations and the eps partials through distributed shared memory.
Every sum runs in an order set by P and H alone, so a row gives the
same bits alone and inside any batch, and every call the same bits.

* ``ddpm_chain`` — the kernel wrapper, with a launch counter
  (``.launches``): the chain over prepared tables.  For CPU tensors it
  takes the plain version ``ddpm_chain_reference``; it never falls back
  from a CUDA tensor.
* ``eps_head_sample`` — the sampler of ``pallas_eps_head_sample``: the
  host side makes the tables (cond_h, the t-embedding terms in loop
  order, the coefficients) and draws y0 and the noise from a
  ``torch.Generator`` (or takes them), folds ``n_samples`` samples into
  the rows (row s*B + b, cond_h tiled, as the TPU wrapper folds them,
  :135-142) and runs ``ddpm_chain`` once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fetode_tpu_torch.nn.diffusion import (
    DiffusionSchedule,
    EpsHeadConfig,
    chain_coefficients,
    eps_head_tables,
)
from fetode_tpu_torch.ops import node_common as NC

_KERNEL_NAME = "ddpm"


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ddpm_chain.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.ddpm_chain.restype = ctypes.c_int
    lib.ddpm_chain_tile.argtypes = [I] * 4 + [P]
    lib.ddpm_chain_tile.restype = ctypes.c_int
    return lib


def chain_tile(rows: int, P: int, H: int, T: int) -> dict:
    """The kernel's row tile for a chain on the current CUDA device: rows
    a cluster (``rt``), threads a CTA, the four-CTA clusters the device
    runs at once with that tile, and a CTA's shared memory in bytes."""
    out = (ctypes.c_int * 4)()
    rc = _lib().ddpm_chain_tile(rows, P, H, T, out)
    if rc != 0:
        raise RuntimeError(f"ddpm_chain_tile: CUDA error {rc}")
    return dict(rt=out[0], threads=out[1], clusters=out[2],
                smem_bytes=out[3])


def ddpm_chain_reference(y0, cond_h, temb_h, noise, coefs, w1y, w2, b2, w3,
                         b3) -> torch.Tensor:
    """The plain chain: ``y0`` (rows, P), ``cond_h`` (rows, H), ``temb_h``
    (T, H) and ``noise`` (T, rows, P) in loop order, ``coefs`` (T, 3);
    ``w1y`` (H, P), ``w2`` (H, H), ``w3`` (P, H) as the eps-head holds
    them -> (rows, P)."""
    silu = torch.nn.functional.silu
    y = y0
    for i in range(noise.shape[0]):
        h = silu(y @ w1y.T + cond_h + temb_h[i])
        h = silu(h @ w2.T + b2)
        eps = h @ w3.T + b3
        y = coefs[i, 0] * y - coefs[i, 1] * eps + coefs[i, 2] * noise[i]
    return y


def _check(y0, cond_h, temb_h, noise, coefs, w1y, w2, b2, w3, b3) -> None:
    rows, P = y0.shape
    H = w2.shape[0]
    T = temb_h.shape[0]
    want = {"cond_h": (rows, H), "temb_h": (T, H), "noise": (T, rows, P),
            "coefs": (T, 3), "w1y": (H, P), "w2": (H, H), "b2": (H,),
            "w3": (P, H), "b3": (P,)}
    got = dict(cond_h=cond_h, temb_h=temb_h, noise=noise, coefs=coefs,
               w1y=w1y, w2=w2, b2=b2, w3=w3, b3=b3)
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ddpm_chain: {name} must be {shape} for y0 "
                             f"{tuple(y0.shape)} and H = {H}, got "
                             f"{tuple(got[name].shape)}")


def ddpm_chain(y0: torch.Tensor, cond_h: torch.Tensor, temb_h: torch.Tensor,
               noise: torch.Tensor, coefs: torch.Tensor, w1y: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
               b3: torch.Tensor) -> torch.Tensor:
    """The reverse chain of ``ddpm_chain_reference`` as one kernel launch
    on CUDA; the plain version for CPU tensors.  No autograd."""
    args = (y0, cond_h, temb_h, noise, coefs, w1y, w2, b2, w3, b3)
    _check(*args)
    if y0.device.type == "cpu":
        return ddpm_chain_reference(*args)
    NC.check_cuda(y0, "ddpm_chain")
    rows, P = y0.shape
    H, T = w2.shape[0], temb_h.shape[0]
    if H not in (32, 64, 128, 256) or P > 32:
        raise ValueError(f"ddpm_chain kernel: H must be 32, 64, 128 or 256 "
                         f"and P at most 32, got H = {H}, P = {P}")
    dev = y0.device
    ops = [NC.kernel_operand(t, dev, f"ddpm_chain operand {i}") for i, t in
           enumerate((y0, cond_h, temb_h, noise, coefs, w1y.T, w2.T, b2, w3,
                      b3))]
    out = torch.empty((rows, P), dtype=torch.float32, device=dev)
    NC.launch(_lib().ddpm_chain, *(NC.ptr(t) for t in ops), NC.ptr(out),
              rows, P, H, T, name="ddpm_chain", device=dev)
    ddpm_chain.launches += 1
    return out


ddpm_chain.launches = 0


def eps_head_sample(params, cfg: EpsHeadConfig, sched: DiffusionSchedule,
                    cond: torch.Tensor,
                    generator: Optional[torch.Generator] = None, *,
                    n_samples: int = 1, y0: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample forecasts, the whole reverse chain in one kernel.

    Returns (B, pred_len), or (n_samples, B, pred_len) when ``n_samples``
    > 1.  ``y0`` (S, B, P) and ``noise`` (S, T, B, P), each sample's
    start and per-step draws, are drawn from ``generator`` in that order
    unless given.
    """
    S, B, P, T = n_samples, cond.shape[0], cfg.pred_len, sched.T
    kw = dict(generator=generator, device=cond.device, dtype=cond.dtype)
    if y0 is None:
        y0 = torch.randn((S, B, P), **kw)
    if noise is None:
        noise = torch.randn((S, T, B, P), **kw)
    with torch.no_grad():
        cond_h, temb_h, w1y = eps_head_tables(params, cfg, sched, cond)
        out = ddpm_chain(
            y0.reshape(S * B, P), cond_h.repeat(S, 1), temb_h,
            noise.transpose(0, 1).reshape(T, S * B, P),
            chain_coefficients(sched).to(cond.dtype), w1y, params[1].w,
            params[1].b, params[2].w, params[2].b)
    return out if S == 1 else out.reshape(S, B, P)
