"""The stateful ferro layer op, output and new branch state, as one CUDA
kernel with its plain PyTorch version.

Counterpart of ``fetode_tpu/ops/pallas_ferro.py: ferro_apply_fused`` (the
TPU kernel at :107, "drop-in fused version of ``ops.ferro.ferro_apply``
(no-noise path)").  The CUDA source is ``fetode_tpu_torch/csrc/
ferro_fused.cu``; its header gives the design and what bounds it.

* ``ferro_apply_fused(params, state, x, cfg)`` — the drop-in for
  ``ops/ferro.py: ferro_apply`` without noise: ``(y, new_state)``.  For
  CPU tensors it is ``ferro_apply`` itself, the plain version; for CUDA
  tensors it launches the kernel (counted in ``.launches``) or raises.
  On CUDA it is a ``torch.autograd.Function``: the forward is the kernel,
  the backward recomputes the plain op and takes its VJP, as the JAX
  package's custom VJP does (:198-211); the state gets no gradient.
* ``ferro_fused_vjp`` — that backward, usable on either device.

The kernel has no noise operand, as the TPU kernel has none: callers with
``cfg.noise_std > 0`` take ``ferro_apply``.  Unlike the TPU kernel, it
honours ``cfg.update_branch=False`` (the old branch is returned, as
``ferro_apply`` returns it).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.ferro import FerroConfig, FerroState, ferro_apply

_KERNEL_NAME = "ferro_fused"
_NAMES = ("k", "ec", "ps", "bias", "coef")
MAX_BASIS = 256        # K: a block's threads hold whole (o, K) groups
_STATE_DTYPES = (torch.float32, torch.bfloat16)


class _Params(NamedTuple):
    """The five parameter tensors, as ``ferro_basis`` reads them."""

    k: torch.Tensor
    ec: torch.Tensor
    ps: torch.Tensor
    bias: torch.Tensor
    coef: torch.Tensor


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ferro_fused.argtypes = [P] * 10 + [I] * 4 + [F] * 3 + [I, I, P]
    lib.ferro_fused.restype = ctypes.c_int
    return lib


def _check(params, state: FerroState, x: torch.Tensor, cfg: FerroConfig):
    """The batch size, checked: x (..., P), prev_x (..., P), branch (...,
    P, O, K), the parameters (P, O, K)."""
    shape = (cfg.in_dim, cfg.out_dim, cfg.num_basis)
    for name in _NAMES:
        if tuple(getattr(params, name).shape) != shape:
            raise ValueError(f"ferro_apply_fused: {name} must be {shape}, "
                             f"got {tuple(getattr(params, name).shape)}")
    lead = tuple(x.shape[:-1])
    if x.shape[-1:] != (cfg.in_dim,) or \
            tuple(state.prev_x.shape) != lead + (cfg.in_dim,) or \
            tuple(state.branch.shape) != lead + shape:
        raise ValueError(f"ferro_apply_fused: x {tuple(x.shape)}, prev_x "
                         f"{tuple(state.prev_x.shape)} and branch "
                         f"{tuple(state.branch.shape)} do not match "
                         f"(..., {cfg.in_dim}) and (..., *{shape})")
    return math.prod(lead)


def _launch(x, weights, prev_x, branch, cfg: FerroConfig):
    """One kernel launch: ``(y (B, O), new branch or None)`` from x (B, P)
    and the state flattened to B rows."""
    dev = x.device
    NC.check_cuda(x, "ferro_apply_fused")
    if cfg.gate_impl not in ("sigmoid", "tanh"):
        raise ValueError(f"FerroConfig.gate_impl={cfg.gate_impl!r}: "
                         "expected 'sigmoid' or 'tanh'")
    if cfg.num_basis > MAX_BASIS:
        raise ValueError(f"ferro_apply_fused kernel: num_basis "
                         f"{cfg.num_basis} exceeds {MAX_BASIS}")
    sdt = branch.dtype
    if sdt not in _STATE_DTYPES or prev_x.dtype != sdt:
        raise TypeError(f"ferro_apply_fused kernel: the state must be float32 "
                        f"or bfloat16 throughout, got prev_x {prev_x.dtype}, "
                        f"branch {sdt}")
    for t, name in ((prev_x, "prev_x"), (branch, "branch")):
        if t.device != dev:
            raise ValueError(f"ferro_apply_fused: {name} on {t.device}, x "
                             f"on {dev}")
    B, P = x.shape
    O, K = cfg.out_dim, cfg.num_basis
    xs = x.detach().contiguous()
    ws = [NC.kernel_operand(w, dev, f"ferro_apply_fused {n}")
          for w, n in zip(weights, _NAMES)]
    prev_x, branch = prev_x.detach().contiguous(), branch.detach().contiguous()
    y = torch.empty((B, O), dtype=torch.float32, device=dev)
    nb = torch.empty_like(branch) if cfg.update_branch else None
    g, a = float(cfg.gate_slope), float(cfg.alpha)
    NC.launch(_lib().ferro_fused, NC.ptr(xs), NC.ptr(prev_x),
              NC.ptr(branch), *(NC.ptr(w) for w in ws), NC.ptr(y),
              NC.ptr(nb), B, P, O, K, g, a, 1.0 - a,
              int(cfg.gate_impl == "tanh"), int(sdt == torch.bfloat16),
              name="ferro_apply_fused", device=dev)
    ferro_apply_fused.launches += 1
    return y, nb


def ferro_fused_vjp(ybar: torch.Tensor, x: torch.Tensor, weights,
                    prev_x: torch.Tensor, branch: torch.Tensor,
                    cfg: FerroConfig):
    """The backward of the layer op: recompute the plain ``ferro_apply``
    at the same inputs and take its VJP.  Returns ``(xbar, [kbar, ecbar,
    psbar, biasbar, coefbar])``."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in weights]
        y, _ = ferro_apply(_Params(*ws), FerroState(prev_x, branch), xs, cfg)
        grads = torch.autograd.grad(y, [xs] + ws, ybar)
    return grads[0], list(grads[1:])


class _FerroFused(torch.autograd.Function):
    """The kernel forward and the recomputing backward on flattened rows:
    ``(x, prev_x, branch, cfg, *weights) -> (y, new branch)``; the new
    branch (None when ``cfg.update_branch`` is False) has no gradient."""

    @staticmethod
    def forward(ctx, x, prev_x, branch, cfg, *weights):
        y, nb = _launch(x, weights, prev_x, branch, cfg)
        ctx.save_for_backward(x, prev_x, branch, *weights)
        ctx.cfg = cfg
        if nb is not None:
            ctx.mark_non_differentiable(nb)
        return y, nb

    @staticmethod
    def backward(ctx, ybar, _nbbar):
        x, prev_x, branch, *weights = ctx.saved_tensors
        xbar, wbars = ferro_fused_vjp(ybar, x, weights, prev_x, branch,
                                      ctx.cfg)
        return (xbar, None, None, None, *wbars)


def ferro_apply_fused(params, state: FerroState, x: torch.Tensor,
                      cfg: FerroConfig):
    """The ferro layer op without noise, ``ferro_apply``'s drop-in:
    ``y[..., o] = sum_{i,k} basis[..., i, o, k] coef[i, o, k]`` and the
    advanced state.  Returns ``(y, new_state)``; the new state keeps the
    state's dtype and carries no gradient.  One kernel launch for CUDA
    tensors; the plain ``ferro_apply`` for CPU tensors."""
    if cfg.noise_std > 0.0:
        raise ValueError("ferro_apply_fused has no noise operand (nor has "
                         "the TPU kernel): use ferro_apply for noise_std > 0")
    B = _check(params, state, x, cfg)
    if x.device.type == "cpu":
        return ferro_apply(params, state, x, cfg)
    P, O, K = cfg.in_dim, cfg.out_dim, cfg.num_basis
    lead = tuple(x.shape[:-1])
    weights = [getattr(params, n) for n in _NAMES]
    y, nb = _FerroFused.apply(x.reshape(B, P),
                              state.prev_x.reshape(B, P),
                              state.branch.reshape(B, P, O, K), cfg,
                              *weights)
    new_branch = nb.reshape(state.branch.shape) if cfg.update_branch \
        else state.branch
    return y.reshape(lead + (O,)), FerroState(
        prev_x=x.detach().to(state.prev_x.dtype), branch=new_branch)


ferro_apply_fused.launches = 0
