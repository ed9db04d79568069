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
* ``slice_plan(P, O, K)`` — the kernel's launch plan, from the layer's
  shape alone: a thread owns one (o, k) column and one contiguous slice
  of the inputs, and y's sums run in an order that no batch size moves;
  ``samples_per_block`` — how many samples a block takes at a batch.

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
SLICE_INPUTS = 8       # the most inputs a thread walks, where columns allow
BLOCK_THREADS = 256    # the threads a block aims at
MAX_THREADS = 1024     # csrc/ferro_fused.cu: kMaxThreads


class SlicePlan(NamedTuple):
    """B.13's launch plan: ``S`` input slices of ``L`` inputs (the last
    may be shorter), ``chunk`` outputs a block, ``threads`` a block and
    ``smem`` bytes of shared memory."""

    S: int
    L: int
    chunk: int
    threads: int
    smem: int          # a sample's: a block takes samples_per_block times it


@functools.lru_cache(maxsize=None)
def slice_plan(P: int, O: int, K: int) -> SlicePlan:
    """The plan of a (P -> O, K) layer, independent of the batch: slices
    of at most ``SLICE_INPUTS`` inputs, and more, shorter ones (down to
    one input) while a sample has fewer than ``BLOCK_THREADS`` (o, k, slice)
    threads; at most ``MAX_THREADS // K`` slices, so one output's threads
    fit a block; then as many outputs a block as ``BLOCK_THREADS`` holds,
    spread evenly over the blocks of a sample."""
    S = max(-(-P // SLICE_INPUTS), -(-BLOCK_THREADS // (O * K)))
    S = max(1, min(S, P, MAX_THREADS // K))
    L = -(-P // S)
    S = -(-P // L)
    per = max(1, BLOCK_THREADS // (K * S))
    n_chunks = -(-O // per)
    chunk = -(-O // n_chunks)
    threads = -(-(S * chunk * K) // 32) * 32
    return SlicePlan(S, L, chunk, threads, 4 * (2 * P + S * chunk * K))


MAX_GROUP = 4          # csrc/ferro_fused.cu: kMaxGroup
GROUP_BLOCKS = 512     # the blocks a group size must leave (about 4 an SM)


def samples_per_block(B: int, n_chunks: int) -> int:
    """The samples a block takes: the most of 4, 2, 1 that still leaves
    ``GROUP_BLOCKS`` blocks of ``n_chunks`` a sample group, else one (at B
    = 8 and 64 -> 64, K = 12: one, 256 blocks), so a thread loads its
    parameters once for that many samples.  Each sample's sums keep the
    slice plan's order, so the group moves no bit of y."""
    for g in (MAX_GROUP, 2):
        if -(-B // g) * n_chunks >= GROUP_BLOCKS:
            return g
    return 1


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
    lib.ferro_fused.argtypes = [P] * 10 + [I] * 4 + [F] * 3 + [I] * 8 + [P]
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
    plan = slice_plan(P, O, K)
    NC.launch(_lib().ferro_fused, NC.ptr(xs), NC.ptr(prev_x),
              NC.ptr(branch), *(NC.ptr(w) for w in ws), NC.ptr(y),
              NC.ptr(nb), B, P, O, K, g, a, 1.0 - a,
              int(cfg.gate_impl == "tanh"), int(sdt == torch.bfloat16),
              *plan, samples_per_block(B, -(-O // plan.chunk)),
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
