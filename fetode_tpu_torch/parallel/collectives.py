"""The collectives the mesh uses, and ``shard_map_rows``: a function run
on each rank's block of rows, differentiable across the ranks
(counterpart of the JAX package's ``jax.shard_map`` with parameters
replicated and rows sharded).

Only ``dist.all_reduce`` and the list form of ``dist.all_gather`` are
called, whose names are the same across PyTorch versions.  Gloo reduces
CUDA tensors but is not counted on to gather them: a gather over a gloo
group stages the blocks through the CPU (two ranks sharing one card run
gloo; NCCL ranks gather on the card).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce_tensors(tensors: Sequence[torch.Tensor], group
                       ) -> List[torch.Tensor]:
    """Sum each tensor over ``group`` in place (one collective for all of
    them, flattened into one buffer); returns them."""
    tensors = list(tensors)
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return tensors


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    stage = src.is_cuda and _gloo(group)
    if stage:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if stage else out


class _Rows(torch.autograd.Function):
    """Forward: this rank's block of rows; backward: the blocks'
    cotangents gathered, so the global input gets its full cotangent."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.group = group
        return x.chunk(n)[index].clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group), None, None, None


class _Gather(torch.autograd.Function):
    """Forward: the blocks gathered into the global output (the same on
    every rank); backward: this rank's block of the cotangent (every rank
    computes the same loss from it)."""

    @staticmethod
    def forward(ctx, y, group, index, n):
        ctx.index, ctx.n = index, n
        return all_gather_cat(y, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n)[ctx.index].contiguous(), None, None, None


class _SumGrads(torch.autograd.Function):
    """Forward: the replicated parameters; backward: their gradients
    summed over the ranks in one all-reduce (the transpose of replicating
    them)."""

    @staticmethod
    def forward(ctx, group, *params):
        ctx.group = group
        ctx.like = [(p.shape, p.dtype, p.device) for p in params]
        return tuple(p.clone() for p in params)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None
                 else g.contiguous().clone()
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        all_reduce_tensors(grads, ctx.group)
        return (None, *grads)


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module's forward, for ``functional_call``."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, fn, *args):
        return fn(self.inner, *args)


def shard_map_rows(fn: Callable, mesh, params: nn.Module, *rows,
                   axis: str = "data"):
    """``fn(params, *local_rows) -> (b, ...)`` on this rank's block of the
    rows of every tensor of ``rows`` (leading axis sharded over ``axis``),
    with ``params`` replicated; returns the global output, gathered over
    ``axis``, on every rank.  Under autograd the output's cotangent is
    sliced back to each rank's block, each row input's cotangent is
    gathered, and the parameters' gradients are summed over ``axis`` —
    ``shard_map``'s transpose.  Every rank must call it with the same
    shapes, as every collective.  A row count that does not divide the
    axis raises, as the JAX package's sharded solves do.  An axis of one
    rank runs ``fn`` directly unless the mesh's process group is up (a
    world of one rank included): then the collectives run, as over
    many."""
    n = mesh.axis_size(axis)
    if n == 1 and not (mesh.live and dist.is_initialized()):
        return fn(params, *rows)
    for r in rows:
        if r is not None and r.shape[0] % n:
            raise ValueError(f"batch {r.shape[0]} not divisible by "
                             f"{axis}={n}")
    group, index = mesh.group(axis), mesh.axis_index(axis)
    local = [None if r is None else
             (_Rows.apply(r, group, index, n) if r.requires_grad
              else r.chunk(n)[index]) for r in rows]
    named = [(k, p) for k, p in params.named_parameters() if p.requires_grad]
    if torch.is_grad_enabled() and named:
        summed = _SumGrads.apply(group, *(p for _, p in named))
        swapped = {f"inner.{k}": t for (k, _), t in zip(named, summed)}
        out = functional_call(_Bound(params), swapped, (fn, *local))
    else:
        out = fn(params, *local)
    return _Gather.apply(out, group, index, n)
