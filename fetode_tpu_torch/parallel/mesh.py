"""Device mesh and sharding rules on ``torch.distributed`` (counterpart of
``fetode_tpu/parallel/mesh.py``).

The JAX package names a ('data', 'model') mesh over its devices and lets
GSPMD derive the collectives from the placements.  Here a rank is one
process with one device, and the mesh is the ranks laid out row-major
over its axes (rank = data index * model + model index), with one
process group per axis (the ranks that differ only in that axis).  What
GSPMD derives is written out:

* a batch sharded over 'data' is each rank's block of rows
  (``shard_batch_leaves``; a leaf whose rows do not divide stays whole on
  every rank, as the JAX rule leaves it replicated, and the step counts
  it once);
* parameters are replicated unless a spec names 'model' on one of their
  axes; then each rank stores its block of that axis and the module's
  full tensor is gathered from the blocks after every optimiser step
  (``shard_params`` -> ``Placement``);
* the gradient step (``Placement.backward``): where the rows are sharded
  (``shard_rows``: every rank its own block, the 'model' ranks of a data
  index splitting its rows) each rank backpropagates its share of the
  global mean and the gradients are summed over all ranks (the
  reduce-scatter over 'model' and the all-reduce over 'data' in one
  all-reduce), a model-sharded leaf keeping its block; where every rank
  computes the whole batch nothing is summed.  The global-norm clip sums
  the blocks' squares over the model group.

Specs are plain tuples with one entry per tensor axis: ``("model",
None)`` shards axis 0 over 'model', ``()`` is replicated.

A mesh made without a process group of its size (the pytest process, a
single run) is a layout only: its rules work, and a collective on it
raises, naming how to start the ranks.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from fetode_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_tensors,
)

Spec = Tuple[Optional[str], ...]
REPLICATED: Spec = ()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_rank0() -> bool:
    """True on the process that logs and writes files (rank 0, or the only
    process)."""
    return world()[0] == 0


class Mesh:
    """Named axes over the ranks, row-major; ``shape`` maps each axis to
    its size.  Process groups are made on first use, one per axis (or
    tuple of axes) and coordinate of the others, by every rank in the
    same order, as every collective is."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        if len(self.axis_names) != len(self.sizes):
            raise ValueError("one size per axis name")
        self.size = math.prod(self.sizes)
        rank, n_world = world()
        self.live = n_world == self.size
        self.rank = rank if self.live else 0
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The coordinates of ``rank`` (default: this process's)."""
        r = self.rank if rank is None else rank
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.sizes)):
            out[name] = r % size
            r //= size
        return {name: out[name] for name in self.axis_names}

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r}: {self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over them)."""
        c, idx = self.coords(), 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group of this rank along ``axes`` (None when the
        axes span the whole world: the default group)."""
        axes = self._axes(axes)
        if self.axis_size(axes) > 1 and not self.live:
            rank, n_world = world()
            raise RuntimeError(
                f"a collective over {axes} needs a process group of "
                f"{self.size} ranks, this process has {n_world}: start the "
                "ranks with torchrun (or `cli ... --mesh N`) and "
                "parallel.initialize_distributed")
        if self.axis_size(axes) == self.size:
            return None
        if axes not in self._groups:
            # dist.new_group is collective over the world: every rank makes
            # every group of this axis, in the same order.
            mine = None
            others = [a for a in self.axis_names if a not in axes]
            seen = {}
            for r in range(self.size):
                c = self.coords(r)
                seen.setdefault(tuple(c[a] for a in others), []).append(r)
            for ranks in seen.values():
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"{'live' if self.live else 'layout only'})")


def make_mesh(n_devices: Optional[int] = None, *, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """Build a ('data', 'model') mesh of ``n_devices`` ranks (default: the
    world's size).  ``model`` splits off a tensor-parallel axis; ``data``
    is ``n_devices // model`` when not given."""
    n = n_devices or world()[1]
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data * model} != {n} devices")
    return Mesh(("data", "model"), (data, model))


def driver_mesh(n_devices: int, model: int = 1) -> Optional[Mesh]:
    """The mesh of a driver's ``mesh_devices`` / ``mesh_model`` knobs:
    None for 0, else a mesh that must have its process group (raises
    otherwise, before any work)."""
    if not n_devices:
        return None
    mesh = make_mesh(n_devices, model=model)
    if mesh.size > 1:
        mesh.group(mesh.axis_names)     # raises without a live group
    return mesh


class Sharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``); ``local``
    cuts this rank's block out of a global tensor."""

    def __init__(self, mesh: Mesh, spec: Spec):
        self.mesh, self.spec = mesh, tuple(spec)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        for dim, axes in enumerate(self.spec):
            if axes is None:
                continue
            n, i = self.mesh.axis_size(axes), self.mesh.axis_index(axes)
            if x.shape[dim] % n:
                raise ValueError(f"axis {dim} of {tuple(x.shape)} not "
                                 f"divisible by {axes}={n}")
            x = x.chunk(n, dim)[i]
        return x

    def __repr__(self):
        return f"Sharding({self.mesh.shape}, {self.spec})"


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch / trajectory) axis over the data axis."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, REPLICATED)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch_leaves(tree, mesh: Mesh, *, batch_axis: int = 0,
                       axis: str = "data"):
    """This rank's block of every tensor leaf, cut along ``batch_axis``
    over the mesh ``axis``.  A leaf whose ``batch_axis`` does not exist or
    does not divide the axis size stays whole (replicated), which keeps
    ragged eval splits legal; the gradient step then counts it once
    (``Placement.backward``)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)

    def put(x):
        if (isinstance(x, torch.Tensor) and x.ndim > batch_axis
                and x.shape[batch_axis] % n == 0):
            return x.chunk(n, batch_axis)[i] if n > 1 else x
        return x

    return _tree_map(put, tree)


def shard_rows(tree, mesh: Mesh, *, batch_axis: int = 0):
    """``shard_batch_leaves`` over every axis of the mesh: each rank its
    own block of the rows, as a ``grad_sum`` step takes them (the 'model'
    ranks of a data index split its rows instead of computing them
    twice)."""
    return shard_batch_leaves(tree, mesh, batch_axis=batch_axis,
                              axis=mesh.axis_names)


def parse_mesh_flag(flag: str) -> Tuple[int, int]:
    """Parse a ``--mesh`` value: ``"data=4,model=2"``, ``"4"`` (pure DP)
    or ``"auto"`` (the world's ranks, else every visible card, pure DP).
    Returns ``(n_devices, model)``."""
    flag = flag.strip()
    if flag in ("auto", ""):
        n = world()[1]
        if n == 1 and torch.cuda.is_available():
            n = torch.cuda.device_count()
        return n, 1
    if "=" not in flag:
        return int(flag), 1
    kv = dict(part.split("=") for part in flag.split(","))
    data = int(kv.get("data", 1))
    model = int(kv.get("model", 1))
    return data * model, model


def _layer_leaves(layer) -> Dict[str, torch.Tensor]:
    if isinstance(layer, nn.Module):
        leaves = dict(layer.named_parameters())
        leaves.update(layer.named_buffers())
        return leaves
    return dict(layer)


def kan_param_specs(layer) -> Dict[str, Spec]:
    """Specs of one KAN layer (a ``KANLinear`` or its dotted-name dict):
    output features over 'model', everything small replicated.

    base_weight (out, in)      -> ('model', None)
    spline_weight (out, in, C) -> ('model', None, None)
    spline_scaler (out, in)    -> ('model', None)
    logistic.weight (out, inK) -> ('model', None); logistic.scaler
                                  (out,) -> ('model',)
    ferro.* (in, out, K)       -> (None, 'model', None)
    grid and the rest          -> replicated
    """
    specs: Dict[str, Spec] = {}
    for name, leaf in _layer_leaves(layer).items():
        if name in ("base_weight", "spline_scaler", "logistic.weight"):
            specs[name] = ("model", None)
        elif name == "spline_weight":
            specs[name] = ("model", None, None)
        elif name == "logistic.scaler":
            specs[name] = ("model",)
        elif name.startswith("ferro."):
            specs[name] = (None, "model", None)
        else:
            specs[name] = REPLICATED
    return specs


def kan_stack_param_specs(params) -> Dict[str, Spec]:
    """``kan_param_specs`` of every layer of a ``KAN`` (or a list of
    layers), keyed ``layers.<i>.<name>`` as its ``named_parameters``."""
    layers = params.layers if isinstance(params, nn.Module) else params
    return {f"layers.{i}.{k}": s for i, layer in enumerate(layers)
            for k, s in kan_param_specs(layer).items()}


def model_param_specs(tree, mesh: Mesh, *, axis: str = "model"
                      ) -> Dict[str, Spec]:
    """Generic tensor-parallel placement: shard axis 0 (output features,
    by the (out, in) weight convention) of every float leaf with ndim >=
    2 whose leading dimension divides the model-axis size; replicate the
    rest (biases, grids, scalars, integer buffers).  ``tree``: a module
    (its parameters and buffers) or a dict of tensors; returns specs
    under the same names.  A ``model`` = 1 mesh replicates everything."""
    n = mesh.axis_size(axis)
    leaves = _layer_leaves(tree)

    def spec(x):
        if (n > 1 and isinstance(x, torch.Tensor) and x.ndim >= 2
                and x.is_floating_point() and x.shape[0] % n == 0):
            return (axis,) + (None,) * (x.ndim - 1)
        return REPLICATED

    return {k: spec(v) for k, v in leaves.items()}


class Placement:
    """A module's parameters placed on a mesh (what ``shard_params``
    returns) and the gradient step over it.

    ``parameters()`` are what the optimiser steps: each model-sharded
    parameter's block (a leaf tensor of this rank's rows of the spec's
    'model' axis) and every replicated parameter itself.  ``gather()``
    writes the blocks back into the module's full tensors (an all-gather
    over the model group); the train step calls it after every optimiser
    step, so the module always holds the current parameters.

    ``grad_sum``: the rows of the batch are sharded over every rank
    (``shard_rows``), so ``backward`` takes each rank's share of the
    global mean and sums the gradients over the ranks; False when every
    rank computes the whole batch (nothing to sum)."""

    def __init__(self, module: nn.Module, mesh: Mesh,
                 specs: Optional[Dict[str, Spec]] = None, *,
                 grad_sum: bool = False):
        self.module, self.mesh, self.grad_sum = module, mesh, grad_sum
        self.n_model = mesh.axis_size("model") if "model" in \
            mesh.axis_names else 1
        self.blocks: Dict[str, Tuple[torch.Tensor, int]] = {}
        specs = specs or {}
        for name, p in module.named_parameters():
            spec = specs.get(name, REPLICATED)
            if "model" in spec and self.n_model > 1:
                dim = spec.index("model")
                if p.shape[dim] % self.n_model:
                    raise ValueError(f"{name} {tuple(p.shape)}: axis {dim} "
                                     f"not divisible by model="
                                     f"{self.n_model}")
                blk = Sharding(mesh, spec).local(p.detach()).clone()
                self.blocks[name] = (blk.requires_grad_(p.requires_grad),
                                     dim)
        self._block_ids = {id(b) for b, _ in self.blocks.values()}

    def parameters(self) -> List[torch.Tensor]:
        return [self.blocks[n][0] if n in self.blocks else p
                for n, p in self.module.named_parameters()]

    def is_block(self, t: torch.Tensor) -> bool:
        return id(t) in self._block_ids

    def _cut(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a whole leaf's ``x`` along ``dim``."""
        return Sharding(self.mesh, (None,) * dim + ("model",)).local(x)

    @torch.no_grad()
    def gather(self) -> None:
        if not self.blocks:
            return
        group = self.mesh.group("model")
        params = dict(self.module.named_parameters())
        for name, (blk, dim) in self.blocks.items():
            params[name].copy_(all_gather_cat(blk, group, dim))

    @torch.no_grad()
    def scatter(self) -> None:
        """Cut every block anew out of the module's full tensor (after the
        module's parameters were loaded from a checkpoint)."""
        params = dict(self.module.named_parameters())
        for name, (blk, dim) in self.blocks.items():
            blk.copy_(self._cut(params[name], dim))

    def _map_moments(self, opt_state: dict, params, fn) -> dict:
        dims = {id(b): d for b, d in self.blocks.values()}
        state = {}
        for i, st in opt_state["state"].items():
            d = dims.get(id(params[i]))
            state[i] = st if d is None else {
                k: fn(v, d) if v.ndim else v for k, v in st.items()}
        return dict(opt_state, state=state)

    def whole_state(self, opt_state: dict, params) -> dict:
        """An optimiser ``state_dict`` over ``params`` (``parameters()``)
        with every block's moments gathered into the whole leaf's shape
        over the model group: what a checkpoint holds, the same on every
        rank.  A collective: every rank calls it."""
        if not self.blocks:
            return opt_state
        group = self.mesh.group("model")
        return self._map_moments(
            opt_state, params, lambda v, d: all_gather_cat(v, group, d))

    def own_state(self, opt_state: dict, params) -> dict:
        """The reverse of ``whole_state``: each block's rows of a whole
        state's moments."""
        if not self.blocks:
            return opt_state
        return self._map_moments(opt_state, params,
                                 lambda v, d: self._cut(v, d).clone())

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """Backpropagate ``loss`` (this rank's loss: of its rows with
        ``grad_sum``, else of the whole batch) and leave the gradients of
        ``parameters()`` as the global ones.  Returns the global loss,
        detached.

        With ``grad_sum`` every rank backpropagates its share (its local
        mean over the number of ranks) and the full gradients are summed
        over all ranks in one all-reduce: the reduce-scatter over 'model'
        and the all-reduce over 'data' of the JAX package's transpose at
        once.  A model-sharded leaf then keeps its block.  Without it the
        ranks computed the same thing, and the block is the rank's slice
        of its own gradient."""
        n = self.mesh.size if self.grad_sum else 1
        (loss / n if n > 1 else loss).backward()
        params = [(name, p) for name, p in self.module.named_parameters()
                  if p.requires_grad]
        for _, p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if n > 1:
            group = self.mesh.group(self.mesh.axis_names)
            all_reduce_tensors([p.grad for _, p in params], group)
            loss = all_reduce_tensors([loss / n], group)[0]
        for name, p in params:
            if name in self.blocks:
                blk, dim = self.blocks[name]
                blk.grad = self._cut(p.grad, dim).clone()
                p.grad = None
        return loss

    def sq_norm(self, grads: Iterable[torch.Tensor],
                params: Iterable[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the gradients of ``params``: the
        replicated leaves' squares plus the blocks' squares summed over the
        model group."""
        rep, blk = [], []
        for g, p in zip(grads, params):
            (blk if self.is_block(p) else rep).append(g.square().sum())
        total = sum(rep) if rep else torch.zeros(())
        if self.blocks:
            b = sum(blk) if blk else torch.zeros_like(total)
            total = total + all_reduce_tensors(
                [b], self.mesh.group("model"))[0]
        return total


def shard_params(params: nn.Module, mesh: Mesh, specs=None, *,
                 grad_sum: bool = False) -> Placement:
    """Place a module's parameters on the mesh (replicated by default;
    ``specs`` from ``kan_stack_param_specs`` / ``model_param_specs``
    shard leaves over 'model').  Pass the result to ``make_optimizer`` as
    its ``params``; see ``Placement``."""
    return Placement(params, mesh, specs, grad_sum=grad_sum)


def place_params(params: nn.Module, mesh: Optional[Mesh], *,
                 grad_sum: bool = False):
    """What a driver's optimiser steps on its mesh (``driver_mesh``): the
    module's parameters without a mesh, else a ``Placement``, the
    weights' output features over 'model' when the mesh has a 'model' axis
    of more than one rank (``model_param_specs``).  By default every rank
    computes the whole batch (nothing summed; the JAX package's GSPMD
    keeps the single-device math); ``grad_sum`` when the driver shards the
    rows over 'data'.  A checkpoint holds the whole optimiser state
    (``Placement.whole_state``)."""
    if mesh is None:
        return params.parameters()
    model = mesh.shape.get("model", 1)
    specs = model_param_specs(params, mesh) if model > 1 else None
    return shard_params(params, mesh, specs, grad_sum=grad_sum)
