"""Process groups across ranks and hosts (counterpart of
``fetode_tpu/parallel/multihost.py``).

The JAX package starts its runtime with ``jax.distributed.initialize``
and lays a ('dcn', 'data', 'model') mesh over slices.  Here every rank is
a process: ``initialize_distributed`` joins it to the group
(``dist.init_process_group``; a no-op for one process unless it is
given where to meet) and places it on its card,
``make_multislice_mesh`` puts one 'dcn' index on each host, and
``spawn_local`` starts n ranks on this host from a function (``cli
--mesh N`` run alone).

The backend is ``nccl`` for CUDA ranks and ``gloo`` for CPU ranks; a
caller may name ``gloo`` for CUDA ranks, the one case in which ranks may
share a card (a rank beyond the card count then wraps round).  No
backend is ever swapped for another because one failed.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from fetode_tpu_torch.parallel.mesh import Mesh, Sharding, world


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize_distributed(init_method: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: str = "cuda",
                           backend: Optional[str] = None,
                           local_rank: Optional[int] = None) -> None:
    """Join this process to the group: ``init_method`` (``tcp://host:port``
    or ``file://path``; default ``env://``, as torchrun sets it),
    ``num_processes`` and ``process_id`` (default ``WORLD_SIZE`` /
    ``RANK``).  A no-op when already joined, and for one process unless
    an ``init_method`` is given: that makes a group of one rank, whose
    collectives run.

    ``device`` "cuda" places the rank on ``cuda:<local rank>`` (default
    ``LOCAL_RANK``, else the rank) with ``nccl``; more NCCL ranks on a
    host than cards raises.  "cpu" takes ``gloo``.  ``backend="gloo"``
    with CUDA ranks lets ranks share a card."""
    if dist.is_initialized():
        return
    n = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if n is None or n < 1 or (n == 1 and init_method is None):
        return
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("initialize_distributed: no process_id and no RANK")
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and not cuda:
        raise ValueError("the nccl backend needs CUDA ranks")
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA ranks requested but CUDA is not "
                               "available")
        lr = local_rank if local_rank is not None else (
            _env_int("LOCAL_RANK") if _env_int("LOCAL_RANK") is not None
            else rank)
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and lr >= n_cards:
            raise ValueError(f"NCCL rank with local rank {lr} but {n_cards} "
                             "card(s): one NCCL rank per card (gloo lets "
                             "ranks share a card)")
        torch.cuda.set_device(lr % n_cards)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=n, rank=rank)


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def hosts() -> int:
    """Hosts of the group: ``WORLD_SIZE / LOCAL_WORLD_SIZE`` (torchrun's
    variables), else 1."""
    n_world = world()[1]
    local = _env_int("LOCAL_WORLD_SIZE") or n_world
    if n_world % local:
        raise ValueError(f"{n_world} ranks not divisible by "
                         f"{local} ranks a host")
    return n_world // local


def make_multislice_mesh(model: int = 1) -> Mesh:
    """('dcn', 'data', 'model') mesh: one 'dcn' index a host, 'data' and
    'model' inside a host.  One host gives dcn = 1."""
    n_world = world()[1]
    if n_world == 1 and torch.cuda.is_available():
        n_world = torch.cuda.device_count()
    n_hosts = hosts()
    per_host = n_world // n_hosts
    if per_host % model:
        raise ValueError(f"{per_host} devices/slice not divisible by "
                         f"model={model}")
    return Mesh(("dcn", "data", "model"),
                (n_hosts, per_host // model, model))


def global_batch_sharding(mesh: Mesh) -> Sharding:
    """The batch over every data-parallel axis, ('dcn', 'data') jointly."""
    axes = tuple(a for a in ("dcn", "data") if a in mesh.axis_names)
    return Sharding(mesh, (axes,))


def _rank_entry(rank: int, fn: Callable, n: int, tmp: str, device: str,
                backend: Optional[str], args: Sequence):
    if torch.device(device).type == "cpu":
        # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(f"file://{os.path.join(tmp, 'store')}", n, rank,
                           device=device, backend=backend, local_rank=rank)
    try:
        result = fn(rank, *args)
    finally:
        shutdown_distributed()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def spawn_local(fn: Callable, n: int, args: Sequence = (), *,
                device: str = "cuda", backend: Optional[str] = None,
                timeout: Optional[float] = None) -> List:
    """Run ``fn(rank, *args)`` in ``n`` new processes on this host (start
    method ``spawn``, so they begin from a fresh interpreter with this
    one's ``sys.path``: ``fn`` must be importable, and the caller's main
    module must guard its work with ``if __name__ == "__main__"``), each
    joined to one group of ``n`` ranks through a file in a new temporary
    directory.  Returns the ranks' return values (pickled back), in rank
    order.  Raises if a rank fails or ``timeout`` seconds pass; every
    rank is stopped before it returns."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, n, tmp, device, backend, tuple(args)),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None else
                               max(0.0, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks did not finish within "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
