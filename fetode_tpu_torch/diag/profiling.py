"""Profiling and timing (counterpart of ``fetode_tpu/diag/profiling.py``).

``trace`` records a ``torch.profiler`` trace, ``annotate`` names a range
in it, ``sync`` waits for the devices a tree's tensors live on and
``time_fn`` is the median time of a call.  On the H100's sandboxed
machine the profiler drops device events (empty or partial traces), so
kernel device times in this repo come from CUDA events
(``chip_smoke.py: queued_ms``), never from ``trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from fetode_tpu_torch.utils.trees import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (CPU, and CUDA where
    present) into ``log_dir/trace.json`` (Chrome / Perfetto format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range on the trace's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


def _cuda_devices(tree):
    return {t.device for _, t in tree_leaves(tree) if t.device.type == "cuda"}


def sync(tree):
    """Wait until the work on every CUDA device that holds a tensor of
    ``tree`` (a tensor, module, or dict / list / tuple of them) is done;
    return ``tree``."""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)
    return tree


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, each call synchronised.  Where the arguments or the
    warm-up's result lie on a CUDA device a call is timed with CUDA events
    around it (its launches and its device work), else by the host's
    clock."""
    out = None
    for _ in range(warmup):
        out = sync(fn(*args))
    cuda = bool(_cuda_devices((args, out)))
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            sync(fn(*args))
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
