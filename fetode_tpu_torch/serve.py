"""Model serving: bundles, bucketed batching, latency bench.

Counterpart of ``fetode_tpu/serve.py``.  A bundle directory holds the
parameters of any model (``params.pt``, its module's ``state_dict``) and
``meta.json`` (buckets, per-sample shape and dtype, and the fingerprint
of the world it was exported in).  ``load_servable`` loads the
parameters into a model skeleton that the caller builds (a module of the
same architecture), together with the function that serves them.  A
request is padded up to its bucket with copies of its last row; for a
model whose solve steps the whole batch under one controller (the ECG
classifier, the ETT forecasters) the padding rows enter the step
control, as in the JAX package.

Not carried over: ``AotCache`` / ``CachedJit`` and the serialized
per-bucket executables, which answer a TPU compile cost that eager
PyTorch does not have (the CUDA kernels build once per checkout), and
the portable-StableHLO fallback: a fingerprint mismatch raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["Servable", "export_servable", "fingerprint", "load_servable",
           "serve_bench"]

BENCH_WINDOWS = 3


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def fingerprint(device: torch.device) -> Dict[str, Any]:
    """The world a bundle was exported in: torch version, device name and
    device count."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    return {"torch": torch.__version__, "device_kind": _device_name(device),
            "n_devices": n}


def _device_of(params: nn.Module) -> torch.device:
    return next(params.parameters()).device


def export_servable(path: str, params: nn.Module,
                    example_batch: torch.Tensor, *,
                    buckets: Sequence[int] = (1, 8, 64)) -> Dict[str, Any]:
    """Write ``params``'s state and ``meta.json`` under ``path``.

    ``example_batch`` gives the per-sample shape and dtype; ``buckets``
    are the batch sizes requests are padded up to.
    """
    buckets = sorted(set(int(b) for b in buckets))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive, got {buckets}")
    os.makedirs(path, exist_ok=True)
    meta: Dict[str, Any] = {
        "fingerprint": fingerprint(_device_of(params)),
        "buckets": buckets,
        "sample_shape": list(example_batch.shape[1:]),
        "sample_dtype": str(example_batch.dtype).removeprefix("torch."),
    }
    torch.save(params.state_dict(), os.path.join(path, "params.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class Servable:
    """A loaded bundle: ``fn(params, batch)`` behind bucket padding and
    chunking.

    ``predict(x)`` for any leading batch size B:
      - B <= max bucket: pad to the smallest bucket >= B, one call, slice.
      - B >  max bucket: split into max-bucket chunks (last chunk padded).
    """

    def __init__(self, path: str, meta: Dict[str, Any], fn: Callable,
                 params: nn.Module):
        self.path = path
        self.meta = meta
        self.fn = fn
        self.params = params
        self.buckets = sorted(meta["buckets"])
        self.device = _device_of(params)

    def predict(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=getattr(torch, self.meta["sample_dtype"]),
                            device=self.device)
        B = x.shape[0]
        max_b = self.buckets[-1]
        outs = []
        off = 0
        with torch.no_grad():
            while off < B:
                take = min(max_b, B - off)
                chunk = x[off:off + take]
                bucket = next(b for b in self.buckets if b >= take)
                if take < bucket:  # pad with the last row (any valid row works)
                    pad = chunk[-1:].expand((bucket - take,) + chunk.shape[1:])
                    chunk = torch.cat([chunk, pad], dim=0)
                outs.append(self.fn(self.params, chunk.contiguous())[:take])
                off += take
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def load_servable(path: str, fn: Callable, params: nn.Module) -> Servable:
    """Load a bundle written by :func:`export_servable` into ``params`` (a
    model skeleton of the exported architecture, on the serving device)
    and serve it through ``fn(params, batch)``.

    Raises if the bundle was exported under another fingerprint (torch
    version, device name or device count).
    """
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    device = _device_of(params)
    here = fingerprint(device)
    if meta["fingerprint"] != here:
        raise RuntimeError(f"bundle {path} was exported under "
                           f"{meta['fingerprint']}, this process is {here}")
    state = torch.load(os.path.join(path, "params.pt"), map_location=device,
                       weights_only=True)
    params.load_state_dict(state)
    return Servable(path, meta, fn, params)


def serve_bench(servable: Servable, batch, *, iters: int = 30
                ) -> Dict[str, Any]:
    """Latency and throughput of ``servable.predict`` on a fixed batch.

    One warm call, then ``BENCH_WINDOWS`` windows of ``iters`` timed calls.  A
    call is timed from a synchronised device to its result copied to the
    host.  Returns p50/p99 over all timed calls, each window's p50, and
    the samples/s implied by the p50.
    """
    if iters < 1:
        raise ValueError(f"serve_bench needs iters >= 1, got {iters}")
    x = torch.as_tensor(batch, device=servable.device)
    cuda = servable.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(servable.device)

    servable.predict(x).cpu()
    window_ms = []
    for _ in range(BENCH_WINDOWS):
        times = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            servable.predict(x).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        window_ms.append(times)
    all_ms = np.concatenate(window_ms)
    p50 = float(np.percentile(all_ms, 50))
    return {
        "batch": int(x.shape[0]),
        "iters": iters,
        "windows": BENCH_WINDOWS,
        "p50_ms": p50,
        "p99_ms": float(np.percentile(all_ms, 99)),
        "window_p50_ms": [float(np.percentile(w, 50)) for w in window_ms],
        "throughput_sps": float(x.shape[0] / (p50 / 1e3)),
        "device": _device_name(servable.device),
    }
