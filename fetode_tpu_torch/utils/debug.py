"""Numerical-safety debug utilities (counterpart of
``fetode_tpu/utils/debug.py``): an anomaly-detection context, a finite
check, a per-tensor health report, the device-init watchdog of the CLI,
and ``enable_compile_cache``, a logged no-op."""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import torch

from fetode_tpu_torch.utils.trees import tree_leaves


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly mode inside the context
    (``torch.autograd.detect_anomaly``): a backward op that produces NaN
    raises, naming the forward op that made it.  It checks the backward
    pass only, where the JAX package's ``jax_debug_nans`` checks every
    jitted op's output."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def check_finite(tree, name: str = "tree"):
    """Raise ``FloatingPointError`` naming the first tensor of ``tree`` (a
    tensor, module, or dict / list / tuple of them) with a non-finite
    value; return ``tree``."""
    for path, t in tree_leaves(tree):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}[{path}]")
    return tree


def tree_health(tree) -> dict:
    """Per tensor: ``max_abs`` and the count of non-finite values."""
    out = {}
    for path, t in tree_leaves(tree):
        t = t.detach()
        finite = torch.isfinite(t) if t.is_floating_point() \
            else torch.ones_like(t, dtype=torch.bool)
        out[path] = {
            "max_abs": float(t.abs().max()) if t.numel() else 0.0,
            "nonfinite": int((~finite).sum()),
        }
    return out


def device_init_watchdog(timeout_s: float = 300.0):
    """Fail fast if device initialisation hangs: a daemon thread exits the
    process (code 3) unless the returned ``disarm()`` is called within
    ``timeout_s``.  ``timeout_s <= 0`` disables it (the opt-out of
    ``FETODE_DEVICE_TIMEOUT``).  The CLI arms it around its first CUDA
    call."""
    if timeout_s <= 0:
        return lambda: None
    done = threading.Event()

    def watch():
        if not done.wait(timeout_s):
            print(f"FATAL: CUDA device init exceeded {timeout_s:.0f}s. Pin "
                  "the device with --device cpu, set FETODE_DEVICE_TIMEOUT=0 "
                  "to wait forever, or check the driver.", file=sys.stderr,
                  flush=True)
            os._exit(3)

    threading.Thread(target=watch, daemon=True).start()
    return done.set


def enable_compile_cache(path: str | None = None, log=print) -> str:
    """The JAX package points jax's persistent compilation cache at a
    directory.  The port compiles nothing at run time but its CUDA
    kernels, whose build directory (``ops/_build.py: BUILD_DIR``, keyed by
    a hash of the sources) is already the cache: this logs that and
    returns that directory; ``path`` is ignored."""
    from fetode_tpu_torch.ops._build import BUILD_DIR

    if log is not None:
        log(f"[compile cache] a no-op in the port: the CUDA kernels' build "
            f"directory {BUILD_DIR} is its cache"
            + (f" ({path!r} ignored)" if path else ""))
    return str(BUILD_DIR)
