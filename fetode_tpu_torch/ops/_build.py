"""Build and load the hand-written CUDA kernels of ``fetode_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher.  It is
compiled with ``nvcc`` into a shared library under
``fetode_tpu_torch/_build/`` (listed in ``.gitignore``) on first use and
loaded with ``ctypes``; nothing is compiled at import.  The library's
file name carries a hash of the sources and flags, so a changed source
is rebuilt and a fresh checkout builds its own.  ``nvcc``'s output,
including ``-Xptxas -v``'s register and spill report, is kept beside
the library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "fetode_tpu_torch need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return path


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.iterdir()):        # headers count too
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(src.name.encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    return the library's path."""
    src = SRC_DIR / f"{name}.cu"
    so = BUILD_DIR / f"{name}-{_digest(src)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)        # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    return ctypes.CDLL(str(build(name)))
