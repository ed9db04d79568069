"""Clock builds of a kernel source: ``csrc/<name>.cu`` compiled with
``-D<NAME>_CLOCKS``, under which it counts thread 0's cycles a CTA in
``<name>_clocks`` (or another ``__device__`` array ``sym``; ``slots``
counters a CTA, at most 1,024 CTAs), with an accessor appended.  Used by ``tools/kuramoto_times.py --breakdown`` and
``tools/node_field_times.py --breakdown`` on the card; the wrapper's
library is swapped for the clock build for one call."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

ACCESS = """
extern "C" int {sym}_copy(long long* host, int n, int clear) {{
  static long long zeros[{slots} * 1024] = {{}};
  if (clear)
    return (int)cudaMemcpyToSymbol({sym}, zeros, sizeof(zeros));
  return (int)cudaMemcpyFromSymbol(host, {sym}, n * sizeof(long long));
}}
"""


def has_marks(name: str) -> bool:
    """Whether the checkout's ``csrc/<name>.cu`` has the clock marks."""
    from fetode_tpu_torch.ops import _build

    return f"{name.upper()}_CLOCKS" in (_build.SRC_DIR / f"{name}.cu"
                                        ).read_text()


def clock_library(name: str, slots: int, text: str | None = None,
                  sym: str | None = None):
    """Build and load the clock build of ``csrc/<name>.cu`` (or of ``text``
    in its place, the other sources beside it), its counters in ``sym``
    (``<name>_clocks`` by default)."""
    from fetode_tpu_torch.ops import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"{name}_clocks_"))
    shutil.copytree(_build.SRC_DIR, tmp / "csrc")
    src = tmp / "csrc" / f"{name}_clocks.cu"
    body = text if text is not None else (_build.SRC_DIR
                                          / f"{name}.cu").read_text()
    sym = sym or f"{name}_clocks"
    src.write_text(body + ACCESS.format(sym=sym, slots=slots))
    so = tmp / f"lib{name}_clocks.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-D{name.upper()}_CLOCKS", "-o", str(so),
                           str(src)], capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the clock build of {name}:\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"{sym}_copy")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return lib


def read_clocks(lib, name: str, slots: int, sym: str | None = None):
    """The counters of the CTAs that ran (a nonzero last slot, the whole
    kernel), one list of ``slots`` a CTA."""
    host = (ctypes.c_longlong * (slots * 1024))()
    sym = sym or f"{name}_clocks"
    if getattr(lib, f"{sym}_copy")(ctypes.addressof(host), slots * 1024, 0):
        raise RuntimeError(f"{name}: reading the clocks failed")
    return [host[slots * i:slots * (i + 1)] for i in range(1024)
            if host[slots * i + slots - 1] > 0]


def clear_clocks(lib, name: str, sym: str | None = None) -> None:
    if getattr(lib, f"{sym or name + '_clocks'}_copy")(None, 0, 1):
        raise RuntimeError(f"{name}: clearing the clocks failed")


def copy_signatures(lib, real, names) -> None:
    """The clock build's entry points take the real library's ctypes
    signatures."""
    for n in names:
        if hasattr(real, n):
            getattr(lib, n).argtypes = getattr(real, n).argtypes
            getattr(lib, n).restype = getattr(real, n).restype
