"""Check on the card that the fields' branch-free quotients give IEEE's
bits (``csrc/knot_quotient.cuh``: ``rcp_sigmoid``, the sigmoid's of the
KANFET fields and of B.4's ferro terms, and ``div_knot``), and
count where its ``sigmoid`` differs from plain float32's rounding of
1 / (1 + exp(-z)) (nvcc may contract the add into expf's last step).

    python -m fetode_tpu_torch.tools.quotient_check [--n 16777216]

Draws seeded operands on the card: sigmoid denominators 1 + x with x
log-uniform over [e^-30, e^90] plus 0, inf, 3e38 and 1e-30; knot
distances a uniform in [-12, 12] (the first 1,000 zero) over spans b
log-uniform in [e^-5, e^2]; sigmoid arguments 9a.  Prints the mismatch
count of each and exits 1 unless both quotients match everywhere.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 24)
    args = ap.parse_args(argv)
    import torch

    from fetode_tpu_torch.ops import _build

    src = Path(__file__).with_suffix(".cu")
    so = _build.BUILD_DIR / "quotient_check.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(so)).quotient_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    n = args.n
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.exp(torch.empty(n, device="cuda").uniform_(-30.0, 90.0,
                                                         generator=gen))
    x[:4] = torch.tensor([0.0, float("inf"), 3.0e38, 1e-30], device="cuda")
    a = torch.empty(n, device="cuda").uniform_(-12.0, 12.0, generator=gen)
    a[:1000] = 0.0
    b = torch.exp(torch.empty(n, device="cuda").uniform_(-5.0, 2.0,
                                                         generator=gen))
    bad = torch.zeros(3, dtype=torch.int32, device="cuda")
    rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), n, bad.data_ptr())
    if rc != 0:
        raise RuntimeError(f"quotient_check launch failed: CUDA error {rc}")
    r, q, s = (int(v) for v in bad.cpu())
    print(f"of {n} values: rcp_sigmoid vs 1/d (d < 2^126) {r} mismatches, "
          f"div_knot vs a/b {q}; sigmoid vs plain's rounding {s}",
          flush=True)
    return 0 if r == q == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
