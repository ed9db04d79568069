"""Time the B.1 / B.2 kernels built from the checkout's ``csrc/`` against
builds of other copies of it, in one process on one card.

    python -m fetode_tpu_torch.tools.kanfet_ab VARIANT_DIR [VARIANT_DIR ...]

Each VARIANT_DIR holds its own ``kanfet_node.cu``, ``kanfet_adjoint.cu``
and ``kanfet_field.cuh`` (for example a copy of ``csrc/`` with one code
path taken out).  Run from the repo root (it imports ``chip_smoke`` for
``queued_ms``).  Every build is compiled at once; each variant's outputs
at the flagship [2, 10, 2] are compared bit for bit with the checkout's
(B.1, the B.2 forward with its records, the B.2 backward), then the
builds are timed in the order checkout, variants, variants reversed,
checkout: B.1 at B = 8 and 256 over 140 output times, the B.2 forward
and backward at B = 256 over 35, and B.1 on [2, 24, 24, 2] at B = 8.
Prints the card's name and power limit and one line a build and pass.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

NAMES = ("kanfet_node", "kanfet_adjoint")


def _build_all(variants):
    """{(build, name): CDLL}; the checkout's through ``_build``, each
    variant's into ``_build/ab/<n>/``, every nvcc started together."""
    from fetode_tpu_torch.ops import _build

    procs, libs = [], {}
    for v, src_dir in enumerate(variants):
        out_dir = _build.BUILD_DIR / "ab" / str(v)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in NAMES:
            so = out_dir / f"{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                   str(Path(src_dir) / f"{name}.cu")]
            procs.append((v, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name in NAMES:
        libs[("checkout", name)] = ctypes.CDLL(str(_build.build(name)))
    for v, name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variants[v]}/{name}.cu:\n"
                               f"{log}")
        libs[(variants[v], name)] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    variants = list(sys.argv[1:] if argv is None else argv)
    if not variants:
        print(__doc__)
        return 2
    import numpy as np
    import torch

    import chip_smoke as cs
    from fetode_tpu_torch.models.predprey import (PredPreyNODE,
                                                  predprey_init)
    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.ops import kanfet_node as kn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi, flush=True)
    libs = _build_all(variants)
    which = {"v": "checkout"}
    _build.load_library = lambda name: libs[(which["v"], name)]

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    spec = PredPreyNODE.kanfet()
    params = predprey_init(torch.Generator().manual_seed(0), spec, device=dev)
    x0s = torch.from_numpy(rng.uniform(0.5, 2.0, (256, 2))
                           .astype(np.float32)).to(dev)
    ts = torch.linspace(0.0, 14.0, 140, device=dev)
    ts_fit = torch.linspace(0.0, 3.5, 35, device=dev)
    kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    wide = PredPreyNODE.kanfet(layers_hidden=(2, 24, 24, 2))
    wide_p = predprey_init(torch.Generator().manual_seed(0), wide, device=dev)
    x8 = x0s[:8].contiguous()

    def run():
        with torch.no_grad():
            y1 = kn.kanfet_solve(params, spec.kan, x0s, ts, **kw)
            y2, rec = KA.kanfet_adjoint_fwd(params, spec.kan, x0s, ts_fit,
                                            **kw)
        ct = torch.sin(y2)
        g, xb = KA.kanfet_adjoint_bwd(params, spec.kan, x0s, ts_fit, rec, ct)
        torch.cuda.synchronize()
        return [y1, y2, rec.rec, rec.n_att, rec.t_end, *g, xb], rec, ct

    builds = ["checkout", *variants]
    res = {}
    for v in builds:
        which["v"] = v
        res[v] = run()
    for v in variants:
        same = all(torch.equal(a, b)
                   for a, b in zip(res["checkout"][0], res[v][0]))
        print(f"{v}: the checkout's bits (B.1, B.2 forward, records, "
              f"backward): {same}", flush=True)
    for v in builds + builds[::-1]:
        which["v"] = v
        _, rec, ct = res[v]
        with torch.no_grad():
            t8 = cs.queued_ms(lambda: kn.kanfet_solve(params, spec.kan, x8,
                                                      ts, **kw), n=10)
            t256 = cs.queued_ms(lambda: kn.kanfet_solve(params, spec.kan,
                                                        x0s, ts, **kw), n=10)
            tf = cs.queued_ms(lambda: KA.kanfet_adjoint_fwd(
                params, spec.kan, x0s, ts_fit, **kw), n=10)
            tw = cs.queued_ms(lambda: kn.kanfet_solve(wide_p, wide.kan, x8,
                                                      ts, **kw), n=3)
        tb = cs.queued_ms(lambda: KA.kanfet_adjoint_bwd(
            params, spec.kan, x0s, ts_fit, rec, ct), n=10)
        print(f"{v}: B.1 B=8 {t8:.4f} ms, B=256 {t256:.4f} ms; B.2 fwd "
              f"{tf:.4f} ms, bwd {tb:.4f} ms; B.1 [2,24,24,2] B=8 "
              f"{tw:.4f} ms ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
