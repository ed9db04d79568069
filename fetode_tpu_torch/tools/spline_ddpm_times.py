"""Check and time B.12 (``csrc/spline.cu``) and B.9 (``csrc/ddpm.cu``) of
the package this file is imported from, on one card.

    python -m fetode_tpu_torch.tools.spline_ddpm_times [--tag NAME]

Run from the root of a checkout (it imports that checkout's
``chip_smoke`` for its inputs, bounds and timers).  To compare two
builds, copy this file into a ``git archive`` of the other commit and
run both from their roots in one call, in the order A, B, B, A.  It
builds the two kernels, then:

* B.12 at every ``chip_smoke.SPLINE_TIMED`` shape: y against the plain
  basis-and-product (rtol = atol = ``SPLINE_TOL``), the same bits twice
  and rows 0, R/2 and R-1 alone as inside the batch; the device time a
  call on a full queue (``queued_ms``) of the kernel and of
  ``torch.matmul`` of the product alone on precomputed bases; the bound.
* B.9 at 80, 640, 970 and 2,560 rows (phase 15's tables): the chain
  against ``ddpm_chain_reference`` (rtol = atol = ``TOL``), the same bits
  twice and rows 0 and R-1 alone as inside the batch; the time a call
  back to back (CUDA events, phase 18's ``cuda_ms``); the bound; the row
  tile the kernel takes (``ops/ddpm.py: chain_tile``, where it exists).

Prints the card's name and power limit, one line a measurement, and a
last JSON line ``{"tag": ..., "spline": {...}, "ddpm": {...}}``.  Exits
non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def spline_part(cs, device, smi):
    import numpy as np
    import torch

    from fetode_tpu_torch.ops import spline as SP
    from fetode_tpu_torch.ops.bsplines import bspline_basis

    rng = np.random.default_rng(43)
    out = {}
    for R, I, O, sl in cs.SPLINE_TIMED:
        x, w, s, grid, _ = cs.spline_layer(device, rng, R, I, O, sl)
        with torch.no_grad():
            sw = (w * s[..., None])[:, sl[0]:sl[0] + I, :] if sl else \
                w * s[..., None]
            y = SP.spline_matmul_fused(x, grid, sw, 3)
            y2 = SP.spline_matmul_fused(x, grid, sw, 3)
            yp = SP.spline_matmul_reference(x, grid, sw, 3)
            alone = [torch.equal(SP.spline_matmul_fused(
                x[r:r + 1], grid, sw, 3), y[r:r + 1])
                for r in sorted({0, R // 2, R - 1})]
            bases = bspline_basis(x, grid, 3).reshape(R, -1)
            w2 = sw.reshape(O, -1)
            row = dict(
                err=cs.max_abs(y, yp), twice=bool(torch.equal(y, y2)),
                alone=all(alone),
                ms=cs.queued_ms(lambda: SP.spline_matmul_fused(x, grid, sw,
                                                               3)),
                matmul=cs.queued_ms(lambda: torch.matmul(bases, w2.T)),
                bound=cs.bound(*cs.spline_counts(R, I, O))[0])
        if not (torch.allclose(y, yp, rtol=cs.SPLINE_TOL, atol=cs.SPLINE_TOL)
                and row["twice"] and row["alone"]):
            cs.fail(f"B.12 R={R} {I}->{O}: {row}")
        out[f"{R},{I},{O}"] = row
        print(f"B.12 R={R} {I}->{O}: kernel {row['ms']:.4f} ms, matmul of "
              f"the product alone {row['matmul']:.4f} ms (queued_ms), bound "
              f"{row['bound']:.5f} ms; max |diff| {row['err']:.3e}, the "
              f"same bits twice and alone ({smi})", flush=True)
    return out


def ddpm_part(cs, device, smi):
    import numpy as np
    import torch

    from fetode_tpu_torch.models import forecasting as F
    from fetode_tpu_torch.nn import diffusion as TD
    from fetode_tpu_torch.ops import ddpm as DD

    wins = cs.forecast_windows()
    dspec = F.DiffusionForecasterSpec(num_features=wins.shape[2], diff_T=200)
    dparams = F.diffusion_forecaster_init(torch.Generator().manual_seed(0),
                                          dspec, device=device)
    sched = TD.make_schedule(dspec.diff_T, device=device)
    out = {}
    for r in (80, 640, 970, 2560):
        x = torch.from_numpy(wins[(11 * r + np.arange(r // 10))
                                  % len(wins)]).to(device)
        chain = cs.ddpm_case(dparams, dspec, sched, x, r)["chain"]
        with torch.no_grad():
            got, got2 = DD.ddpm_chain(*chain), DD.ddpm_chain(*chain)
            want = DD.ddpm_chain_reference(*chain)
            alone = []
            for i in (0, r - 1):
                one = list(chain)
                one[0], one[1] = chain[0][i:i + 1], chain[1][i:i + 1]
                one[3] = chain[3][:, i:i + 1]
                alone.append(torch.equal(DD.ddpm_chain(*one), got[i:i + 1]))
        torch.cuda.synchronize()
        tile = getattr(DD, "chain_tile", None)
        row = dict(tile=tile(r, dspec.pred_len, dspec.diff_hidden,
                             dspec.diff_T) if tile else None,
                   err=cs.max_abs(got, want),
                   twice=bool(torch.equal(got, got2)), alone=all(alone),
                   ms=cs.cuda_ms(lambda: DD.ddpm_chain(*chain), 5),
                   bound=cs.bound(*cs.ddpm_counts(
                       r, dspec.pred_len, dspec.diff_hidden,
                       dspec.diff_T))[0])
        if not (torch.allclose(got, want, rtol=cs.TOL, atol=cs.TOL)
                and row["twice"] and row["alone"]):
            cs.fail(f"B.9 rows={r}: {row}")
        out[str(r)] = row
        print(f"B.9 rows={r}: kernel {row['ms']:.4f} ms (cuda_ms), bound "
              f"{row['bound']:.5f} ms; tile {row['tile']}; max |diff| "
              f"{row['err']:.3e}, the same bits twice and alone ({smi})",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="checkout")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; {args.tag}", flush=True)
    t0 = time.perf_counter()
    for name in ("spline", "ddpm"):
        so = _build.build(name)
        _build.load_library(name)
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = dict(tag=args.tag, card=smi, spline=spline_part(cs, device, smi),
               ddpm=ddpm_part(cs, device, smi))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
