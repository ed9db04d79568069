"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path — the predprey KANFET serving path — on the
card and checks it, in phases that run in order; any failure exits
non-zero.

1. Device: CUDA must be present; prints the card's name and power limit.
2. Build: compiles every kernel of the path from ``fetode_tpu_torch/csrc``.
3. Kernel against its plain PyTorch version on the card, flagship
   parameters from a seed, B=256 initial conditions from U[0.5, 2.0], the
   140-point serving horizon: all points finite, rtol = atol = 1e-3 on
   the first 40 (the JAX package's own kernel tolerance).  Repeated with
   an attempt budget of max_steps=8, where each trajectory stops early.
4. The slice: ``cli.main(["serve", "--source", "predprey", "--solver_mode",
   "pallas", ...])`` with buckets (8, 64, 256), then requests of B = 1,
   100 and 300 through the loaded bundle; their outputs must equal direct
   kernel calls, and every kernel of the path must have launched.
5. Timing: kernel and plain times at B = 8, 64 and 256.

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error and times.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 1e-3          # rtol = atol, on the first N_CHECK output times
N_CHECK = 40
T_SERVE = 140
HORIZON = 14.0


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def frontier(y):
    """Per row, the first output index from which the trajectory holds one
    state to the end (where a truncated solve stopped)."""
    moving = ~np.all(y == y[:, -1:, :], axis=-1)            # (B, T)
    last = np.where(moving.any(axis=1),
                    moving.shape[1] - 1 - np.argmax(moving[:, ::-1], axis=1),
                    -1)
    return last + 1


def cuda_ms(fn, reps, windows=3):
    """Median over windows of the per-call time of ``fn``, CUDA events."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / reps)
    return float(np.median(per_call))


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.models.predprey import PredPreyNODE, predprey_init
    from fetode_tpu_torch.nn.kan import KAN
    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.ops.kanfet_node import (
        kanfet_solve,
        kanfet_solve_reference,
    )
    from fetode_tpu_torch.serve import load_servable
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")

    # ---- 2. build
    t0 = time.perf_counter()
    so = _build.build("kanfet_node")
    _build.load_library("kanfet_node")
    print(f"built {so.name} in {time.perf_counter() - t0:.1f}s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel against plain on the card
    spec = PredPreyNODE.kanfet()
    params = predprey_init(torch.Generator().manual_seed(0), spec,
                           device=device)
    rng = np.random.default_rng(0)
    x0s = torch.from_numpy(rng.uniform(0.5, 2.0, (256, 2)).astype(np.float32)
                           ).to(device)
    ts = torch.linspace(0.0, HORIZON, T_SERVE, dtype=torch.float32,
                        device=device)
    kw = dict(rtol=spec.rtol, atol=spec.atol)
    with torch.no_grad():
        out_k = kanfet_solve(params, spec.kan, x0s, ts,
                             max_steps=spec.max_steps, **kw)
        torch.cuda.synchronize()
        out_r = kanfet_solve_reference(params, spec.kan, x0s, ts,
                                       max_steps=spec.max_steps, **kw)
    yk, yr = out_k.cpu().numpy(), out_r.cpu().numpy()
    if yk.shape != (x0s.shape[0], T_SERVE, 2) or not np.isfinite(yk).all():
        fail(f"kernel output shape {yk.shape} or non-finite values")
    if not np.isfinite(yr).all():
        fail("plain output has non-finite values")
    max_abs_err = float(np.abs(yk - yr).max())
    err40 = float(np.abs(yk[:, :N_CHECK] - yr[:, :N_CHECK]).max())
    print(f"kernel vs plain, B=256, T={T_SERVE}: max |diff| {max_abs_err:.3e} "
          f"(first {N_CHECK} points: {err40:.3e})")
    if not np.allclose(yk[:, :N_CHECK], yr[:, :N_CHECK], rtol=TOL, atol=TOL):
        fail(f"kernel disagrees with plain on the first {N_CHECK} points")

    # max_steps=8: every row runs out of attempts.  At rtol 1e-7 the f32
    # error estimate of the first step sits at its rounding floor, so two
    # correct implementations reach slightly different times within 8
    # attempts (the JAX package's own kernel and eager solve differ there
    # too).  Both must stop early; the points both reached must agree.
    with torch.no_grad():
        yk8 = kanfet_solve(params, spec.kan, x0s, ts, max_steps=8,
                           **kw).cpu().numpy()
        yr8 = kanfet_solve_reference(params, spec.kan, x0s, ts, max_steps=8,
                                     **kw).cpu().numpy()
    fk, fr = frontier(yk8), frontier(yr8)
    if not (np.isfinite(yk8).all() and (fk < T_SERVE).all()
            and (fr < T_SERVE).all()):
        fail("max_steps=8: a trajectory did not stop early or is not finite")
    both = np.arange(T_SERVE)[None, :] < np.minimum(fk, fr)[:, None]
    err8 = float(np.abs(yk8 - yr8)[both].max()) if both.any() else 0.0
    print(f"max_steps=8: frontier kernel {fk.min()}..{fk.max()}, plain "
          f"{fr.min()}..{fr.max()}, max |diff| where both reached {err8:.3e}")
    if not np.allclose(yk8[both], yr8[both], rtol=TOL, atol=TOL):
        fail("max_steps=8: kernel disagrees with plain where both reached")

    # ---- 4. the slice, through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["serve", "--source", "predprey", "--solver_mode", "pallas",
                "--device", "cuda", "--buckets", "8,64,256",
                "--out-dir", tmp]
        kanfet_solve.launches = 0
        result = cli.main(argv)
        cfg = make_config("serve", cli._parse(argv)[1])
        _, fn, _ = cli.predprey_serving(cfg, device)
        sv = load_servable(result["bundle"], fn, KAN(spec.kan, device=device))
        requests = {b: torch.from_numpy(
            rng.uniform(0.5, 2.0, (b, 2)).astype(np.float32)).to(device)
            for b in (1, 100, 300)}
        served = {b: sv.predict(x) for b, x in requests.items()}
        torch.cuda.synchronize()
        launches = kanfet_solve.launches
        if launches < 1:
            fail("the served path launched no kanfet_node kernel")
        with torch.no_grad():
            for b, x in requests.items():
                direct = fn(sv.params, x)
                if served[b].shape != (b, T_SERVE, 2) or \
                        not torch.equal(served[b], direct):
                    fail(f"request B={b}: served output differs from a "
                         "direct kernel call")
                if not torch.isfinite(served[b]).all():
                    fail(f"request B={b}: non-finite output")
    print(f"served B=1/100/300 through the bundle = direct kernel calls; "
          f"{launches} kernel launches on the main path")
    for row in result["bench"]:
        print(f"  serve bucket {row['batch']}: p50 {row['p50_ms']:.3f} ms, "
              f"p99 {row['p99_ms']:.3f} ms, window p50s "
              f"{['%.3f' % w for w in row['window_p50_ms']]}")

    # ---- 5. timing, kernel and plain
    times = {}
    with torch.no_grad():
        for b in (8, 64, 256):
            xb = x0s[:b].contiguous()
            ms = cuda_ms(lambda: kanfet_solve(params, spec.kan, xb, ts,
                                              max_steps=spec.max_steps, **kw),
                         reps=20)
            plain = cuda_ms(lambda: kanfet_solve_reference(
                params, spec.kan, xb, ts, max_steps=spec.max_steps, **kw),
                reps=1)
            times[b] = (ms, plain)
            print(f"time B={b}: kernel {ms:.4f} ms, plain {plain:.3f} ms "
                  f"({smi})")

    print(json.dumps({"kernels": [{
        "name": "kanfet_node_solve",
        "route": "cuda",
        "source": "fetode_tpu_torch/csrc/kanfet_node.cu",
        "replaces": "fetode_tpu/ops/pallas_node.py:260",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": times[256][0],
        "plain_ms": times[256][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
