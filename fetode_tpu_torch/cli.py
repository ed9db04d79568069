"""Command-line entry point: ``python -m fetode_tpu_torch.cli <workload>
[--k v]`` (counterpart of ``fetode_tpu/cli.py``).

Same workload names and ``--key value`` overrides as the JAX package's
CLI, so one command line drives either package.  Ported so far:
``serve --source predprey``, which builds the predprey KANFET NODE,
exports a serving bundle, loads it back and reports p50/p99 latency per
batch bucket.  The other workloads and serve sources raise an error
naming the ROADMAP item that ports them.  ``--device cuda`` (the
default) without CUDA raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

WORKLOADS = ("predprey", "ecg", "ett", "cond_diffusion", "timemmd", "mnist",
             "symbolic", "serve")

# Where each workload / serve source not yet ported is queued.
_WORKLOAD_TODO = {
    "predprey": "ROADMAP A.5 (predprey drivers)",
    "ecg": "ROADMAP A.7 (ECG)",
    "ett": "ROADMAP A.8 (forecasting)",
    "timemmd": "ROADMAP A.8 (forecasting)",
    "cond_diffusion": "ROADMAP A.9 (conditional diffusion)",
    "mnist": "ROADMAP A.10 (Kuramoto-MNIST and symbolic)",
    "symbolic": "ROADMAP A.10 (Kuramoto-MNIST and symbolic)",
}
_SOURCE_TODO = {
    "ecg": "ROADMAP A.7 (ECG)",
    "ett": "ROADMAP A.8 (forecasting)",
    "ddpm": "ROADMAP A.8 (forecasting) and B.9 (pallas_ddpm)",
    "cond_diffusion": "ROADMAP A.9 (conditional diffusion)",
    "mnist": "ROADMAP A.10 (Kuramoto-MNIST) and B.10-B.11 (pallas_kuramoto)",
}


def _parse(argv):
    p = argparse.ArgumentParser(prog="fetode_tpu_torch", description=__doc__)
    from fetode_tpu_torch import __version__
    p.add_argument("--version", action="version",
                   version=f"fetode-tpu-torch {__version__}")
    p.add_argument("workload", choices=WORKLOADS)
    p.add_argument("--out-dir", default="runs/latest")
    p.add_argument("--plots", action="store_true", help="save plot artifacts")
    args, unknown = p.parse_known_args(argv)
    overrides = {}
    key = None
    for tok in unknown:
        if tok.startswith("--"):
            if key is not None:          # previous flag had no value: boolean
                overrides[key] = "true"
            key = tok[2:].replace("-", "_")
        elif key is not None:
            overrides[key] = tok
            key = None
        else:
            p.error(f"unexpected argument {tok!r}")
    if key is not None:                  # trailing valueless flag
        overrides[key] = "true"
    return args, overrides


def predprey_serving(cfg, device: torch.device):
    """The predprey serving function: ``(params, fn, example)`` with fresh
    parameters from ``cfg.seed`` and ``fn(params, x0s) -> (B, T, 2)``
    trajectories over ``linspace(0, horizon, n_points)``."""
    from fetode_tpu_torch.models.predprey import (
        PredPreyNODE,
        predict_batch,
        predprey_init,
    )
    from fetode_tpu_torch.ops.kanfet_node import kanfet_solve

    spec = PredPreyNODE.kanfet()
    params = predprey_init(torch.Generator().manual_seed(cfg.seed), spec,
                           device=device)
    ts = torch.linspace(0.0, cfg.horizon, cfg.n_points, dtype=torch.float32,
                        device=device)
    if cfg.solver_mode == "pallas":
        # The batched whole-solve kernel: the production serving path.
        def fn(p, x0s):
            return kanfet_solve(p, spec.kan, x0s, ts, rtol=spec.rtol,
                                atol=spec.atol, max_steps=spec.max_steps)
    else:
        eval_spec = spec._replace(solver_mode=cfg.solver_mode)

        def fn(p, x0s):
            return predict_batch(p, eval_spec, x0s, ts)
    example = torch.ones((1, 2), dtype=torch.float32, device=device)
    return params, fn, example


def run_serve(cfg, out_dir, plots):
    """Export a serving bundle, load it back and bench it per bucket."""
    from fetode_tpu_torch.nn.kan import KAN
    from fetode_tpu_torch.serve import export_servable, load_servable, serve_bench
    from fetode_tpu_torch.utils.device import resolve_device

    if cfg.source != "predprey":
        raise NotImplementedError(
            f"serve source {cfg.source!r} is not ported yet: "
            f"{_SOURCE_TODO.get(cfg.source, 'unknown source')}")
    if cfg.ckpt_dir:
        raise NotImplementedError("serving a training checkpoint needs the "
                                  "training drivers: ROADMAP A.5")
    device = resolve_device(cfg.device)
    params, fn, example = predprey_serving(cfg, device)

    bundle = cfg.bundle_dir or os.path.join(out_dir, "bundle")
    t0 = time.perf_counter()
    meta = export_servable(bundle, params, example, buckets=cfg.buckets)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sv = load_servable(bundle, fn, KAN(params.cfg, device=device))
    load_s = time.perf_counter() - t0
    print(f"bundle {bundle}: export {export_s:.2f}s, load {load_s:.2f}s "
          f"on {meta['fingerprint']['device_kind']}")

    bench = []
    for b in meta["buckets"]:
        x = example.expand((b,) + tuple(example.shape[1:]))
        row = serve_bench(sv, x, iters=cfg.iters)
        print(f"  bucket {b}: p50 {row['p50_ms']:.2f} ms  "
              f"p99 {row['p99_ms']:.2f} ms  "
              f"{row['throughput_sps']:.0f} samples/s")
        bench.append(row)
    return {"source": cfg.source, "bundle": bundle,
            "buckets": meta["buckets"], "fingerprint": meta["fingerprint"],
            "export_s": export_s, "load_s": load_s, "bench": bench}


RUNNERS = {
    "serve": run_serve,
}


def main(argv=None):
    from fetode_tpu_torch.config import make_config

    args, overrides = _parse(argv if argv is not None else sys.argv[1:])
    if args.workload not in RUNNERS:
        raise NotImplementedError(f"workload {args.workload!r} is not ported "
                                  f"yet: {_WORKLOAD_TODO[args.workload]}")
    cfg = make_config(args.workload, overrides)
    os.makedirs(args.out_dir, exist_ok=True)
    print(f"workload={args.workload} config={cfg}")
    result = RUNNERS[args.workload](cfg, args.out_dir, args.plots)
    with open(os.path.join(args.out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
