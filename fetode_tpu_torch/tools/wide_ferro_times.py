"""Check and time B.3 (``csrc/kanfet_wide.cu``) and B.13
(``csrc/ferro_fused.cu``) of the package this file is imported from, on
one card.

    python -m fetode_tpu_torch.tools.wide_ferro_times [--tag NAME]

Run from the root of a checkout (it imports that checkout's
``chip_smoke`` for its inputs, bounds and timers).  To compare two
builds, copy this file into a ``git archive`` of the other commit and
run both from their roots in one call, in the order A, B, B, A.  It
builds the two kernels, then:

* B.3 at the preset tolerance (rtol 1e-7 / atol 1e-9, 256 steps, the 35
  fit times) and B = 1, at ``chip_smoke.WIDE_STACKS`` (ferro N = 512,
  4,608, 32,768), the init parameters: the forward's output and records
  the same bits twice, the output against plain's replay of the kernel's
  mesh (rtol = atol = ``TOL``), the backward's gradients the same bits
  twice; the time a call back to back (CUDA events, ``cuda_ms``) of the
  forward with records and of the backward on its records (the training
  loss's cotangent), the attempts, the bounds.
* B.13 at every ``RNN_SHAPES`` / ``SYM_SHAPES`` shape at B = 8 and 64, a
  float32 state after one call: y within 1e-4 of the plain op (of max
  |y|), the new branch within 1e-5, y and the branch the same bits twice;
  the device time a call on a full queue (``queued_ms``), the bound.
* The ECG recurrent models that take B.13, ``fepa_rnn`` and ``node_rnn``
  at ``ECGPreset``'s width (hidden 64, 12 bases, T = 96) and B = 8: a
  training step (forward, backward, clip, AdamW at learning rate 0) with
  the kernel and with the plain op (``chip_smoke.plain_ferro_layers``),
  CUDA events (``cuda_ms``, median of 5 windows), and B.13's launches a
  step; and the host's time a B.13 call at their shape (64 -> 64, K =
  12, B = 8), the wrapper and the launch: 200 calls back to back on an
  idle card, too few to fill the launch queue, on the host's clock.

Prints the card's name and power limit, one line a measurement, and a
last JSON line ``{"tag": ..., "wide": {...}, "ferro": {...}, "rnn":
{...}}``.  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def wide_part(cs, device, smi):
    import torch

    from fetode_tpu_torch.models.predprey import (
        PredPreyNODE,
        PredPreyTask,
        lotka_volterra_field,
    )
    from fetode_tpu_torch.ops import kanfet_wide as KW
    from fetode_tpu_torch.ops import node_common as NC
    from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5

    task = PredPreyTask()
    ts = torch.linspace(0.0, task.tf_learn, task.n_train,
                        dtype=torch.float32, device=device)
    x0 = torch.tensor([[task.x0, task.y0]], dtype=torch.float32,
                      device=device)
    target = odeint_dopri5(lotka_volterra_field(task), x0, ts, rtol=1e-8,
                           atol=1e-10, max_steps=2048, mode="while",
                           per_row=True).transpose(0, 1)
    preset = PredPreyNODE.kanfet()
    opts = dict(rtol=preset.rtol, atol=preset.atol,
                max_steps=preset.max_steps)
    out = {}
    for layers in cs.WIDE_STACKS:
        spec = PredPreyNODE.kanfet(layers_hidden=layers)
        params = cs.wide_params(spec, device, "init")
        w = KW.wide_weights(params)
        with torch.no_grad():
            y, recs = KW.kanfet_wide_fwd(w, spec.kan, x0, ts, **opts)
            y2, recs2 = KW.kanfet_wide_fwd(w, spec.kan, x0, ts, **opts)
            ref = NC.replay_traj_reference(KW.wide_field(w, spec.kan), x0,
                                           ts, recs)
        ct = 2.0 * (y - target) / y.numel()
        g1, xb1 = KW.kanfet_wide_bwd(w, spec.kan, x0, ts, recs, ct)
        g2, xb2 = KW.kanfet_wide_bwd(w, spec.kan, x0, ts, recs, ct)
        torch.cuda.synchronize()
        n = int(recs.misc[0])
        twice = (torch.equal(y, y2) and torch.equal(recs.tda, recs2.tda)
                 and torch.equal(recs.yrec[:n], recs2.yrec[:n])
                 and torch.equal(recs.krec[:n], recs2.krec[:n])
                 and all(torch.equal(a, b) for a, b in zip(g1 + [xb1],
                                                          g2 + [xb2])))
        err = cs.max_abs(y, ref)
        n_par = sum(t.numel() for t in w)
        with torch.no_grad():
            fwd = cs.cuda_ms(lambda: KW.kanfet_wide_fwd(w, spec.kan, x0, ts,
                                                        **opts), 5)
        bwd = cs.cuda_ms(lambda: KW.kanfet_wide_bwd(w, spec.kan, x0, ts,
                                                    recs, ct), 5)
        row = dict(
            fwd=fwd, bwd=bwd, attempts=int(recs.misc[0]), err=err,
            twice=twice,
            bound_fwd=cs.bound(*cs.kanfet_wide_counts(n_par, spec.kan, 1, ts,
                                                      recs, "fwd"))[0],
            bound_bwd=cs.bound(*cs.kanfet_wide_counts(n_par, spec.kan, 1, ts,
                                                      recs, "bwd"))[0])
        if not (twice and torch.allclose(y, ref, rtol=cs.TOL, atol=cs.TOL)):
            cs.fail(f"B.3 {list(layers)}: {row}")
        out[str(list(layers))] = row
        print(f"B.3 {list(layers)} B=1 preset: forward {fwd:.4f} ms, "
              f"backward {bwd:.4f} ms (cuda_ms), {row['attempts']} attempts; "
              f"bounds {row['bound_fwd']:.5f} / {row['bound_bwd']:.5f} ms; "
              f"max |diff| {err:.3e} on its mesh, the same bits twice "
              f"({smi})", flush=True)
    return out


def ferro_part(cs, device, smi):
    import numpy as np
    import torch

    from fetode_tpu_torch.ops import ferro_fused as FF
    from fetode_tpu_torch.ops.ferro import FerroConfig, ferro_apply, ferro_init

    rng = np.random.default_rng(39)
    out = {}
    for P, O, K in list(cs.RNN_SHAPES) + list(cs.SYM_SHAPES):
        cfg = FerroConfig(P, O, K)
        params = ferro_init(torch.Generator().manual_seed(2), cfg,
                            device=device)
        for B in (8, 64):
            state = cs.ferro_state_after(params, cfg, B, 1, torch.float32,
                                         device, rng)
            x = torch.from_numpy(rng.standard_normal((B, P)).astype(
                np.float32)).to(device)
            with torch.no_grad():
                y, s1 = FF.ferro_apply_fused(params, state, x, cfg)
                y2, s2 = FF.ferro_apply_fused(params, state, x, cfg)
                yp, sp = ferro_apply(params, state, x, cfg)
                ms = cs.queued_ms(lambda: FF.ferro_apply_fused(params, state,
                                                               x, cfg))
            torch.cuda.synchronize()
            err = cs.max_abs(y, yp)
            scale = float(yp.abs().max())
            row = dict(
                ms=ms, err=err,
                branch_err=cs.max_abs(s1.branch, sp.branch),
                twice=bool(torch.equal(y, y2)
                           and torch.equal(s1.branch, s2.branch)),
                bound=cs.bound(*cs.ferro_fused_counts(B, P, O, K, 4))[0])
            if not (row["twice"] and err <= 1e-4 + 1e-4 * scale
                    and row["branch_err"] <= 1e-5):
                cs.fail(f"B.13 ({P}->{O}, K={K}) B={B}: {row}")
            out[f"{P},{O},{K},{B}"] = row
            print(f"B.13 ({P}->{O}, K={K}) B={B}: {ms:.4f} device ms "
                  f"(queued_ms), bound {row['bound']:.5f} ms; y max |diff| "
                  f"{err:.3e}, the same bits twice ({smi})", flush=True)
    return out


def rnn_part(cs, device, smi):
    import copy

    import numpy as np
    import torch

    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.nn import rnn as TR
    from fetode_tpu_torch.ops import ferro_fused as FF
    from fetode_tpu_torch.ops.ferro import FerroConfig, ferro_init

    cfg = FerroConfig(64, 64, 12)
    fparams = ferro_init(torch.Generator().manual_seed(2), cfg,
                         device=device)
    state = cs.ferro_state_after(fparams, cfg, 8, 1, torch.float32, device,
                                 np.random.default_rng(39))
    xf = torch.ones((8, 64), device=device)
    host = []
    with torch.no_grad():
        FF.ferro_apply_fused(fparams, state, xf, cfg)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                FF.ferro_apply_fused(fparams, state, xf, cfg)
            host.append((time.perf_counter() - t0) / 200 * 1e3)
            torch.cuda.synchronize()
    out = {"host_ms": float(np.median(host))}
    print(f"B.13 (64->64, K=12) B=8: {out['host_ms']:.5f} ms of host time a "
          f"call (median of 5 runs of 200) ({smi})", flush=True)
    data = synthetic_ecg200()
    x = torch.from_numpy(data[0][:8].astype(np.float32)).to(device)
    y = torch.from_numpy(data[1][:8]).long().to(device)
    fcfg = TR.FerroKANRNNConfig(hidden_size=64, num_basis=12)
    nspec = M.NodeRNNSpec(hidden_size=64, num_basis=12)
    models = {
        "fepa_rnn": (TR.ferro_kan_rnn_init(torch.Generator().manual_seed(0),
                                           fcfg, device=device),
                     lambda p, xb: TR.ferro_kan_rnn_apply(p, fcfg, xb), 10),
        "node_rnn": (M.node_rnn_init(torch.Generator().manual_seed(0), nspec,
                                     device=device),
                     lambda p, xb: M.node_rnn_apply(p, nspec, xb), 2)}
    for name, (params, apply, reps) in models.items():
        fn = cs.rnn_step_fn(apply, copy.deepcopy(params), x, y)
        FF.ferro_apply_fused.launches = 0
        fn()
        torch.cuda.synchronize()
        launches = FF.ferro_apply_fused.launches
        if launches < 1:
            cs.fail(f"{name}: the step launched no B.13")
        row = dict(step=cs.cuda_ms(fn, reps, windows=5), launches=launches)
        with cs.plain_ferro_layers():
            row["plain_step"] = cs.cuda_ms(cs.rnn_step_fn(
                apply, copy.deepcopy(params), x, y), reps, windows=5)
        out[name] = row
        print(f"{name} training step B=8: {row['step']:.3f} ms with B.13 "
              f"({launches} launches a step), {row['plain_step']:.3f} ms "
              f"with the plain op (cuda_ms) ({smi})", flush=True)
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
    for name in ("kanfet_wide", "ferro_fused"):
        so = _build.build(name)
        _build.load_library(name)
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = dict(tag=args.tag, card=smi, wide=wide_part(cs, device, smi),
               ferro=ferro_part(cs, device, smi),
               rnn=rnn_part(cs, device, smi))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
