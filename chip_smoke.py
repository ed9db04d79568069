"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main paths — predprey KANFET serving and training — on
the card and checks them, in phases that run in order; any failure exits
non-zero.

1. Device: CUDA must be present; prints the card's name and power limit.
2. Build: compiles every kernel of the paths from ``fetode_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together.
3. Serving kernel against its plain PyTorch version on the card, flagship
   parameters from a seed, B=256 initial conditions from U[0.5, 2.0], the
   140-point serving horizon: all points finite, rtol = atol = 1e-3 on
   the first 40 (the JAX package's own kernel tolerance).  Repeated with
   an attempt budget of max_steps=8, where each trajectory stops early.
4. The serving slice: ``cli.main(["serve", "--source", "predprey",
   "--solver_mode", "pallas", ...])`` with buckets (8, 64, 256), then
   requests of B = 1, 100 and 300 through the loaded bundle; their
   outputs must equal direct kernel calls, and the serving kernel must
   have launched.
5. Timing of the serving kernel and its plain version at B = 8, 64, 256.
6. Training kernels against their plain versions, B = 256 (U[0.5, 2.0])
   and B = 1 (the task's x0), the 35 fit times, targets from the LV
   field: the forward at rtol = atol = 1e-3, all finite; the backward on
   the forward kernel's own records against autograd of the plain replay
   of the same records, relative error < 1e-4 over all parameter
   gradients and over x0bar; the full kernel gradient against the full
   plain gradient, each on its own step mesh, cosine > 0.999.
7. The training slice: ``cli.main(["predprey", "--device", "cuda",
   "--solver_mode", "pallas", "--epochs", "200", "--epochs_per_call",
   "100"])`` and ``train_traj_parallel`` at n_traj = 256: both training
   kernels must have launched, the losses must be finite and fall.
8. Timing of a training step's forward, backward and whole step
   (forward + backward + Adam), kernels and plain, at B = 1 and 256.

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error and times.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL = 1e-3          # rtol = atol, on the first N_CHECK output times
N_CHECK = 40
T_SERVE = 140
HORIZON = 14.0
GRAD_TOL = 1e-4     # relative, kernel vs plain replay on one step mesh
COS_MIN = 0.999     # kernel vs plain gradient, each on its own mesh
KERNELS = ("kanfet_node", "kanfet_adjoint")


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


def flat(grads):
    return torch.cat([g.reshape(-1) for g in grads])


def rel_err(a, b):
    return float((a - b).norm() / b.norm())


def check_training_kernels(params, spec, x0s, ts, targets):
    """Phase 6 at one batch: returns (forward max |diff|, shared-mesh
    relative gradient error, x0bar relative error, own-mesh cosine)."""
    from fetode_tpu_torch.ops import kanfet_adjoint as KA

    B = x0s.shape[0]
    kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    with torch.no_grad():
        out_k, rec_k = KA.kanfet_adjoint_fwd(params, spec.kan, x0s, ts, **kw)
        torch.cuda.synchronize()
        out_p, _ = KA.record_attempts_reference(params, spec.kan, x0s, ts,
                                                **kw)
    yk, yp = out_k.cpu().numpy(), out_p.cpu().numpy()
    if not (np.isfinite(yk).all() and np.isfinite(yp).all()):
        fail(f"B={B}: non-finite training forward output")
    fwd_err = float(np.abs(yk - yp).max())
    if not np.allclose(yk, yp, rtol=TOL, atol=TOL):
        fail(f"B={B}: training forward kernel disagrees with plain "
             f"(max |diff| {fwd_err:.3e})")

    # The backward on the kernel's own records, against autograd of the
    # plain replay of the same records.
    ybar = 2.0 * (out_k - targets) / out_k.numel()
    g_k, xb_k = KA.kanfet_adjoint_bwd(params, spec.kan, x0s, ts, rec_k, ybar)
    g_p, xb_p = KA.replay_vjp_reference(params, spec.kan, x0s, ts, rec_k,
                                        ybar)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in g_k):
        fail(f"B={B}: non-finite kernel gradients")
    g_err, x_err = rel_err(flat(g_k), flat(g_p)), rel_err(xb_k, xb_p)
    if not (g_err < GRAD_TOL and x_err < GRAD_TOL):
        fail(f"B={B}: backward kernel vs plain replay on the kernel's mesh: "
             f"param grads rel {g_err:.3e}, x0bar rel {x_err:.3e}")

    # Full gradients, each solve on its own mesh.
    def full(solve):
        weights = KA.train_weights(params)
        loss = torch.mean((solve(params, spec.kan, x0s, ts, **kw)
                           - targets) ** 2)
        return flat(torch.autograd.grad(loss, weights))

    gk, gp = full(KA.kanfet_solve_train), full(KA.kanfet_solve_train_reference)
    cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
    if not cos > COS_MIN:
        fail(f"B={B}: own-mesh gradient cosine {cos:.6f}")
    print(f"training kernels vs plain, B={B}: forward max |diff| "
          f"{fwd_err:.3e}; backward on the kernel's mesh: grads rel "
          f"{g_err:.3e}, x0bar rel {x_err:.3e}; own-mesh cosine {cos:.7f}; "
          f"attempts {int(rec_k.n_att.min())}..{int(rec_k.n_att.max())}")
    return fwd_err, g_err, x_err, cos


def time_training(params, spec, x0s, ts, targets, smi):
    """Phase 8 at one batch: CUDA-event ms of forward, backward, Adam and
    a whole step, kernels and plain."""
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    B = x0s.shape[0]
    res = {}
    for name, solve, reps in (("kernel", KA.kanfet_solve_train, 5),
                              ("plain", KA.kanfet_solve_train_reference, 1)):
        p = copy.deepcopy(params)
        weights = KA.train_weights(p)
        fwd = cuda_ms(lambda: solve(p, spec.kan, x0s, ts, **kw), reps)
        out = solve(p, spec.kan, x0s, ts, **kw)
        ybar = 2.0 * (out.detach() - targets) / out.numel()
        bwd = cuda_ms(lambda: torch.autograd.grad(out, weights, ybar,
                                                  retain_graph=True), reps)

        def loss_fn(q, x, tgt):
            return torch.mean((solve(q, spec.kan, x, ts, **kw) - tgt) ** 2)

        # lr = 0: Adam does all its work, but every timed step solves
        # with the same parameters, on the same step mesh as fwd and bwd.
        state = init_state(p, make_optimizer(0.0, params=p.parameters(),
                                             grad_clip=1.0))
        step = make_train_step(loss_fn)
        whole = cuda_ms(lambda: step(state, x0s, targets), reps)
        adam = cuda_ms(state.opt.step, 20)
        res[name] = dict(fwd=fwd, bwd=bwd, adam=adam, step=whole)
        print(f"time B={B} {name}: forward {fwd:.3f} ms, backward "
              f"{bwd:.3f} ms, Adam+clip {adam:.3f} ms, whole step "
              f"{whole:.3f} ms ({smi})")
    return res


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
    from fetode_tpu_torch.models.predprey import (
        PredPreyNODE,
        PredPreyTask,
        generate_data,
        lotka_volterra_field,
        predprey_init,
        trajectory_loss,
    )
    from fetode_tpu_torch.nn.kan import KAN
    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.ops.kanfet_adjoint import (
        kanfet_adjoint_bwd,
        kanfet_adjoint_fwd,
    )
    from fetode_tpu_torch.ops.kanfet_node import (
        kanfet_solve,
        kanfet_solve_reference,
    )
    from fetode_tpu_torch.serve import load_servable
    from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
    from fetode_tpu_torch.train.traj_driver import (
        TrajParallelRun,
        train_traj_parallel,
    )
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")

    # ---- 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(_build.build, KERNELS))
    for name, so in zip(KERNELS, built):
        _build.load_library(name)
        print(f"built {so.name} ({time.perf_counter() - t0:.1f}s for all)")
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

    # ---- 6. training kernels against plain
    task = PredPreyTask()
    ts_fit = torch.linspace(0.0, task.tf_learn, task.n_train,
                            dtype=torch.float32, device=device)
    lv = lotka_volterra_field(task)
    x0_task = torch.tensor([[task.x0, task.y0]], dtype=torch.float32,
                           device=device)
    batches = {256: x0s, 1: x0_task}
    targets = {b: odeint_dopri5(lv, x, ts_fit, rtol=1e-8, atol=1e-10,
                                max_steps=2048, mode="while", per_row=True)
               for b, x in batches.items()}
    checks = {b: check_training_kernels(params, spec, x, ts_fit, targets[b])
              for b, x in batches.items()}

    # ---- 7. the training slice, through the CLI and the traj driver
    _, ts_learn, truth = generate_data(task, device=device)
    with torch.no_grad():
        loss0 = float(trajectory_loss(params, spec, x0_task[0], ts_learn,
                                      truth[:task.n_train]))
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for f in (kanfet_solve, kanfet_adjoint_fwd, kanfet_adjoint_bwd):
            f.launches = 0
        result = cli.main(["predprey", "--device", "cuda", "--solver_mode",
                           "pallas", "--epochs", "200", "--epochs_per_call",
                           "100", "--out-dir", tmp])
        torch.cuda.synchronize()
        counts["predprey"] = (kanfet_solve.launches,
                              kanfet_adjoint_fwd.launches,
                              kanfet_adjoint_bwd.launches)
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            curve = [json.loads(line) for line in fh]
    train = [row["train"] for row in curve] + [result["final_train"]]
    tests = [row["test"] for row in curve]
    if not np.isfinite(train + tests).all():
        fail(f"cli predprey: non-finite losses {train} / {tests}")
    if not result["final_train"] < loss0:
        fail(f"cli predprey: loss did not fall: {loss0} -> "
             f"{result['final_train']}")
    print(f"cli predprey (200 epochs, pallas): loss {loss0:.6f} at init -> "
          f"{[round(v, 6) for v in train[:-1]]}; test {tests}; "
          f"{result['epochs_per_sec']:.2f} epochs/s ({smi})")

    for f in (kanfet_solve, kanfet_adjoint_fwd, kanfet_adjoint_bwd):
        f.launches = 0
    _, hist = train_traj_parallel(TrajParallelRun(
        n_traj=256, epochs=20, epochs_per_call=10,
        spec=PredPreyNODE.kanfet(solver_mode="pallas")), log=None)
    torch.cuda.synchronize()
    counts["traj"] = (kanfet_solve.launches, kanfet_adjoint_fwd.launches,
                      kanfet_adjoint_bwd.launches)
    if not (np.isfinite(hist["train"]).all()
            and hist["train"][-1] < hist["train"][0]):
        fail(f"train_traj_parallel: losses not finite or not falling: "
             f"{hist['train']}")
    print(f"train_traj_parallel (256 trajectories, 20 epochs, pallas): "
          f"losses {hist['train']}; {hist['epochs_per_sec']:.2f} epochs/s, "
          f"{hist['traj_epochs_per_sec']:.1f} traj-epochs/s ({smi})")
    fwd_launches = counts["predprey"][1] + counts["traj"][1]
    bwd_launches = counts["predprey"][2] + counts["traj"][2]
    print(f"launches (serving, adjoint fwd, adjoint bwd): cli predprey "
          f"{counts['predprey']}, traj driver {counts['traj']}")
    if min(counts["predprey"][1:] + counts["traj"][1:]) < 1:
        fail("a training path did not launch both training kernels")

    # ---- 8. timing of a training step, kernels and plain
    step_times = {b: time_training(params, spec, x, ts_fit, targets[b], smi)
                  for b, x in batches.items()}

    print(json.dumps({"kernels": [{
        "name": "kanfet_node_solve",
        "route": "cuda",
        "source": "fetode_tpu_torch/csrc/kanfet_node.cu",
        "replaces": "fetode_tpu/ops/pallas_node.py:260",
        "launches": launches + counts["predprey"][0] + counts["traj"][0],
        "max_abs_err": max_abs_err,
        "ms": times[256][0],
        "plain_ms": times[256][1],
    }, {
        "name": "kanfet_adjoint_fwd",
        "route": "cuda",
        "source": "fetode_tpu_torch/csrc/kanfet_adjoint.cu",
        "replaces": "fetode_tpu/ops/pallas_adjoint.py:863",
        "launches": fwd_launches,
        "max_abs_err": checks[256][0],
        "ms": step_times[256]["kernel"]["fwd"],
        "plain_ms": step_times[256]["plain"]["fwd"],
    }, {
        "name": "kanfet_adjoint_bwd",
        "route": "cuda",
        "source": "fetode_tpu_torch/csrc/kanfet_adjoint.cu",
        "replaces": "fetode_tpu/ops/pallas_adjoint.py:932",
        "launches": bwd_launches,
        "max_abs_err": checks[256][1],
        "ms": step_times[256]["kernel"]["bwd"],
        "plain_ms": step_times[256]["plain"]["bwd"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
