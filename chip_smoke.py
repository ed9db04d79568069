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

The ECG classification slice, at the full width of ``ECGPreset`` (T =
96, latent 64, 12 bases, hidden 128, dopri5 at rtol 1e-2 / atol 1e-3,
max_steps 16), random weights from a seed, series from
``synthetic_ecg200``:

9. The logistic-mixer kernels (``csrc/logistic_node.cu``) against their
   plain versions at every batch the main path gives them, B = 8 (a
   training step), 32 and 64 (the accuracy evals) and 256 (the largest
   serving bucket): the forward, with and without records, at rtol =
   atol = 1e-3;
   the backward on the forward kernel's own records against autograd of
   the plain replay of the same records, relative error < 1e-4 over all
   parameter gradients and over h0bar; full gradients, each on its own
   step mesh, cosine > 0.999.
10. The same checks for the ferro kernels (``csrc/ferro_node.cu``) at
    B = 8, 32 and 64, clean and with frozen device noise of std 0.2 (one
    set of draws for each batch, fed to both).
11. The training slice: ``cli.main(["ecg", "--device", "cuda",
    "--solver_mode", "pallas", ...])`` for ``kanfet_node``,
    ``kanfet_mlp_node`` and ``kanfet_mlp_node --noise_std 0.2``: both
    kernels of each model must have launched and the losses must be
    finite.
12. The serving slice: ``cli.main(["serve", "--source", "ecg",
    "--solver_mode", "pallas", ...])`` with buckets (8, 64, 256), then
    requests of B = 1, 30 and 300 through the loaded bundle; they must
    equal direct kernel calls on the same padded batches, and the forward
    kernel must have launched.
13. Timing: each ECG kernel and its plain version at B = 8 and at the
    serving buckets, and one ECG training step of each model, kernels
    against the eager solve.

Every kernel's line carries ``bound_ms``: the larger of the bytes the
call must move over the card's memory rate and the operations it does
over the peak rate of the unit that runs them, counted from this run's
shapes and attempt counts (``*_counts`` below).

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error, times and bound.
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
KERNELS = ("kanfet_node", "kanfet_adjoint", "logistic_node", "ferro_node")
ECG_BATCHES = (8, 64, 256)     # the training batch is 8; serving buckets
ECG_CHECKS = (8, 32, 64, 256)  # and 64 / 32, the train / test eval batches

# Peak rates of one H100 SXM at 700 W: HBM and FP32 outside the tensor
# cores from NVIDIA's data sheet; the special-function unit (exp2,
# reciprocal, ...) at 16 results per SM per clock (Hopper architecture
# white paper) and the 1.98 GHz boost clock.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
SFU_OPS_S = 132 * 16 * 1.98e9
# What the counts below assume for one call, as (FP32 operations, SFU
# results): a sigmoid 1 / (1 + exp(-z)) and a tanhf each (4, 2).
SIG = TANH = (4, 2)


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


def max_abs(a, b):
    return float((a - b).abs().max())


# ---------------------------------------------------------------- bounds


def bound(fp32, sfu, nbytes):
    """(bound_ms, bound_by, unit) of one call: the larger of its bytes over
    the memory rate and its operations over the rate of their unit."""
    t = {"bytes": nbytes / HBM_BYTES_S, "fp32": fp32 / FP32_OPS_S,
         "sfu": sfu / SFU_OPS_S}
    unit = max(t, key=t.get)
    return t[unit] * 1e3, ("bytes" if unit == "bytes" else "operations"), unit


def kanfet_eval_counts(cfg):
    """(FP32, SFU) of one KANFET field evaluation of one trajectory: per
    edge the SiLU base, the Cox-de Boor recursion and spline weights, and
    K ferro terms of two sigmoids and a tanh."""
    fp32 = sfu = 0
    for c in cfg.layers:
        i, o, K = c.in_features, c.out_features, c.ferro_num_basis
        C = c.grid_size + c.spline_order
        nk = c.grid_size + 2 * c.spline_order + 1
        fp32 += i * (2 + SIG[0]) + 2 * i * o
        fp32 += i * nk * (1 + 10 * c.spline_order) + 2 * i * o * C
        fp32 += i * (1 + SIG[0]) + i * o * K * (12 + 2 * SIG[0] + TANH[0])
        sfu += 2 * i * SIG[1] + i * o * K * (2 * SIG[1] + TANH[1])
    return fp32, sfu


def kanfet_counts(params, cfg, recs, T, kind):
    """(FP32, SFU, bytes) of a predprey kernel call from its records (the
    attempts each trajectory made): ``serve`` (solve and dense output at T
    times), ``fwd`` (the same plus the records) or ``bwd`` (6 field VJPs
    of about three evaluations each per accepted attempt: stage 7's
    cotangent is zero, since b[6] = 0)."""
    ev = kanfet_eval_counts(cfg)
    D = cfg.layers[0].in_features
    B = recs.n_att.shape[0]
    n_att = int(recs.n_att.sum())
    n_acc = int(recs.rec[:, 2, :].sum())
    n_par = sum(p.numel() for p in params.parameters())
    if kind == "bwd":
        n = 18 * n_acc
        nbytes = 4 * (B * T * D + n_att * (3 + 8 * D) + 2 * n_par + B * D)
        return n * ev[0], n * ev[1], nbytes
    n = 2 * B + 6 * n_att
    fp32 = n * ev[0] + n_att * D * 80 + n_acc * T * 20
    nbytes = 4 * (B * D + T + n_par + B * T * D)
    if kind == "fwd":
        nbytes += 4 * n_att * (3 + 8 * D)
    return fp32, n * ev[1], nbytes


def node_counts(ev, vjp, n_params, n_noise, B, D, recs, kind):
    """(FP32, SFU, bytes) of a batch-shared node kernel call: ``fwd`` (2 +
    6 per attempt field evaluations, the step arithmetic and the records)
    or ``bwd`` (6 field VJPs per accepted attempt: stage 7's cotangent is
    zero, since b[6] = 0); ``ev`` and ``vjp`` are (FP32, SFU) of one
    evaluation and one VJP of the whole batch."""
    N = B * D
    n_att = int(recs.misc[0])
    n_acc = int(recs.tda[:n_att, 1].sum())
    rec_floats = n_att * (4 + 8 * N) + 4
    if kind == "fwd":
        n = 2 + 6 * n_att
        return (n * ev[0] + N * (80 * n_att + 20), n * ev[1],
                4 * (2 * N + n_params + n_noise + rec_floats))
    n = 6 * n_acc
    return (n * vjp[0] + N * 100 * n_acc, n * vjp[1],
            4 * (2 * N + 2 * n_params + n_noise + rec_floats))


def logistic_counts(B, D, K):
    """(evaluation, VJP, parameter count) of the logistic-mixer field: two
    sigmoids per (b, l) and the (B, L) x (L, D) projection; the VJP needs
    the sigmoids again and two products, phibar = w W and gW += w^T phi,
    but not the projection itself."""
    L = D * K
    ev = (B * L * (3 + 2 * SIG[0]) + 2 * B * D * L + B * D,
          B * L * 2 * SIG[1])
    vjp = (B * L * (17 + 2 * SIG[0]) + 4 * B * D * L, B * L * 2 * SIG[1])
    return ev, vjp, 2 * L + D * L + D


def ferro_counts(B, D, H, K, noisy):
    """(evaluation, VJP, parameter count) of the two-layer ferro field:
    B (H D K + D H K) terms of a sigmoid, a tanh and about 16 FP32
    operations; the VJP needs each term's value and five gradients, all
    from one sigmoid and one tanh."""
    terms = B * 2 * H * D * K
    per = 16 + SIG[0] + TANH[0] + int(noisy)
    sfu = SIG[1] + TANH[1]
    ev = (terms * per + B * (D + H) * (SIG[0] + TANH[0]),
          terms * sfu + B * (D + H) * (SIG[1] + TANH[1]))
    link = B * (D + H)
    vjp = (terms * (per + 30) + link * (TANH[0] + 3),
           terms * sfu + link * TANH[1])
    return ev, vjp, 10 * H * D * K


def check_training_kernels(params, spec, x0s, ts, targets):
    """Phase 6 at one batch: returns (forward max |diff|, shared-mesh
    relative gradient error, x0bar relative error, own-mesh cosine, the
    kernel's records, shared-mesh max |diff| of the gradients)."""
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
    return fwd_err, g_err, x_err, cos, rec_k, max_abs(flat(g_k), flat(g_p))


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


# ------------------------------------------------------------------- ECG


def logistic_case(params, spec):
    """The logistic-mixer kernels of a ``KanFetNODE`` model as closures,
    with their plain field, weights and operation counts."""
    from fetode_tpu_torch.ops import logistic_node as LN

    w = (params.field_mixer.a, params.field_mixer.b, params.proj_w,
         params.proj_b)
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    D, K = spec.latent_dim, spec.num_basis

    def counts(B, recs, kind):
        ev, vjp, n_par = logistic_counts(B, D, K)
        return node_counts(ev, vjp, n_par, 0, B, D, recs, kind)

    return dict(
        name="logistic_node",
        fwd=lambda h0, record=True: LN.logistic_node_fwd(*w, h0,
                                                         record=record,
                                                         **opts),
        bwd=lambda h0, recs, hbar: LN.logistic_node_bwd(*w, h0, recs, hbar),
        solve=lambda h0: LN.logistic_node_solve(params, h0, spec),
        field=LN.logistic_field(*w), weights=w, opts=opts, counts=counts)


def ferro_case(params, spec, noise):
    """The ferro kernels of a ``KanFetMLPNODE`` model, with frozen noise
    (for one batch size) or None."""
    from fetode_tpu_torch.ops import ferro_node as FN

    cfg = FN.ferro_node_config(spec)
    fc1, fc2 = params.fc1, params.fc2
    w = [getattr(p, n) for p in (fc1, fc2)
         for n in ("k", "ec", "ps", "bias", "coef")]
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    D, H, K = spec.latent_dim, spec.ode_hidden, spec.num_basis

    def counts(B, recs, kind):
        ev, vjp, n_par = ferro_counts(B, D, H, K, noise is not None)
        n_noise = 0 if noise is None else sum(n.numel() for n in noise)
        return node_counts(ev, vjp, n_par, n_noise, B, D, recs, kind)

    return dict(
        name="ferro_node" + ("" if noise is None else " noisy"),
        fwd=lambda h0, record=True: FN.ferro_node_fwd(fc1, fc2, h0, cfg,
                                                      noise=noise,
                                                      record=record),
        bwd=lambda h0, recs, hbar: FN.ferro_node_bwd(fc1, fc2, h0, recs,
                                                     hbar, cfg, noise=noise),
        solve=lambda h0: FN.ferro_node_solve(fc1, fc2, h0, spec,
                                             noise=noise),
        field=FN.ferro_field(fc1, fc2, cfg, noise), weights=w, opts=opts,
        counts=counts)


def check_node_kernels(case, h0, hbar):
    """Phases 9-10 at one batch: the forward kernel against the plain
    recording solve, the backward kernel against autograd of the plain
    replay on the kernel's records, and full gradients on own meshes."""
    from fetode_tpu_torch.ops import node_common as NC

    label = f"{case['name']} B={h0.shape[0]}"
    with torch.no_grad():
        out_k, rec_k = case["fwd"](h0)
        out_n, _ = case["fwd"](h0, record=False)
        torch.cuda.synchronize()
        out_p, rec_p = NC.record_solve_reference(case["field"], h0,
                                                 **case["opts"])
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_n).all()
            and torch.isfinite(out_p).all()):
        fail(f"{label}: non-finite forward output")
    fwd_err, norec_err = max_abs(out_k, out_p), max_abs(out_n, out_p)
    for what, out, err in (("with records", out_k, fwd_err),
                           ("without records", out_n, norec_err)):
        if not torch.allclose(out, out_p, rtol=TOL, atol=TOL):
            fail(f"{label}: forward kernel {what} disagrees with plain "
                 f"(max |diff| {err:.3e})")
    g_k, hb_k = case["bwd"](h0, rec_k, hbar)
    g_p, hb_p = NC.replay_vjp_reference(case["field"], case["weights"], h0,
                                        rec_k, hbar)
    torch.cuda.synchronize()
    if not (all(torch.isfinite(g).all() for g in g_k)
            and torch.isfinite(hb_k).all()):
        fail(f"{label}: non-finite kernel gradients")
    g_rel, h_rel = rel_err(flat(g_k), flat(g_p)), rel_err(hb_k, hb_p)
    if not (g_rel < GRAD_TOL and h_rel < GRAD_TOL):
        fail(f"{label}: backward kernel vs plain replay on the kernel's "
             f"mesh: param grads rel {g_rel:.3e}, h0bar rel {h_rel:.3e}")

    def full(solve):
        return flat(torch.autograd.grad(torch.sum(solve(h0) * hbar),
                                        case["weights"]))

    gk = full(case["solve"])
    gp = full(lambda h: NC.solve_reference(case["field"], h, **case["opts"]))
    cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
    if not cos > COS_MIN:
        fail(f"{label}: own-mesh gradient cosine {cos:.6f}")
    print(f"{label} vs plain: forward max |diff| {fwd_err:.3e} (without "
          f"records {norec_err:.3e}); backward on the kernel's mesh: grads rel {g_rel:.3e}, h0bar rel {h_rel:.3e}; "
          f"own-mesh cosine {cos:.7f}; attempts kernel "
          f"{int(rec_k.misc[0])} (accepted "
          f"{int(rec_k.tda[:int(rec_k.misc[0]), 1].sum())}), plain "
          f"{int(rec_p.misc[0])}")
    return dict(fwd_err=max(fwd_err, norec_err), g_rel=g_rel, h_rel=h_rel, cos=cos,
                g_abs=max(max_abs(flat(g_k), flat(g_p)), max_abs(hb_k, hb_p)))


def time_node_kernels(case, h0, hbar, smi, plain=True):
    """Phase 13 at one batch: CUDA-event ms of the forward kernel with and
    without records, the backward kernel, and (``plain``) the plain
    recording solve and the plain replay's autograd."""
    from fetode_tpu_torch.ops import node_common as NC

    B = h0.shape[0]
    with torch.no_grad():
        _, recs = case["fwd"](h0)
    res = dict(recs=recs,
               fwd=cuda_ms(lambda: case["fwd"](h0), 20),
               fwd_norec=cuda_ms(lambda: case["fwd"](h0, record=False), 20),
               bwd=cuda_ms(lambda: case["bwd"](h0, recs, hbar), 20))
    line = (f"time {case['name']} B={B}: forward {res['fwd']:.4f} ms "
            f"(without records {res['fwd_norec']:.4f}), backward "
            f"{res['bwd']:.4f} ms")
    if plain:
        with torch.no_grad():
            res["plain_fwd"] = cuda_ms(lambda: NC.record_solve_reference(
                case["field"], h0, **case["opts"]), 1)
        res["plain_bwd"] = cuda_ms(lambda: NC.replay_vjp_reference(
            case["field"], case["weights"], h0, recs, hbar), 1)
        line += (f"; plain forward {res['plain_fwd']:.3f} ms, plain "
                 f"backward {res['plain_bwd']:.3f} ms")
    for kind in ("fwd", "bwd"):
        res[f"bound_{kind}"] = bound(*case["counts"](B, recs, kind))
    print(f"{line}; bounds fwd {res['bound_fwd'][0]:.5f} ms "
          f"({res['bound_fwd'][2]}), bwd {res['bound_bwd'][0]:.5f} ms "
          f"({res['bound_bwd'][2]}); attempts {int(recs.misc[0])} ({smi})")
    return res


def ecg_step_fn(apply, params, spec, x, y, mode):
    """One ECG training step (forward, cross-entropy, backward, clip and
    AdamW) with the latent solve in ``mode``, as a closure; learning rate
    0, so every call solves with the same parameters."""
    from fetode_tpu_torch.train.ecg_driver import cross_entropy
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    p = copy.deepcopy(params)
    state = init_state(p, make_optimizer(0.0, params=p.parameters(),
                                         kind="adamw", weight_decay=1e-4,
                                         grad_clip=1.0))
    s = spec._replace(solver_mode=mode)
    step = make_train_step(lambda q, xb, yb: cross_entropy(apply(q, s, xb),
                                                           yb))
    return lambda: step(state, x, y)


def profile_ms(fn, n=5):
    """torch.profiler over ``n`` calls after a warm one: (wall ms per call,
    device-busy ms per call, the union of the kernels' and copies'
    intervals in the trace, and the three kernels with the most device
    time as (name, ms per call))."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, -1.0
    for t, d in sorted((float(e["ts"]), float(e["dur"])) for e in device):
        busy += max(0.0, t + d - max(t, end))
        end = max(end, t + d)
    per_kernel = {}
    for e in device:
        if e["cat"] == "kernel":
            per_kernel[e["name"]] = per_kernel.get(e["name"], 0.0) + e["dur"]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
    return wall, busy / 1e3 / n, [(k[:60], v / 1e3 / n) for k, v in top]


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def ecg_phases(device, smi):
    """Phases 9-13, the ECG slice: returns the kernel checks, the timings
    and the kernels' launches on the training and serving paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.ops import ferro_node as FN
    from fetode_tpu_torch.ops import logistic_node as LN
    from fetode_tpu_torch.serve import load_servable

    # ---- 9-10. ECG kernels against plain, at ECGPreset's width
    data = synthetic_ecg200()
    series = np.concatenate([data[0], data[2]])        # 96 series of 96
    rng_e = np.random.default_rng(2)
    xs = {b: torch.from_numpy((series[np.arange(b) % len(series)] + 0.05
                               * rng_e.standard_normal((b, series.shape[1]))
                               ).astype(np.float32)).to(device)
          for b in ECG_CHECKS}
    lspec = M.KanFetNODESpec(num_basis=12)
    fspec = M.KanFetMLPNODESpec(num_basis=12)
    lparams = M.kanfet_node_init(torch.Generator().manual_seed(0), lspec,
                                 device=device)
    fparams = M.kanfet_mlp_node_init(torch.Generator().manual_seed(0), fspec,
                                     device=device)
    with torch.no_grad():
        lh0 = {b: x @ lparams.encoder_w.T + lparams.encoder_b
               for b, x in xs.items()}
        fh0 = {b: x @ fparams.encoder_w.T + fparams.encoder_b
               for b, x in xs.items()}
    hbars = {b: torch.from_numpy(rng_e.standard_normal(
        (b, lspec.latent_dim)).astype(np.float32)).to(device)
        for b in ECG_CHECKS}
    lcase = logistic_case(lparams, lspec)
    # Every batch the main path gives each kernel: the training batch,
    # the accuracy evals' 64 and 32, and (logistic) the serving buckets.
    ncases = {b: ferro_case(fparams, fspec, FN.frozen_solve_noise(
        torch.Generator().manual_seed(3), b, fspec.fc1_cfg, fspec.fc2_cfg,
        noise_std=0.2, device=device)) for b in (8, 32, 64)}
    fcase, ncase = ferro_case(fparams, fspec, None), ncases[8]
    ecg_checks = {("logistic", b): check_node_kernels(lcase, lh0[b], hbars[b])
                  for b in ECG_CHECKS}
    for b in (8, 32, 64):
        ecg_checks[("ferro", b)] = check_node_kernels(fcase, fh0[b], hbars[b])
        ecg_checks[("ferro noisy", b)] = check_node_kernels(
            ncases[b], fh0[b], hbars[b])

    # ---- 11. the ECG training slice, through the CLI
    ecg_kernels = (LN.logistic_node_fwd, LN.logistic_node_bwd,
                   FN.ferro_node_fwd, FN.ferro_node_bwd)
    ecg_launches = [0, 0, 0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        for model, extra in (("kanfet_node", []), ("kanfet_mlp_node", []),
                             ("kanfet_mlp_node", ["--noise_std", "0.2"])):
            for f in ecg_kernels:
                f.launches = 0
            res = cli.main(["ecg", "--device", "cuda", "--solver_mode",
                            "pallas", "--epochs", "3", "--model", model,
                            *extra, "--out-dir", tmp])
            torch.cuda.synchronize()
            ecg_counts = [f.launches for f in ecg_kernels]
            own = (ecg_counts[:2] if model == "kanfet_node"
                   else ecg_counts[2:])
            label = " ".join([model] + extra)
            if min(own) < 1:
                fail(f"cli ecg --model {label}: kernel launches {ecg_counts}")
            if not np.isfinite(res["loss_curve"]).all():
                fail(f"cli ecg --model {label}: non-finite losses "
                     f"{res['loss_curve']}")
            ecg_launches = [a + b for a, b in zip(ecg_launches, ecg_counts)]
            print(f"cli ecg --model {label} (3 epochs, pallas): losses "
                  f"{[round(v, 4) for v in res['loss_curve']]}, test acc "
                  f"{res['test_acc_curve']}, best {res['best_test_acc']}; "
                  f"{res['wall_seconds']:.2f} s; launches (logistic fwd, "
                  f"bwd, ferro fwd, bwd) {ecg_counts} ({smi})")

    # ---- 12. the ECG serving slice, through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["serve", "--source", "ecg", "--solver_mode", "pallas",
                "--device", "cuda", "--buckets", "8,64,256",
                "--out-dir", tmp]
        for f in ecg_kernels:
            f.launches = 0
        sresult = cli.main(argv)
        cfg = make_config("serve", cli._parse(argv)[1])
        sparams, sfn, _ = cli.ecg_serving(cfg, device)
        sv = load_servable(sresult["bundle"], sfn, sparams)
        reqs = {b: torch.from_numpy(np.resize(series, (b, cfg.t_len))).to(
            device) for b in (1, 30, 300)}
        served = {b: sv.predict(x) for b, x in reqs.items()}
        torch.cuda.synchronize()
        ecg_counts = [f.launches for f in ecg_kernels]
        if ecg_counts[0] < 1:
            fail("the ECG serving path launched no logistic_node kernel")
        ecg_launches = [a + b for a, b in zip(ecg_launches, ecg_counts)]
        with torch.no_grad():
            for b, x in reqs.items():
                want = []
                for off in range(0, b, sv.buckets[-1]):
                    chunk = x[off:off + sv.buckets[-1]]
                    take = chunk.shape[0]
                    bucket = next(k for k in sv.buckets if k >= take)
                    padded = torch.cat([chunk, chunk[-1:].expand(
                        bucket - take, -1)])
                    want.append(sfn(sv.params, padded)[:take])
                want = torch.cat(want)
                if served[b].shape != (b, 2) or \
                        not torch.isfinite(served[b]).all() or \
                        not torch.equal(served[b], want):
                    fail(f"ECG request B={b}: served logits differ from "
                         "direct kernel calls on the padded batch")
        wall, busy, top = profile_ms(lambda: sv.predict(xs[8]).cpu())
    print(f"ECG served B=1/30/300 through the bundle = direct kernel calls "
          f"on the padded batches; launches {ecg_counts}")
    print(f"ECG serve profile, bucket 8: wall {wall:.4f} ms, device busy "
          f"{busy:.4f} ms ({100 * busy / wall:.1f}%), top "
          f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    for row in sresult["bench"]:
        print(f"  ECG serve bucket {row['batch']}: p50 {row['p50_ms']:.4f} "
              f"ms, p99 {row['p99_ms']:.4f} ms, window p50s "
              f"{['%.4f' % w for w in row['window_p50_ms']]} ({smi})")

    # ---- 13. ECG timing: kernels and plain, a training step
    ecg_times = {("logistic", b): time_node_kernels(lcase, lh0[b], hbars[b],
                                                    smi)
                 for b in ECG_BATCHES}
    ecg_times[("ferro", 8)] = time_node_kernels(fcase, fh0[8], hbars[8], smi)
    ecg_times[("ferro noisy", 8)] = time_node_kernels(ncase, fh0[8],
                                                      hbars[8], smi,
                                                      plain=False)
    ecg_times[("ferro", 64)] = time_node_kernels(fcase, fh0[64], hbars[64],
                                                 smi, plain=False)
    y8 = torch.from_numpy(data[1][:8]).long().to(device)
    for name, apply, params_m, spec_m in (
            ("kanfet_node", M.kanfet_node_apply, lparams, lspec),
            ("kanfet_mlp_node", M.kanfet_mlp_node_apply, fparams, fspec)):
        step_k = ecg_step_fn(apply, params_m, spec_m, xs[8], y8, "pallas")
        kernel = cuda_ms(step_k, 10)
        eager = cuda_ms(ecg_step_fn(apply, params_m, spec_m, xs[8], y8,
                                    "scan"), 1)
        wall, busy, top = profile_ms(step_k)
        print(f"time ECG training step {name} B=8: kernels {kernel:.4f} ms, "
              f"eager scan solve {eager:.3f} ms; profiled: wall {wall:.4f} "
              f"ms, device busy {busy:.4f} ms ({100 * busy / wall:.1f}%), "
              f"top {[(k, round(v, 4)) for k, v in top]} ({smi})")

    return ecg_checks, ecg_times, ecg_launches


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
    serve_launches = launches + counts["predprey"][0] + counts["traj"][0]
    fwd_launches = counts["predprey"][1] + counts["traj"][1]
    bwd_launches = counts["predprey"][2] + counts["traj"][2]
    print(f"launches (serving, adjoint fwd, adjoint bwd): cli predprey "
          f"{counts['predprey']}, traj driver {counts['traj']}")
    if min(counts["predprey"][1:] + counts["traj"][1:]) < 1:
        fail("a training path did not launch both training kernels")

    # ---- 8. timing of a training step, kernels and plain
    step_times = {b: time_training(params, spec, x, ts_fit, targets[b], smi)
                  for b, x in batches.items()}

    ecg_checks, ecg_times, ecg_launches = ecg_phases(device, smi)

    # ---- the kernels line: predprey at B = 256, ECG at B = 8
    with torch.no_grad():
        _, serve_recs = kanfet_adjoint_fwd(params, spec.kan, x0s, ts,
                                           max_steps=spec.max_steps, **kw)
    lt, ft = ecg_times[("logistic", 8)], ecg_times[("ferro", 8)]

    def worst(model, key):
        return max(c[key] for k, c in ecg_checks.items()
                   if k[0].split()[0] == model)
    print(json.dumps({"kernels": [
        kernel_entry("kanfet_node_solve", "fetode_tpu_torch/csrc/kanfet_node.cu",
                     "fetode_tpu/ops/pallas_node.py:260",
                     serve_launches, max_abs_err, times[256][0],
                     times[256][1], bound(*kanfet_counts(
                         params, spec.kan, serve_recs, T_SERVE, "serve"))),
        kernel_entry("kanfet_adjoint_fwd",
                     "fetode_tpu_torch/csrc/kanfet_adjoint.cu",
                     "fetode_tpu/ops/pallas_adjoint.py:863", fwd_launches,
                     checks[256][0], step_times[256]["kernel"]["fwd"],
                     step_times[256]["plain"]["fwd"], bound(*kanfet_counts(
                         params, spec.kan, checks[256][4], ts_fit.shape[0],
                         "fwd"))),
        kernel_entry("kanfet_adjoint_bwd",
                     "fetode_tpu_torch/csrc/kanfet_adjoint.cu",
                     "fetode_tpu/ops/pallas_adjoint.py:932", bwd_launches,
                     checks[256][5], step_times[256]["kernel"]["bwd"],
                     step_times[256]["plain"]["bwd"], bound(*kanfet_counts(
                         params, spec.kan, checks[256][4], ts_fit.shape[0],
                         "bwd"))),
        kernel_entry("logistic_node_fwd",
                     "fetode_tpu_torch/csrc/logistic_node.cu",
                     "fetode_tpu/ops/pallas_logistic_node.py:121",
                     ecg_launches[0], worst("logistic", "fwd_err"),
                     lt["fwd"], lt["plain_fwd"], lt["bound_fwd"]),
        kernel_entry("logistic_node_bwd",
                     "fetode_tpu_torch/csrc/logistic_node.cu",
                     "fetode_tpu/ops/pallas_logistic_node.py:141",
                     ecg_launches[1], worst("logistic", "g_abs"),
                     lt["bwd"], lt["plain_bwd"], lt["bound_bwd"]),
        kernel_entry("ferro_node_fwd", "fetode_tpu_torch/csrc/ferro_node.cu",
                     "fetode_tpu/ops/pallas_ferro_node.py:475",
                     ecg_launches[2], worst("ferro", "fwd_err"),
                     ft["fwd"], ft["plain_fwd"], ft["bound_fwd"]),
        kernel_entry("ferro_node_bwd", "fetode_tpu_torch/csrc/ferro_node.cu",
                     "fetode_tpu/ops/pallas_ferro_node.py:505",
                     ecg_launches[3], worst("ferro", "g_abs"),
                     ft["bwd"], ft["plain_bwd"], ft["bound_bwd"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
