"""Check and time B.5 (``csrc/logistic_node.cu``), B.6
(``csrc/mlp_node.cu``), B.8 (``csrc/node_enc.cu``), B.7
(``csrc/ode_dyn.cu``), B.4 (``csrc/ferro_node.cu``) and B.14
(``csrc/custom_field.cu``) of the package this file is imported from, on
one card, with the other kernels on ``csrc/node_common.cuh`` beside them.

    python -m fetode_tpu_torch.tools.node_field_times [--tag NAME] [--breakdown]
        [--parts b5,b6,b8,b7,b4,b14,others,steps]

Run from the root of a checkout (it imports that checkout's
``chip_smoke`` for its inputs, bounds and timers).  To compare two
builds, copy this file into a ``git archive`` of the other commit and
run both from their roots in one call, in the order A, B, B, A.  It
builds the kernels of ``node_common.cuh``, then:

* B.7 at ``ETTPreset``'s width (latent 64, hidden 128, rtol 1e-3, the 8
  output times) at every batch phase 14 of ``chip_smoke.py`` gives it,
  initial states from the encoder on the synthetic windows: the forward
  with records and the backward on its records (a seeded cotangent), the
  time a call back to back (CUDA events, ``cuda_ms``: the host's launch
  cost included where it exceeds the kernel's) and the device time a call
  on a full queue (``queued_ms``), the attempts, the
  bounds, the forward's output and records and the backward's gradients
  the same bits in two calls, the forward against its plain version
  (rtol = atol = ``TOL``) in the same attempts.
* B.4 at ``ECGPreset``'s width (latent 64, hidden 128, 12 bases, rtol
  1e-2) at B = 8, 32 and 64, clean and with frozen device noise of std
  0.2: the same.
* B.6 at ``ECGPreset``'s width ('mlp' field: latent 64, 12 bases,
  hidden 128, rtol 1e-2) at every batch phase 28 of ``chip_smoke.py``
  gives it (8, 32, 64, 256) with the init parameters and at B = 8 with
  phase 28's scaled set: the same readings as B.7's; and at B = 256 its
  chunk form (``ops/mlp_node.py: FUSE_ROWS`` raised to the batch: the
  layer norm and the crossing sums inside the consumers, no phases of
  their own) beside the form the batch takes, where the checkout has
  both.
* B.8 at the encoder's width (128) at every batch phase 24 gives it (8,
  31, 64, 181, 256): the same readings, the x_seq cotangent among the
  gradients compared bit for bit.
* B.5 at ``ECGPreset``'s width ('plain' field: latent 64, 12 bases, rtol
  1e-2) at every batch phase 9 of ``chip_smoke.py`` gives it
  (``ECG_CHECKS``: 8, 32, 64, 256), phase 9's inputs: the same readings
  as B.7's; at B = 64 its grid form and at B = 256 its cluster form
  (``ops/logistic_node.py: GRID_PAST`` moved) beside the form the batch
  takes, where the checkout has both.
* B.14 at every shape of phase 41 of ``chip_smoke.py`` (``B14_SHAPES``,
  kept here so that an older checkout is timed at the same ones): the
  example's (D = 4, H = 8, B = 3), D = 64, H = 128 at B = 8, 64, 67 and
  256, and D = 64, H = 512 at B = 8 (``CUSTOM_WIDE``: the weights past a
  CTA's shared memory), phase 41's weights: the same readings as B.7's
  and the launch's plan (``examples/custom_field_kernel.py: row_plan``,
  where the checkout has it).
* B.3 (kanfet_wide), the other kernel that shares the scaffold, at [2,
  64, 64, 2], B = 1 (``cuda_ms``): forward and backward times.
* The ECG ``kanfet_node``, ``kanfet_mlp_node`` and ``kanfet_node --field
  mlp`` training steps at B = 8, the ETT ``point`` step and the
  ``cond_diffusion`` ``kan_fet_all_node`` step at B = 64 (forward,
  backward, clip, AdamW at learning rate 0; ``cuda_ms``), and ``serve
  --source ett``, ``serve --source ecg`` and ``serve --source ecg --field
  mlp`` p50 in buckets 8, 64 and 256.
* With ``--breakdown``, where the checkout's ``logistic_node.cu`` has the
  clock marks: its clock build (``tools/clock_build.py``) run once each
  forward (with records) and backward at phase 9's B = 8 and 64: the mean
  over CTAs of thread 0's cycles in the parameters' load, the evaluations
  (of them phi, the product and the partials' sums), the VJPs (of them
  the transposed product, the columns' other work and ubar), the
  deferred gradients (of them the barrier with ga / gb, the waits for the
  records and the products) and the whole kernel.  And B.14's clock build
  (the checkout's marks, or ``PARENT_B14_MARKS`` in a source without
  them) at B = 8 and 64: thread 0's cycles in the weights' load, the
  evaluations (of them the copy of u and its barrier, or the grid
  barrier between the products before the row policy; the first product
  with its tanhs; the tanhs alone; the second product), the VJPs (of
  them the products and the gradient tiles), the gradients' sums and the
  whole kernel.
``--parts`` runs only the parts named (all by default).

No profiler (it drops device events on that machine).  Prints the card's
name and power limit, one line a measurement, and a last JSON line
``{"tag": ..., "b5": {...}, "b6": {...}, "b8": {...}, "b7": {...}, "b4":
{...}, "b14": {...}, "others": {...}, "steps": {...}}``.  Exits non-zero
if a check fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import tempfile
import time

KERNELS = ("ode_dyn", "ferro_node", "logistic_node", "mlp_node", "node_enc",
           "custom_field", "kanfet_wide")
PARTS = ("b5", "b6", "b8", "b7", "b4", "b14", "others", "steps")
# chip_smoke.py's CUSTOM_SMALL, CUSTOM_DH at each of CUSTOM_BATCHES, and
# CUSTOM_WIDE: (D, H, B).
B14_SHAPES = ((4, 8, 3),) + tuple((64, 128, b) for b in (8, 64, 67, 256)) \
    + ((64, 512, 8),)

B14_SLOTS = ("load", "evals", "eval copy / barrier", "first product",
             "tanh", "second product", "vjps", "vjp products", "grad tiles",
             "grad sums", "total")
# B.14 before the row policy (the grid policy, a thread an output), marked
# on B14_SLOTS by fixed replacements: (anchor, its replacement), each
# anchor found once; the tanhs, the tiles and the sums stay 0.
_CK = "custom_field_clocks[11 * blockIdx.x + {}]"
PARENT_B14_MARKS = (
    ("namespace {\n",
     "namespace {\n__device__ long long custom_field_clocks[11 * 1024];\n"),
    ("  __device__ void eval(const float* u, float* out) const {\n",
     "  __device__ void eval(const float* u, float* out) const {\n"
     "    const long long kc0 = clock64();\n"),
    ("      z[i] = tanhf(s);\n    }\n    cg::this_grid().sync();\n",
     "      z[i] = tanhf(s);\n    }\n    const long long kc1 = clock64();\n"
     "    cg::this_grid().sync();\n    const long long kc2 = clock64();\n"),
    ("      out[i] = s;\n    }\n",
     "      out[i] = s;\n    }\n    if (threadIdx.x == 0) {\n"
     "      const long long kc3 = clock64();\n"
     f"      {_CK.format(1)} += kc3 - kc0;\n"
     f"      {_CK.format(3)} += kc1 - kc0;\n"
     f"      {_CK.format(2)} += kc2 - kc1;\n"
     f"      {_CK.format(5)} += kc3 - kc2;\n    }}\n"),
    ("  __device__ void vjp(const float* u, const float* w, float* ubar) "
     "const {\n",
     "  __device__ void vjp(const float* u, const float* w, float* ubar) "
     "const {\n    const long long kv0 = clock64();\n"),
    ("        ubar[j] = s;\n      }\n    }\n",
     "        ubar[j] = s;\n      }\n    }\n"
     f"    if (threadIdx.x == 0) {_CK.format(6)} += clock64() - kv0;\n"
     f"    if (threadIdx.x == 0) {_CK.format(7)} += clock64() - kv0;\n"),
    ("  adaptive_solve_final<kRecord>(a.f, a.s);\n",
     "  const long long kt0 = clock64();\n"
     "  adaptive_solve_final<kRecord>(a.f, a.s);\n"
     f"  if (threadIdx.x == 0) {_CK.format(10)} = clock64() - kt0;\n"),
    ("  adjoint_replay(f, a.r);\n",
     "  const long long kt0 = clock64();\n  adjoint_replay(f, a.r);\n"
     f"  if (threadIdx.x == 0) {_CK.format(10)} = clock64() - kt0;\n"),
)


def instrument_b14(src: str) -> str:
    """B.14's clock build: the checkout's marks, or PARENT_B14_MARKS."""
    if "CUSTOM_FIELD_CLOCKS" in src:
        return src
    for anchor, text in PARENT_B14_MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"node_field_times: clock anchor found "
                               f"{src.count(anchor)} times: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def _same(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def timed_case(cs, case, h0, hbar, smi, label, plain=True):
    """One batch of a ``check_node_kernels`` case: times, attempts, bounds,
    bits twice and (``plain``) the forward against plain."""
    import torch

    B = h0.shape[0]
    with torch.no_grad():
        o1, r1 = case["fwd"](h0)
        o2, r2 = case["fwd"](h0)
    g1 = case["bwd"](h0, r1, hbar)
    g2 = case["bwd"](h0, r1, hbar)
    torch.cuda.synchronize()
    n = int(r1.misc[0])
    twice = (torch.equal(o1, o2) and torch.equal(r1.tda, r2.tda)
             and torch.equal(r1.misc, r2.misc)
             and torch.equal(r1.yrec[:n], r2.yrec[:n])
             and torch.equal(r1.krec[:n], r2.krec[:n])
             and _same(g1[0], g2[0]) and torch.equal(g1[1], g2[1]))
    row = dict(attempts=n, twice=twice)
    if plain:
        with torch.no_grad():
            op, rp = case["plain_fwd"](h0)
        row["err"] = cs.max_abs(o1, op)
        row["plain_attempts"] = int(rp.misc[0])
        if not (torch.allclose(o1, op, rtol=cs.TOL, atol=cs.TOL)
                and row["plain_attempts"] == n):
            cs.fail(f"{label} B={B}: against plain {row}")
    if not twice:
        cs.fail(f"{label} B={B}: two calls differ")
    with torch.no_grad():
        row["fwd"] = cs.cuda_ms(lambda: case["fwd"](h0), 20)
        row["fwd_dev"] = cs.queued_ms(lambda: case["fwd"](h0))
    row["bwd"] = cs.cuda_ms(lambda: case["bwd"](h0, r1, hbar), 20)
    row["bwd_dev"] = cs.queued_ms(lambda: case["bwd"](h0, r1, hbar))
    row["bound_fwd"] = cs.bound(*case["counts"](B, r1, "fwd"))[0]
    row["bound_bwd"] = cs.bound(*case["counts"](B, r1, "bwd"))[0]
    print(f"{label} B={B}: forward {row['fwd']:.4f} ms, backward "
          f"{row['bwd']:.4f} ms back to back (cuda_ms); device "
          f"{row['fwd_dev']:.4f} / {row['bwd_dev']:.4f} ms on a full queue "
          f"(queued_ms); {n} attempts; bounds "
          f"{row['bound_fwd']:.5f} / {row['bound_bwd']:.5f} ms; the same "
          f"bits twice; {'max |diff| %.3e vs plain' % row['err'] if plain else ''} "
          f"({smi})", flush=True)
    return row


def b7_part(cs, device, smi):
    import numpy as np
    import torch

    from fetode_tpu_torch.models import forecasting as F
    from fetode_tpu_torch.nn.mlp import mlp_apply

    wins = cs.forecast_windows()
    rng = np.random.default_rng(4)
    spec = F.LatentODEForecasterSpec(num_features=wins.shape[2])
    params = F.latent_ode_forecaster_init(torch.Generator().manual_seed(0),
                                          spec, device=device)
    ts = torch.arange(spec.pred_len, dtype=torch.float32, device=device)
    case = cs.ode_dyn_case(params["dynamics"], ts)
    out = {}
    for b in cs.ODE_CHECKS:
        x = torch.from_numpy(wins[(37 * b + np.arange(b)) % len(wins)]).to(
            device)
        with torch.no_grad():
            z0 = mlp_apply(params["encoder"], spec.enc, x.reshape(b, -1))
        ct = torch.from_numpy(rng.standard_normal(
            (len(ts), b, spec.latent_dim)).astype(np.float32)).to(device)
        out[b] = timed_case(cs, case, z0, ct, smi, "B.7 ode_dyn")
    return out


def ecg_inputs(device, b, seed):
    import numpy as np
    import torch

    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200

    data = synthetic_ecg200()
    series = np.concatenate([data[0], data[2]])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((series[np.arange(b) % len(series)] + 0.05
                          * rng.standard_normal((b, series.shape[1]))
                          ).astype(np.float32)).to(device)
    hbar = torch.from_numpy(rng.standard_normal((b, 64)).astype(
        np.float32)).to(device)
    y = torch.from_numpy(data[1][:b]).long().to(device)
    return x, hbar, y


def b4_part(cs, device, smi):
    import torch

    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.ops import ferro_node as FN

    spec = M.KanFetMLPNODESpec(num_basis=12)
    params = M.kanfet_mlp_node_init(torch.Generator().manual_seed(0), spec,
                                    device=device)
    out = {}
    for b in (8, 32, 64):
        x, hbar, _ = ecg_inputs(device, b, 2)
        with torch.no_grad():
            h0 = x @ params.encoder_w.T + params.encoder_b
        noise = FN.frozen_solve_noise(torch.Generator().manual_seed(3), b,
                                      spec.fc1_cfg, spec.fc2_cfg,
                                      noise_std=0.2, device=device)
        for label, nz in (("clean", None), ("noisy", noise)):
            case = cs.ferro_case(params, spec, nz)
            out[f"{label} {b}"] = timed_case(cs, case, h0, hbar, smi,
                                             f"B.4 ferro_node {label}")
    return out


def b5_part(cs, device, smi):
    """B.5 at phase 9's batches and inputs; at B = 64 also its grid form
    and at B = 256 its cluster form, where the checkout has both."""
    import numpy as np
    import torch

    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.ops import logistic_node as LN

    data = synthetic_ecg200()
    series = np.concatenate([data[0], data[2]])
    rng = np.random.default_rng(2)
    xs = {b: torch.from_numpy((series[np.arange(b) % len(series)] + 0.05
                               * rng.standard_normal((b, series.shape[1]))
                               ).astype(np.float32)).to(device)
          for b in cs.ECG_CHECKS}
    spec = M.KanFetNODESpec(num_basis=12)
    params = M.kanfet_node_init(torch.Generator().manual_seed(0), spec,
                                device=device)
    hbars = {b: torch.from_numpy(rng.standard_normal(
        (b, spec.latent_dim)).astype(np.float32)).to(device)
        for b in cs.ECG_CHECKS}
    case = cs.logistic_case(params, spec)
    out = {}
    for b in cs.ECG_CHECKS:
        with torch.no_grad():
            h0 = xs[b] @ params.encoder_w.T + params.encoder_b
        out[b] = timed_case(cs, case, h0, hbars[b], smi, "B.5 logistic_node")
        if hasattr(LN, "GRID_PAST") and b in (64, 256):
            keep = LN.GRID_PAST
            LN.GRID_PAST = 32 if b == 64 else b
            form = "grid" if b == 64 else "cluster"
            try:
                out[f"{form} {b}"] = timed_case(
                    cs, case, h0, hbars[b], smi,
                    f"B.5 logistic_node, {form} form")
            finally:
                LN.GRID_PAST = keep
    return out


B5_SLOTS = ("load", "evals", "eval phi", "eval product", "eval sums",
            "vjps", "vjp product", "vjp columns", "vjp ubar", "gradients",
            "grad barrier", "grad waits", "grad products", "total")


def b5_breakdown(cs, device, smi):
    """B.5's clock build at B = 8 and 64, forward and backward."""
    import numpy as np
    import torch

    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.ops import logistic_node as LN
    from fetode_tpu_torch.tools import clock_build as CB

    n = len(B5_SLOTS)
    lib = CB.clock_library("logistic_node", n)
    CB.copy_signatures(lib, LN._lib(), (
        "logistic_node_fwd", "logistic_node_bwd", "logistic_node_plan"))
    spec = M.KanFetNODESpec(num_basis=12)
    params = M.kanfet_node_init(torch.Generator().manual_seed(0), spec,
                                device=device)
    case = cs.logistic_case(params, spec)
    keep = LN._lib
    LN._lib = lambda: lib
    out = {}
    try:
        for b in (8, 64):
            x, hbar, _ = ecg_inputs(device, b, 2)
            with torch.no_grad():
                h0 = x @ params.encoder_w.T + params.encoder_b
                _, recs = case["fwd"](h0)
            for kind in ("fwd", "bwd"):
                torch.cuda.synchronize()
                CB.clear_clocks(lib, "logistic_node")
                with torch.no_grad():
                    if kind == "fwd":
                        case["fwd"](h0)
                    else:
                        case["bwd"](h0, recs, hbar)
                torch.cuda.synchronize()
                rows = CB.read_clocks(lib, "logistic_node", n)
                mean = {k: float(np.mean([r[i] for r in rows]))
                        for i, k in enumerate(B5_SLOTS)}
                out[f"{kind} {b}"] = dict(ctas=len(rows), **mean)
                print(f"B.5 clock build {kind} B={b}: thread 0's cycles a CTA, "
                      f"mean over {len(rows)} CTAs: " + ", ".join(
                          f"{k} {mean[k]:.0f}" for k in B5_SLOTS)
                      + f"; attempts {int(recs.misc[0])} ({smi})", flush=True)
    finally:
        LN._lib = keep
    return out


def b6_part(cs, device, smi):
    """B.6 at phase 28's batches and inputs, init and (B = 8) scaled; at
    B = 256 also the inline form, where the checkout has both."""
    import numpy as np
    import torch

    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.ops import mlp_node as MN

    data = synthetic_ecg200()
    series = np.concatenate([data[0], data[2]])
    rng = np.random.default_rng(8)
    spec = M.KanFetNODESpec(num_basis=12, field="mlp")
    params = M.kanfet_node_init(torch.Generator().manual_seed(0), spec,
                                device=device)
    scaled = copy.deepcopy(params)
    with torch.no_grad():
        scaled.out_w.copy_(4.0 * torch.from_numpy(rng.standard_normal(
            tuple(scaled.out_w.shape)).astype(np.float32)).to(device))
        scaled.log_alpha.fill_(0.5)
        for layer in scaled.kan.layers:
            layer.base_weight.mul_(3.0)
            layer.spline_weight.mul_(3.0)
    out = {}
    for b in cs.MLP_CHECKS:
        x = torch.from_numpy((series[np.arange(b) % len(series)] + 0.05
                              * rng.standard_normal((b, series.shape[1]))
                              ).astype(np.float32)).to(device)
        with torch.no_grad():
            h0 = x @ params.encoder_w.T + params.encoder_b
        hbar = torch.from_numpy(rng.standard_normal(
            (b, spec.latent_dim)).astype(np.float32)).to(device)
        out[f"init {b}"] = timed_case(cs, cs.mlp_case(params, spec), h0,
                                      hbar, smi, "B.6 mlp_node init")
        if b == 8:
            out[f"scaled {b}"] = timed_case(
                cs, cs.mlp_case(scaled, spec, "mlp_node scaled"), h0, hbar,
                smi, "B.6 mlp_node scaled")
        if b == 256 and hasattr(MN, "FUSE_ROWS"):
            keep = MN.FUSE_ROWS
            MN.FUSE_ROWS = b
            try:
                out[f"inline {b}"] = timed_case(
                    cs, cs.mlp_case(params, spec), h0, hbar, smi,
                    "B.6 mlp_node init, chunk form", plain=False)
            finally:
                MN.FUSE_ROWS = keep
    return out


def b8_part(cs, device, smi):
    """B.8 at phase 24's batches and inputs."""
    import numpy as np
    import torch

    from fetode_tpu_torch.models import cond_diffusion as CD

    wins = cs.cond_windows()
    rng = np.random.default_rng(6)
    cfg = CD.NodeEncoderCfg(d_in=wins.shape[2])
    enc = CD.node_encoder_init(torch.Generator().manual_seed(0), cfg,
                               device=device)
    out = {}
    for b in cs.NODE_ENC_CHECKS:
        with torch.no_grad():
            x_seq = torch.from_numpy(wins[(13 * b + np.arange(b))
                                          % len(wins)]).to(device) \
                @ enc.x_proj_w.T + enc.x_proj_b
            z0 = x_seq[:, 0] @ enc.z0_w.T + enc.z0_b
        ct = torch.from_numpy(rng.standard_normal(
            (b, cfg.cond_dim)).astype(np.float32)).to(device)
        out[b] = timed_case(cs, cs.node_enc_case(enc, cfg, x_seq), z0, ct,
                            smi, "B.8 node_enc")
    return out


def b14_cases(cs, device):
    """Phase 41's B.14 cases (``B14_SHAPES``): (label, case, h0, hbar, (D,
    H, B))."""
    import numpy as np
    import torch

    rng = np.random.default_rng(41)
    out = []
    for D, H, B in B14_SHAPES:
        scale = 0.5 if (D, H, B) == B14_SHAPES[0] else None
        case = cs.custom_case(device, D, H, scale, seed=B)
        h0 = torch.from_numpy(rng.standard_normal((B, D)).astype(
            np.float32)).to(device)
        hbar = torch.from_numpy(rng.standard_normal((B, D)).astype(
            np.float32)).to(device)
        out.append((f"B.14 custom_field D={D} H={H}", case, h0, hbar,
                    (D, H, B)))
    return out


def b14_part(cs, device, smi):
    """B.14 at phase 41's shapes: times, attempts, bits twice, plans."""
    from fetode_tpu_torch.examples import custom_field_kernel as CF

    out = {}
    for label, case, h0, hbar, (D, H, B) in b14_cases(cs, device):
        row = timed_case(cs, case, h0, hbar, smi, label)
        if hasattr(CF, "row_plan"):
            p = CF.row_plan(B, D, H)
            row["plan"] = dict(C=p["C"], R=p["R"], grid=p["grid"],
                               smem_bytes=p["smem_bytes"],
                               weights="shared" if p["smem"] else "device")
            print(f"  plan {row['plan']}", flush=True)
        out[f"{D} {H} {B}"] = row
    return out


def b14_breakdown(cs, device, smi):
    """B.14's clock build at B = 8 and 64, forward and backward."""
    import numpy as np
    import torch

    from fetode_tpu_torch.examples import custom_field_kernel as CF
    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.tools import clock_build as CB

    n = len(B14_SLOTS)
    lib = CB.clock_library("custom_field", n, instrument_b14(
        (_build.SRC_DIR / "custom_field.cu").read_text()))
    CB.copy_signatures(lib, CF._lib(), (
        "custom_field_fwd", "custom_field_bwd", "custom_field_plan",
        "custom_field_work_floats"))
    keep = CF._lib
    CF._lib = lambda: lib
    out = {}
    try:
        for label, case, h0, hbar, (D, H, B) in b14_cases(cs, device):
            if (D, H) != cs.CUSTOM_DH or B not in (8, 64):
                continue
            with torch.no_grad():
                _, recs = case["fwd"](h0)
            for kind in ("fwd", "bwd"):
                torch.cuda.synchronize()
                CB.clear_clocks(lib, "custom_field")
                with torch.no_grad():
                    if kind == "fwd":
                        case["fwd"](h0)
                    else:
                        case["bwd"](h0, recs, hbar)
                torch.cuda.synchronize()
                rows = CB.read_clocks(lib, "custom_field", n)
                mean = {k: float(np.mean([r[i] for r in rows]))
                        for i, k in enumerate(B14_SLOTS)}
                out[f"{kind} {B}"] = dict(ctas=len(rows), **mean)
                print(f"B.14 clock build {kind} B={B}: thread 0's cycles a "
                      f"CTA, mean over {len(rows)} CTAs: " + ", ".join(
                          f"{k} {mean[k]:.0f}" for k in B14_SLOTS)
                      + f"; attempts {int(recs.misc[0])} ({smi})", flush=True)
    finally:
        CF._lib = keep
    return out


def others_part(cs, device, smi):
    """B.3, the scaffold's other kernel: forward / backward ms."""
    import torch

    from fetode_tpu_torch.models.predprey import PredPreyNODE, PredPreyTask
    from fetode_tpu_torch.ops import kanfet_wide as KW

    out = {}
    task = PredPreyTask()
    ts = torch.linspace(0.0, task.tf_learn, task.n_train,
                        dtype=torch.float32, device=device)
    x0 = torch.tensor([[task.x0, task.y0]], dtype=torch.float32,
                      device=device)
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 64, 64, 2))
    w = KW.wide_weights(cs.wide_params(spec, device, "init"))
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    with torch.no_grad():
        y, recs = KW.kanfet_wide_fwd(w, spec.kan, x0, ts, **opts)
        fwd = cs.cuda_ms(lambda: KW.kanfet_wide_fwd(w, spec.kan, x0, ts,
                                                    **opts), 5)
    ct = torch.ones_like(y) / y.numel()
    bwd = cs.cuda_ms(lambda: KW.kanfet_wide_bwd(w, spec.kan, x0, ts, recs,
                                                ct), 5)
    out["B.3 kanfet_wide [2, 64, 64, 2] B=1"] = dict(
        fwd=fwd, bwd=bwd, attempts=int(recs.misc[0]))
    print(f"B.3 kanfet_wide [2, 64, 64, 2] B=1: forward {fwd:.4f} ms, "
          f"backward {bwd:.4f} ms (cuda_ms), {int(recs.misc[0])} attempts "
          f"({smi})", flush=True)
    return out


def steps_part(cs, device, smi):
    """The ECG 'plain', ferro and 'mlp' steps at B = 8, the ETT point and
    the cond_diffusion kan_fet_all_node steps at B = 64, and the ETT, ECG
    and ECG 'mlp' serving p50s."""
    import numpy as np
    import torch

    from fetode_tpu_torch import cli
    from fetode_tpu_torch.models import cond_diffusion as CD
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.models import forecasting as F
    from fetode_tpu_torch.nn.diffusion import make_schedule
    from fetode_tpu_torch.train import cond_diffusion_driver as drv
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    out = {}
    x8, _, y8 = ecg_inputs(device, 8, 2)
    lspec = M.KanFetNODESpec(num_basis=12)
    lparams = M.kanfet_node_init(torch.Generator().manual_seed(0), lspec,
                                 device=device)
    lstep = cs.ecg_step_fn(M.kanfet_node_apply, lparams, lspec, x8, y8,
                           "pallas")
    out["ecg kanfet_node B=8"] = cs.cuda_ms(lstep, 10, windows=5)
    fspec = M.KanFetMLPNODESpec(num_basis=12)
    fparams = M.kanfet_mlp_node_init(torch.Generator().manual_seed(0), fspec,
                                     device=device)
    step = cs.ecg_step_fn(M.kanfet_mlp_node_apply, fparams, fspec, x8, y8,
                          "pallas")
    out["ecg kanfet_mlp_node B=8"] = cs.cuda_ms(step, 10, windows=5)
    mspec = M.KanFetNODESpec(num_basis=12, field="mlp")
    mparams = M.kanfet_node_init(torch.Generator().manual_seed(0), mspec,
                                 device=device)
    mstep = cs.ecg_step_fn(M.kanfet_node_apply, mparams, mspec, x8, y8,
                           "pallas")
    out["ecg kanfet_node --field mlp B=8"] = cs.cuda_ms(mstep, 10, windows=5)

    wins = cs.forecast_windows()
    rng = np.random.default_rng(4)
    pspec = F.LatentODEForecasterSpec(num_features=wins.shape[2])
    pparams = F.latent_ode_forecaster_init(torch.Generator().manual_seed(0),
                                           pspec, device=device)
    x64 = torch.from_numpy(wins[np.arange(64)]).to(device)
    y64 = torch.from_numpy(rng.standard_normal((64, pspec.pred_len)).astype(
        np.float32)).to(device)
    p = copy.deepcopy(pparams)
    state = init_state(p, make_optimizer(0.0, params=p.parameters(),
                                         kind="adamw", weight_decay=1e-4,
                                         grad_clip=1.0))
    s = pspec._replace(solver_mode="pallas")
    pstep = make_train_step(lambda q, xb, yb: torch.mean(
        (F.latent_ode_forecast(q, s, xb) - yb) ** 2))
    out["ett point B=64"] = cs.cuda_ms(lambda: pstep(state, x64, y64), 10,
                                       windows=5)
    cwins = cs.cond_windows()
    cspec = CD.make_denoiser_spec("kan_fet_all_node", d_in=cwins.shape[2],
                                  pred_len=24)
    cparams = CD.cond_denoiser_init(torch.Generator().manual_seed(0), cspec,
                                    device=device)
    sched = make_schedule(250, device=device)
    past = torch.from_numpy(cwins[np.arange(64)]).to(device)
    fut = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (64, 24, 7)).astype(np.float32)).to(device)
    q = copy.deepcopy(cparams)
    cstate = init_state(q, make_optimizer(0.0, params=q.parameters(),
                                          kind="adamw", weight_decay=1e-4,
                                          grad_clip=1.0))
    cs_auto = cspec._replace(solver_mode="auto")

    def closs(p_, xb, yb):
        g = torch.Generator(device=device).manual_seed(0)
        return drv.cond_diffusion_loss(p_, cs_auto, sched, xb, yb, g)
    cstep = make_train_step(closs)
    out["cond_diffusion kan_fet_all_node B=64"] = cs.cuda_ms(
        lambda: cstep(cstate, past, fut), 5, windows=5)
    for argv, label in ((["--source", "ett"], "serve ett"),
                        (["--source", "ecg"], "serve ecg"),
                        (["--source", "ecg", "--field", "mlp"],
                         "serve ecg mlp")):
        with tempfile.TemporaryDirectory() as tmp:
            res = cli.main(["serve", *argv, "--solver_mode", "pallas",
                            "--device", "cuda", "--buckets", "8,64,256",
                            "--out-dir", tmp])
        for row in res["bench"]:
            out[f"{label} p50 bucket {row['batch']}"] = row["p50_ms"]
    for k, v in out.items():
        print(f"{k}: {v:.4f} ms ({smi})", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="checkout")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    from concurrent.futures import ThreadPoolExecutor

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
    names = ("custom_field",) if parts == ["b14"] else KERNELS
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for name, so in zip(names, built):
        _build.load_library(name)
        for line in so.with_suffix(".log").read_text().splitlines():
            if name in ("logistic_node", "mlp_node", "node_enc",
                        "custom_field") and (
                    "registers" in line or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    fns = dict(b5=b5_part, b6=b6_part, b8=b8_part, b7=b7_part, b4=b4_part,
               b14=b14_part, others=others_part, steps=steps_part)
    res = dict(tag=args.tag, card=smi)
    for name in parts:
        res[name] = fns[name](cs, device, smi)
    if args.breakdown:
        from fetode_tpu_torch.tools import clock_build as CB

        if "b5" in parts and CB.has_marks("logistic_node"):
            res["b5_breakdown"] = b5_breakdown(cs, device, smi)
        if "b14" in parts:
            res["b14_breakdown"] = b14_breakdown(cs, device, smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
