"""Check and time B.11, the fused Kuramoto classifier
(``csrc/kuramoto.cu: kuramoto_logits``), and B.10, the rollout pair
(``kuramoto_fwd`` / ``kuramoto_bwd``), of the package this file is
imported from, on one card.

    python -m fetode_tpu_torch.tools.kuramoto_times [--tag NAME] [--breakdown]
        [--b10-out FILE] [--b10-against FILE]

Run from the root of a checkout (it imports that checkout's
``chip_smoke`` for its inputs, bounds and timers).  To compare two
builds, copy this file into a ``git archive`` of the other commit and
run both from their roots in one call, in the order A, B, B, A.  It
builds ``kuramoto``, then:

* B.11 at the MNIST preset (28 x 28, 10 Euler steps, KANLinear(1568 ->
  10) with 8 logistic terms, the head packed once) at every batch of
  ``chip_smoke.KURA_LOGITS`` (8, 64, 128, 256, 1,024), phase 20's
  parameters and inputs: the logits against ``kuramoto_logits_reference``
  (rtol = atol = ``TOL``), the same bits twice, images 0 and B - 1 alone
  the same bits as in the batch; the device time a call on a full queue
  (``queued_ms``) and back to back (``cuda_ms``); the bound
  (``chip_smoke.kuramoto_counts``); the launch's plan (``ops/kuramoto.py:
  slice_plan``, where the checkout has it).
* B.10 at every batch of ``B10_BATCHES`` (8, 64 and
  ``chip_smoke.KURA_TIMES``: 128, 256, 1,024) and at 133, phase 19's
  parameters: the features against plain (the same bits), theta0bar of
  images 0 and B - 1 alone the same bits as in the batch, omegabar and
  Kbar the same bits twice; the device time a call of the forward and
  the backward (``queued_ms``); the bounds; the plan
  (``ops/kuramoto.py: rollout_plan``, where the checkout has it).  The
  backward again at 40 steps (``THETA_STEPS``, where the plan keeps
  theta_t alone) at B = 128 and 1,024: theta0bar, omegabar and Kbar
  against ``kuramoto_rollout_bwd_reference`` (relative error below
  ``chip_smoke.GRAD_TOL``, phase 19's gate), its ``queued_ms`` and plan.  With
  ``--b10-out`` its outputs at B = 8, 128 and 1,024 (features,
  theta0bar, omegabar, Kbar) are saved to FILE; with ``--b10-against``
  they are held against FILE, another build's: the features and
  theta0bar bit for bit, omegabar and Kbar by their largest difference.
* The MNIST ``pallas`` and ``pallas_fused`` training steps at B = 128
  (forward, cross-entropy, backward, AdamW at learning rate 0;
  ``cuda_ms``) and ``serve --source mnist`` p50 in buckets 8, 64 and
  256.
* With ``--breakdown``: a clock build of the checkout's ``kuramoto.cu``
  (``-DKURAMOTO_CLOCKS``; a source without those marks, the form before
  the cluster design, gets them by the fixed insertions of
  ``PARENT_MARKS``; ``tools/clock_build.py``), run at B = 8 and 256: the mean over CTAs of thread
  0's cycles in the rollouts, the wait for the parameters' load (and the
  reciprocals), the bases (the knot interval or the Cox-de Boor
  recursion, and SiLU), the weight products (the cluster form: SiLU's
  and the splines'; before it with the logistic terms), the logistic
  terms (sigmoids and products), the features' reads from the other
  CTAs, the reductions and the whole kernel.  And a clock build of B.10's
  backward (the checkout's marks in ``kuramoto_roll_clocks``, or the
  fixed insertions of ``PARENT_B10_MARKS`` in a source without them) at
  B = 128 and 1,024: the mean over CTAs of thread 0's cycles in the load,
  the replay's steps, the theta records' stores, the seed of the walk
  back, the reverse steps, the image's sums and the whole kernel, and of
  the batch sums' CTAs in that kernel.

No profiler.  Prints the card's name and power limit, one line a
measurement, and a last JSON line ``{"tag": ..., "b11": {...}, "b10":
{...}, "steps": {...}, "breakdown": {...}}``.  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

# The clock marks of the fused classifier before the cluster design:
# (anchor, text inserted after it), each anchor found once, on SLOTS: 0
# rollout, 2 bases (knots, Cox-de Boor, SiLU), 3 weight products (with the
# logistic terms there), 6 reduction, 7 the whole kernel; 1, 4 and 5 (the
# parameters' load, logistic terms, the features' reads) stay 0.
PARENT_MARKS = (
    ("namespace {\n", "__device__ long long kuramoto_clocks[8 * 1024];\n"),
    ("float (&acc)[kMaxClasses]) {\n"
     "  const int F = h.F, T = 1 + kCoeff + h.n_logistic;\n",
     "  const long long kc0 = clock64();\n"),
    ("  const float silu = __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));\n",
     "  const long long kc1 = clock64();\n"),
    ("      acc[c] += phi * __ldg(w + (size_t)c * T * F);\n    }\n  }\n",
     "  if (threadIdx.x == 0) {\n"
     "    kuramoto_clocks[8 * blockIdx.x + 2] += kc1 - kc0;\n"
     "    kuramoto_clocks[8 * blockIdx.x + 3] += clock64() - kc1;\n  }\n"),
    ("kuramoto_logits_kernel(Lattice L, Head h, const float* theta0, "
     "float* out) {\n  extern __shared__ float smem[];\n",
     "  const long long kk0 = clock64();\n"),
    ("  rollout<false>(th, S, L, smem, smem + L.HW, nullptr);\n\n"
     "  float acc[kMaxClasses];\n",
     "  if (threadIdx.x == 0) kuramoto_clocks[8 * blockIdx.x] = "
     "clock64() - kk0;\n"),
    ("    head_terms(c, S.i[k], h, acc);\n"
     "    head_terms(s, L.HW + S.i[k], h, acc);\n  }\n",
     "  const long long kr0 = clock64();\n"),
    ("    out[(size_t)blockIdx.x * h.C + threadIdx.x] = total;\n  }\n",
     "  if (threadIdx.x == 0) {\n"
     "    kuramoto_clocks[8 * blockIdx.x + 6] = clock64() - kr0;\n"
     "    kuramoto_clocks[8 * blockIdx.x + 7] = clock64() - kk0;\n  }\n"),
)

SLOTS = ("rollout", "load", "bases", "weights", "logistic", "reads",
         "reductions", "total")

# B.10's backward before its redesign (one 224-thread block an image, a
# 4-block batch sum), marked on B10_SLOTS (the records' stores stay 0,
# inside the replay) by fixed replacements: (anchor, its replacement),
# each anchor found once.
_ROLL = ("  load_theta(th, S, theta0, HW);\n"
         "  rollout<true>(th, S, L, s_sin, s_cos, rec);\n")
PARENT_B10_MARKS = (
    ("namespace {\n",
     "namespace {\n__device__ long long kuramoto_roll_clocks[8 * 1024];\n"),
    (_ROLL, "  const long long kb0 = clock64();\n"
            "  load_theta(th, S, theta0, HW);\n"
            "  const long long kb1 = clock64();\n"
            "  rollout<true>(th, S, L, s_sin, s_cos, rec);\n"
            "  const long long kb2 = clock64();\n"),
    ("  for (int t = L.steps - 1; t >= 0; --t) {\n",
     "  const long long kb3 = clock64();\n"
     "  for (int t = L.steps - 1; t >= 0; --t) {\n"),
    ("  const size_t row0 = (size_t)blockIdx.x * HW;\n",
     "  const long long kb4 = clock64();\n"
     "  const size_t row0 = (size_t)blockIdx.x * HW;\n"),
    ("  if (threadIdx.x == 0) pk[blockIdx.x] = total;\n",
     "  if (threadIdx.x == 0) pk[blockIdx.x] = total;\n"
     "  if (threadIdx.x == 0) {\n"
     "    long long* ck = kuramoto_roll_clocks + 8 * blockIdx.x;\n"
     "    const long long kb5 = clock64();\n"
     "    ck[0] = kb1 - kb0; ck[1] = kb2 - kb1; ck[3] = kb3 - kb2;\n"
     "    ck[4] = kb4 - kb3; ck[5] = kb5 - kb4; ck[7] = kb5 - kb0;\n  }\n"),
    ("                                       float* gom, float* gk, int B, "
     "int HW) {\n",
     "                                       float* gom, float* gk, int B, "
     "int HW) {\n  const long long kr0 = clock64();\n"),
    ("    *gk = acc;\n  }\n",
     "    *gk = acc;\n  }\n"
     "  if (threadIdx.x == 0) kuramoto_roll_clocks[8 * blockIdx.x + 6] = "
     "clock64() - kr0;\n"),
)
B10_SLOTS = ("load", "replay steps", "records", "seed", "reverse steps",
             "image sums", "batch sums", "total")
B10_BATCHES = (8, 64, 128, 256, 1024)
# Steps at which a 28 x 28 lattice's sin / cos records do not fit a CTA.
THETA_STEPS = 40


def _replace(src: str, marks) -> str:
    for anchor, text in marks:
        if src.count(anchor) != 1:
            raise RuntimeError(f"kuramoto_times: clock anchor found "
                               f"{src.count(anchor)} times: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def instrument(src: str) -> str:
    """The clock build's source: the checkout's marks, or PARENT_MARKS."""
    if "KURAMOTO_CLOCKS" not in src:
        src = _replace(src, [(a, a + t) for a, t in PARENT_MARKS])
    return src


def instrument_b10(src: str) -> str:
    """B.10's clock build: the checkout's marks, or PARENT_B10_MARKS."""
    if "kuramoto_roll_clocks" in src:
        return src
    return _replace(src, PARENT_B10_MARKS)


def setup(cs, device):
    """Phase 20's classifier: parameters, the head packed once, cases."""
    import numpy as np
    import torch

    from fetode_tpu_torch.models import kuramoto as TK
    from fetode_tpu_torch.ops import kuramoto as KO

    spec = TK.KuramotoSpec(rollout="pallas")
    params = TK.kuramoto_init(torch.Generator().manual_seed(0), spec,
                              device=device)
    with torch.no_grad():
        params.omega.copy_(torch.from_numpy(0.3 * np.random.default_rng(
            5).standard_normal((28, 28)).astype(np.float32)))
        params.K.fill_(0.7)
    head = [None if t is None else t.detach()
            for t in TK.head_operands(params.head)]
    packed = KO.pack_head(*head)
    batches = sorted(set(cs.KURA_LOGITS + cs.KURA_TIMES + B10_BATCHES))
    cases = {b: cs.kuramoto_case(device, b, 20 + i)
             for i, b in enumerate(batches)}
    return spec, params, head, packed, cases


def b11_part(cs, device, smi, ctx):
    import torch

    from fetode_tpu_torch.ops import kuramoto as KO

    spec, params, head, packed, cases = ctx
    lat = spec.lattice
    om, K = params.omega.detach(), params.K.detach()
    out = {}
    for b in cs.KURA_LOGITS:
        th0 = cases[b]["theta0"]
        args = (om, K, th0, *head, lat)
        with torch.no_grad():
            y = KO.kuramoto_logits(*args, packed=packed)
            y2 = KO.kuramoto_logits(*args, packed=packed)
            alone = [torch.equal(KO.kuramoto_logits(
                om, K, th0[r:r + 1], *head, lat, packed=packed), y[r:r + 1])
                for r in sorted({0, b - 1})]
            torch.cuda.synchronize()
            want = KO.kuramoto_logits_reference(*args)
            call = lambda: KO.kuramoto_logits(  # noqa: E731
                *args, packed=packed)
            row = dict(err=cs.max_abs(y, want), twice=bool(torch.equal(y, y2)),
                       alone=all(alone), ms=cs.queued_ms(call),
                       events_ms=cs.cuda_ms(call, 20),
                       bound=cs.bound(*cs.kuramoto_counts(b, 28, 28, 10,
                                                          "logits"))[0])
        if hasattr(KO, "slice_plan"):
            p = KO.slice_plan(28 * 28, packed.n_classes, packed.n_logistic, b)
            row["plan"] = dict(clusters=p["clusters"], weights=p["weights"],
                               smem_bytes=p["smem_bytes"])
        if not (torch.allclose(y, want, rtol=cs.TOL, atol=cs.TOL)
                and row["twice"] and row["alone"]):
            cs.fail(f"B.11 B={b}: {row}")
        out[b] = row
        print(f"B.11 kuramoto_logits B={b}: {row['ms']:.4f} ms on a full "
              f"queue (queued_ms), {row['events_ms']:.4f} ms back to back; "
              f"bound {row['bound']:.5f} ms; max |diff| {row['err']:.3e} vs "
              f"plain; the same bits twice and alone (images 0, B-1); "
              f"{row.get('plan', '')} ({smi})", flush=True)
    return out


def b10_part(cs, device, smi, ctx, out_file=None, against=None):
    """B.10's forward and backward: checks, device ms a call, plans; its
    outputs saved to ``out_file`` or held against ``against``."""
    import torch

    from fetode_tpu_torch.ops import kuramoto as KO

    spec, params, _, _, cases = ctx
    lat = spec.lattice
    om, K = params.omega.detach(), params.K.detach()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out, saved = {}, {}
    for b in B10_BATCHES + (133,):
        c = cases.get(b) or cs.kuramoto_case(device, b, 40)
        th0, ct = c["theta0"], c["ct"]
        with torch.no_grad():
            feat = KO.kuramoto_fwd(om, K, th0, lat)
            want = KO.kuramoto_rollout_reference(om, K, th0, lat)
        g1 = KO.kuramoto_bwd(om, K, th0, ct, lat)
        g2 = KO.kuramoto_bwd(om, K, th0, ct, lat)
        alone = [torch.equal(KO.kuramoto_bwd(om, K, th0[r:r + 1],
                                             ct[r:r + 1], lat)[0],
                             g1[0][r:r + 1]) for r in sorted({0, b - 1})]
        torch.cuda.synchronize()
        row = dict(plain_bits=bool(torch.equal(feat, want)),
                   twice=bool(torch.equal(g1[1], g2[1])
                              and torch.equal(g1[2], g2[2])),
                   alone=all(alone))
        if not all(row.values()):
            cs.fail(f"B.10 B={b}: {row}")
        with torch.no_grad():
            row["fwd"] = cs.queued_ms(lambda: KO.kuramoto_fwd(om, K, th0, lat))
        row["bwd"] = cs.queued_ms(lambda: KO.kuramoto_bwd(om, K, th0, ct,
                                                          lat))
        for kind in ("fwd", "bwd"):
            row[f"bound_{kind}"] = cs.bound(*cs.kuramoto_counts(
                b, 28, 28, 10, kind))[0]
        if hasattr(KO, "rollout_plan"):
            for kind in ("fwd", "bwd"):
                p = KO.rollout_plan(b, 28, 28, 10, sms, kind == "bwd")
                row[f"plan_{kind}"] = dict(k=p["k"], threads=p["threads"],
                                           ctas=p["ctas"], form=p["form"],
                                           waves=p["waves"])
        out[b] = row
        print(f"B.10 kuramoto rollout B={b}: forward {row['fwd']:.4f} ms, "
              f"backward {row['bwd']:.4f} ms on a full queue (queued_ms); "
              f"bounds {row['bound_fwd']:.5f} / {row['bound_bwd']:.5f} ms; "
              f"features plain's bits, theta0bar alone = in the batch, "
              f"omegabar and Kbar the same bits twice; "
              + ", ".join(f"{k} {v}" for k, v in row.items()
                          if k.startswith(("plan", "bwd_")))
              + f" ({smi})", flush=True)
        if b in (8, 128, 1024):
            saved[b] = [t.cpu() for t in (feat, *g1)]
    lat40 = lat._replace(steps=THETA_STEPS)
    for b in (128, 1024):
        c = cases[b]
        th0, ct = c["theta0"], c["ct"]
        got = KO.kuramoto_bwd(om, K, th0, ct, lat40)
        want = KO.kuramoto_rollout_bwd_reference(om, K, th0, ct, lat40)
        err = max(cs.rel_err(x, y) for x, y in zip(got, want))
        if not err < cs.GRAD_TOL:
            cs.fail(f"B.10 backward at {THETA_STEPS} steps B={b}: relative "
                    f"error {err:.3e} vs plain")
        row = dict(err=err, bwd=cs.queued_ms(
            lambda: KO.kuramoto_bwd(om, K, th0, ct, lat40)))
        if hasattr(KO, "rollout_plan"):
            p = KO.rollout_plan(b, 28, 28, THETA_STEPS, sms, True)
            row["plan_bwd"] = dict(k=p["k"], threads=p["threads"],
                                   ctas=p["ctas"], form=p["form"],
                                   waves=p["waves"])
        out[f"{b} steps {THETA_STEPS}"] = row
        print(f"B.10 kuramoto backward B={b} at {THETA_STEPS} steps: "
              f"{row['bwd']:.4f} ms on a full queue (queued_ms); relative "
              f"error {err:.3e} vs plain; {row.get('plan_bwd', '')} ({smi})",
              flush=True)
    if out_file:
        torch.save(saved, out_file)
    if against:
        other = torch.load(against)
        for b, mine in saved.items():
            theirs = other[b]
            same = [bool(torch.equal(x, y)) for x, y in zip(mine[:2],
                                                           theirs[:2])]
            diff = [float((x - y).abs().max()) for x, y in zip(mine[2:],
                                                              theirs[2:])]
            out[b]["against"] = dict(features_same=same[0],
                                     theta0bar_same=same[1],
                                     omegabar_kbar_max_diff=diff)
            print(f"B.10 B={b} against {against}: features the same bits "
                  f"{same[0]}, theta0bar {same[1]}; omegabar, Kbar max "
                  f"|diff| {diff} ({smi})", flush=True)
    return out


def steps_part(cs, device, smi, ctx):
    """The MNIST pallas and pallas_fused steps at B = 128 and serve
    --source mnist."""
    from fetode_tpu_torch import cli

    spec, params, _, _, cases = ctx
    c = cases[128]
    out = {f"mnist {r} step B=128": cs.cuda_ms(
        cs.mnist_step_fn(params, spec, c["x"], c["y"], r), 10, windows=5)
        for r in ("pallas", "pallas_fused")}
    with tempfile.TemporaryDirectory() as tmp:
        res = cli.main(["serve", "--source", "mnist", "--device", "cuda",
                        "--buckets", "8,64,256", "--out-dir", tmp])
    for row in res["bench"]:
        out[f"serve mnist p50 bucket {row['batch']}"] = row["p50_ms"]
    for k, v in out.items():
        print(f"{k}: {v:.4f} ms ({smi})", flush=True)
    return out


def breakdown_part(cs, device, smi, ctx):
    """Thread 0's cycles a CTA in each phase of the clock build."""
    import torch

    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.ops import kuramoto as KO
    from fetode_tpu_torch.tools import clock_build as CB

    spec, params, head, packed, cases = ctx
    lat = spec.lattice
    n = len(SLOTS)
    lib = CB.clock_library("kuramoto", n, instrument(
        (_build.SRC_DIR / "kuramoto.cu").read_text()))
    CB.copy_signatures(lib, KO._lib(), ("kuramoto_logits",
                                        "kuramoto_logits_plan"))
    keep = KO._lib
    KO._lib = lambda: lib
    out = {}
    try:
        for b in (8, 256):
            th0 = cases[b]["theta0"]
            with torch.no_grad():
                KO.kuramoto_logits(params.omega, params.K, th0, *head, lat,
                                   packed=packed)
                torch.cuda.synchronize()
                CB.clear_clocks(lib, "kuramoto")
                KO.kuramoto_logits(params.omega, params.K, th0, *head, lat,
                                   packed=packed)
                torch.cuda.synchronize()
            rows = CB.read_clocks(lib, "kuramoto", n)
            mean = {s: sum(r[k] for r in rows) / len(rows)
                    for k, s in enumerate(SLOTS)}
            out[b] = dict(ctas=len(rows), **mean)
            print(f"B.11 clock build B={b}: thread 0's cycles a CTA, mean over "
                  f"{len(rows)} CTAs: " + ", ".join(
                      f"{s} {mean[s]:.0f}" for s in SLOTS) + f" ({smi})",
                  flush=True)
    finally:
        KO._lib = keep
    return out


def b10_breakdown(cs, device, smi, ctx):
    """Thread 0's cycles a CTA in each phase of B.10's backward (clock
    build), and of the batch sums' CTAs."""
    import torch

    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.ops import kuramoto as KO
    from fetode_tpu_torch.tools import clock_build as CB

    spec, params, _, _, cases = ctx
    lat = spec.lattice
    n, sym = len(B10_SLOTS), "kuramoto_roll_clocks"
    lib = CB.clock_library("kuramoto", n, instrument_b10(
        (_build.SRC_DIR / "kuramoto.cu").read_text()), sym=sym)
    CB.copy_signatures(lib, KO._lib(), ("kuramoto_fwd", "kuramoto_bwd",
                                        "kuramoto_rollout_plan"))
    keep = KO._lib
    KO._lib = lambda: lib
    out = {}
    try:
        for b in (128, 1024):
            c = cases[b]
            KO.kuramoto_bwd(params.omega, params.K, c["theta0"], c["ct"], lat)
            torch.cuda.synchronize()
            CB.clear_clocks(lib, "kuramoto", sym)
            KO.kuramoto_bwd(params.omega, params.K, c["theta0"], c["ct"], lat)
            torch.cuda.synchronize()
            rows = CB.read_clocks(lib, "kuramoto", n, sym)
            mean = {s: sum(r[k] for r in rows) / len(rows)
                    for k, s in enumerate(B10_SLOTS)}
            red = [r[6] for r in rows if r[6] > 0]
            mean["batch sums"] = sum(red) / max(len(red), 1)
            out[b] = dict(ctas=len(rows), **mean)
            print(f"B.10 clock build, backward B={b}: thread 0's cycles a "
                  f"CTA, mean over {len(rows)} CTAs: " + ", ".join(
                      f"{s} {mean[s]:.0f}" for s in B10_SLOTS)
                  + f" (batch sums over {len(red)} CTAs) ({smi})", flush=True)
    finally:
        KO._lib = keep
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="checkout")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--b10-out", default=None)
    ap.add_argument("--b10-against", default=None)
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
    so = _build.build("kuramoto")
    _build.load_library("kuramoto")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas kuramoto: {line.strip()}")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    ctx = setup(cs, device)
    res = dict(tag=args.tag, card=smi, b11=b11_part(cs, device, smi, ctx),
               b10=b10_part(cs, device, smi, ctx, args.b10_out,
                            args.b10_against),
               steps=steps_part(cs, device, smi, ctx))
    if args.breakdown:
        res["breakdown"] = breakdown_part(cs, device, smi, ctx)
        res["b10_breakdown"] = b10_breakdown(cs, device, smi, ctx)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
