"""A short first check of the ECG 'mlp' field kernels (``csrc/mlp_node.cu``,
ROADMAP B.6) on one CUDA card: build them, run each at the ECG preset's
width (D = 64, K = 12, hidden 128) against its plain version at the
batches the ECG path launches, and time the forward and backward at
B = 8 and 64 with CUDA events.

    python3 tools/mlp_node_first.py

Two parameter sets, both from a torch seed: the init ("init", whose field
is tiny: out_w has std 1e-3) and the same with out_w drawn with std 4,
log_alpha 0.5 and both KAN layers' weights tripled ("scaled"), whose solve
takes several attempts.  The initial states are standard normal draws
from a numpy seed through the encoder, the cotangents standard normal.
Prints the build's register report, and per batch the attempts, the
forward's max |diff|, the backward's relative errors and whether two
backward calls give the same bits; exits non-zero on a mismatch.
``chip_smoke.py`` phases 28-31 make the full checks.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fetode_tpu_torch.models import ecg as M  # noqa: E402
from fetode_tpu_torch.ops import _build  # noqa: E402
from fetode_tpu_torch.ops import mlp_node as MN  # noqa: E402
from fetode_tpu_torch.ops import node_common as NC  # noqa: E402
from fetode_tpu_torch.utils.device import resolve_device  # noqa: E402


def event_ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def rel(a, b):
    return float((a - b).norm() / b.norm())


def main():
    dev = resolve_device("cuda")
    t0 = time.time()
    so = _build.build("mlp_node")
    print("built", so.name, f"{time.time() - t0:.1f}s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(" ", line.strip())
    spec = M.KanFetNODESpec(num_basis=12, field="mlp")
    rng = np.random.default_rng(0)
    ok = True
    for regime in ("init", "scaled"):
        params = M.kanfet_node_init(torch.Generator().manual_seed(0), spec,
                                    device=dev)
        if regime == "scaled":
            with torch.no_grad():
                params.out_w.normal_(0.0, 4.0)
                params.log_alpha.fill_(0.5)
                for layer in params.kan.layers:
                    layer.base_weight.mul_(3.0)
                    layer.spline_weight.mul_(3.0)
        w = MN.mlp_weights(params)
        for B in (8, 32, 64, 256):
            x = torch.from_numpy(rng.standard_normal((B, spec.T)).astype(
                np.float32)).to(dev)
            hbar = torch.from_numpy(rng.standard_normal(
                (B, spec.latent_dim)).astype(np.float32)).to(dev)
            with torch.no_grad():
                h0 = x @ params.encoder_w.T + params.encoder_b
                hk, rk = MN.mlp_node_fwd(w, h0)
                hn, _ = MN.mlp_node_fwd(w, h0, record=False)
                torch.cuda.synchronize()
                hp, rp = NC.record_solve_reference(MN.mlp_field(w), h0)
            n_k, n_p = int(rk.misc[0]), int(rp.misc[0])
            fwd = float((hk - hp).abs().max())
            same_fwd = torch.equal(hk, hn)
            g1, b1 = MN.mlp_node_bwd(w, h0, rk, hbar)
            g2, b2 = MN.mlp_node_bwd(w, h0, rk, hbar)
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip(g1 + [b1],
                                                         g2 + [b2]))
            gp, bp = NC.replay_vjp_reference(MN.mlp_field(w),
                                             MN.grad_weights(w), h0, rk,
                                             hbar)
            rels = [rel(a, b) if b.norm() > 0 else float(a.norm())
                    for a, b in zip(g1, gp)]
            hrel = rel(b1, bp)
            print(f"{regime} B={B}: attempts kernel {n_k} plain {n_p} "
                  f"(accepted {rk.tda[:n_k, 1].sum().item():.0f}); fwd max|d| "
                  f"{fwd:.3e}, norec == rec {same_fwd}; bwd rel "
                  f"{['%.2e' % r for r in rels]} h0bar {hrel:.3e}; same "
                  f"bits {same}", flush=True)
            ok &= (n_k == n_p and fwd <= 1e-3 * (1 + float(hp.abs().max()))
                   and max(rels) < 1e-4 and hrel < 1e-4 and same)
            if B in (8, 64):
                with torch.no_grad():
                    tf = event_ms(lambda: MN.mlp_node_fwd(w, h0))
                    tn = event_ms(lambda: MN.mlp_node_fwd(w, h0,
                                                          record=False))
                tb = event_ms(lambda: MN.mlp_node_bwd(w, h0, rk, hbar))
                print(f"  time fwd {tf:.4f} ms, without records {tn:.4f}, "
                      f"bwd {tb:.4f}", flush=True)
    print("launches", MN.mlp_node_fwd.launches, MN.mlp_node_bwd.launches)
    if not ok:
        sys.exit("mlp_node: a kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
