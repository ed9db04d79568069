"""A short first check of the node-encoder kernels (``csrc/node_enc.cu``,
ROADMAP B.8) on one CUDA card: build them, run each at the encoder's
full width (C = P = H = 128, L = 96, 7 input columns) against its plain
version at the batches the conditional-diffusion path launches, and time
the forward and backward at B = 64 and 256 with CUDA events.

    python3 tools/node_enc_first.py

The past windows and the cotangents are standard normal draws from a
numpy seed, the encoder's weights from a torch seed.  Prints the build's
register report, and per batch the attempts, the forward's max |diff|,
the backward's relative errors and whether two backward calls give the
same bits.  ``chip_smoke.py`` phases 24-27 make the full checks.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fetode_tpu_torch.models import cond_diffusion as CD  # noqa: E402
from fetode_tpu_torch.ops import _build  # noqa: E402
from fetode_tpu_torch.ops import node_common as NC  # noqa: E402
from fetode_tpu_torch.ops import node_enc as NE  # noqa: E402
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
    return float((a.cpu() - b).norm() / b.norm())


def main():
    dev = resolve_device("cuda")
    t0 = time.time()
    so = _build.build("node_enc")
    print("built", so, time.time() - t0, flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(" ", line.strip())
    cfg = CD.NodeEncoderCfg(d_in=7)
    enc = CD.node_encoder_init(torch.Generator().manual_seed(0), cfg,
                               device=dev)
    w = NE.field_weights(enc)
    rng = np.random.default_rng(0)
    for B in (64, 31, 181, 8, 256):
        past = torch.from_numpy(rng.standard_normal((B, 96, 7)).astype(
            np.float32)).to(dev)
        with torch.no_grad():
            x_seq = past @ enc.x_proj_w.T + enc.x_proj_b
            z0 = x_seq[:, 0] @ enc.z0_w.T + enc.z0_b
            zk, rk = NE.node_enc_fwd(w, z0, x_seq)
            zn, _ = NE.node_enc_fwd(w, z0, x_seq, record=False)
            torch.cuda.synchronize()
            zp, rp = NC.record_solve_traj_reference(
                NE.node_enc_field(w, x_seq), z0, NE._ts(dev), max_steps=24)
        zp = zp[1]
        n = int(rk.misc[0])
        print(f"B={B} attempts kernel {rk.misc.tolist()} plain "
              f"{rp.misc.tolist()} accepts {rk.tda[:n, 1].tolist()}; fwd "
              f"max|d| {(zk - zp).abs().max().item():.3e}, norec==rec "
              f"{torch.equal(zk, zn)}", flush=True)
        ct = torch.from_numpy(rng.standard_normal((B, 128)).astype(
            np.float32)).to(dev)
        gk, z0k, xk = NE.node_enc_bwd(w, z0, x_seq, rk, ct)
        gk2, z0k2, xk2 = NE.node_enc_bwd(w, z0, x_seq, rk, ct)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(gk + [z0k, xk],
                                                     gk2 + [z0k2, xk2]))
        gp, z0p, xp = NE.node_enc_bwd(
            [t.cpu() for t in w], z0.cpu(), x_seq.cpu(),
            NC.SolveRecords(*(r.cpu() for r in rk)), ct.cpu())
        rels = [round(rel(a, b), 7) for a, b in zip(gk, gp)]
        print(f"  bwd rel grads {rels} z0bar {rel(z0k, z0p):.3e} xbar "
              f"{rel(xk, xp):.3e} same bits {same}", flush=True)
        if B in (64, 256):
            with torch.no_grad():
                tf = event_ms(lambda: NE.node_enc_fwd(w, z0, x_seq))
                tn = event_ms(lambda: NE.node_enc_fwd(w, z0, x_seq,
                                                      record=False))
            tb = event_ms(lambda: NE.node_enc_bwd(w, z0, x_seq, rk, ct))
            print(f"  time fwd {tf:.4f} ms norec {tn:.4f} bwd {tb:.4f}",
                  flush=True)
    print("launches", NE.node_enc_fwd.launches, NE.node_enc_bwd.launches)


if __name__ == "__main__":
    main()
