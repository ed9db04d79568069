"""Export a serving bundle, then load and serve from it (the port's
counterpart of ``examples/03_serving_bundle.py``).

``serve.py: export_servable`` writes any model's parameters and the
bundle's meta (batch buckets, sample shape, the exporting world's
fingerprint); ``load_servable`` loads them into a skeleton of the same
model and serves ``fn(params, batch)`` behind bucket padding and
chunking.  Here the model is the ECG KanFet-NODE classifier at a small
latent size (16, 4 bases, 16 attempts); on the card its latent solve is
the logistic-mixer kernel pair (B.5), whose step control is shared by
the batch, so a served request is compared with a direct call on the
same padded batch.  The CLI equivalent is ``cli serve --source ecg``.

Run:  python -m fetode_tpu_torch.examples.serving_bundle [bundle_dir]
      [--device cpu]

The last line is ``served = direct calls on the padded batch: OK``.
"""

from __future__ import annotations

import argparse
import copy
import tempfile

import numpy as np
import torch

from fetode_tpu_torch.models import ecg as M
from fetode_tpu_torch.serve import export_servable, load_servable, serve_bench
from fetode_tpu_torch.utils.device import resolve_device

BUCKETS = (1, 8, 32)


def main(argv=None):
    """Export, load, serve 20 series and check them; returns (logits of the
    20 series, the direct call's logits on their padded batch, the bench
    row at B = 8)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = args.bundle_dir or tempfile.mkdtemp(prefix="fetode_bundle_")

    spec = M.KanFetNODESpec(T=96, latent_dim=16, num_basis=4, max_steps=16)
    params = M.kanfet_node_init(torch.Generator().manual_seed(0), spec,
                                device=device)

    def fn(p, x):
        return M.kanfet_node_apply(p, spec, x)
    example = torch.zeros((1, spec.T), dtype=torch.float32, device=device)

    meta = export_servable(out_dir, params, example, buckets=BUCKETS)
    print(f"exported -> {out_dir} (buckets {meta['buckets']})")
    # A copy of the module is the skeleton the bundle loads into.
    servable = load_servable(out_dir, fn, copy.deepcopy(params))
    x = np.random.default_rng(0).normal(size=(20, spec.T)).astype(np.float32)
    logits = servable.predict(x)              # B=20 -> bucket 32, sliced
    print("predict(20 x 96) ->", tuple(logits.shape))
    assert logits.shape == (20, spec.num_classes)
    assert bool(torch.isfinite(logits).all())

    # The same padded batch (copies of the last row up to the bucket)
    # through the exporting process's module.
    xt = torch.from_numpy(x).to(device)
    padded = torch.cat([xt, xt[-1:].expand(BUCKETS[-1] - len(x), spec.T)])
    with torch.no_grad():
        direct = fn(params, padded)[:len(x)]
    assert torch.equal(logits, direct), \
        float((logits - direct).abs().max())

    stats = serve_bench(servable, x[:8], iters=5)
    print(f"p50 latency at B=8: {stats['p50_ms']:.2f} ms on "
          f"{stats['device']}")
    print("served = direct calls on the padded batch: OK")
    return logits, direct, stats


if __name__ == "__main__":
    main()
