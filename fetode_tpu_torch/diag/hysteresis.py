"""Hysteresis-loop diagnostics (counterpart of
``fetode_tpu/diag/hysteresis.py``): drive every basis function of a
ferro layer with an up-then-down field sweep, read the per-basis
responses, measure the loops' openness and plot them with the learned
device parameters in the titles.

The sweep threads the state through 2 x ``n_points`` evaluations of the
raw basis (``ops/ferro.py: ferro_basis``, not the layer's summed
output), so it runs the plain op on every device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from fetode_tpu_torch.ops.ferro import (
    FerroConfig,
    FerroParams,
    ferro_basis,
    ferro_state_init,
)


@torch.no_grad()
def sweep_loop(params: FerroParams, cfg: FerroConfig, *, e_max: float = 3.0,
               n_points: int = 81,
               generator: Optional[torch.Generator] = None):
    """Drive every basis function through an up-then-down field sweep.

    Returns ``(fields (2N,), responses (2N, in, out, K))``, numpy arrays;
    the responses are the raw basis values, the state (float32, as the
    field) threaded through the sweep.  The device response is clean
    unless ``generator`` is given and ``cfg.noise_std > 0``: then each
    field point draws fresh device noise from it (the reference's
    noisy-loop panels, ``compare_noise_ecg.py:398-513``).
    """
    use_noise = generator is not None and cfg.noise_std > 0
    if not use_noise:
        cfg = cfg._replace(noise_std=0.0)
    up = np.linspace(-e_max, e_max, n_points)
    fields = np.concatenate([up, up[::-1]])
    device = params.k.device
    state = ferro_state_init((1,), cfg, device=device)
    responses = []
    for e in fields.astype(np.float32):
        x = torch.full((1, cfg.in_dim), float(e), dtype=torch.float32,
                       device=device)
        b, state = ferro_basis(params, state, x, cfg,
                               generator=generator if use_noise else None)
        responses.append(b[0])
    return fields, torch.stack(responses).cpu().numpy()


def loop_openness(params: FerroParams, cfg: FerroConfig, **kw) -> np.ndarray:
    """Mean |up branch - down branch| per basis function (in, out, K);
    > 0 where the device shows hysteresis."""
    fields, resp = sweep_loop(params, cfg, **kw)
    n = len(fields) // 2
    return np.abs(resp[:n] - resp[n:][::-1]).mean(axis=0)


def plot_loops(params: FerroParams, cfg: FerroConfig, out_dir: str,
               *, max_panels: int = 16, e_max: float = 3.0,
               n_points: int = 81, prefix: str = "hysteresis",
               generator: Optional[torch.Generator] = None):
    """Save P-E loop panels ``<prefix>_i<i>_o<o>_k<k>.png`` (one per basis
    function, at most ``max_panels``, the learned parameters in the title)
    to ``out_dir``; ``generator`` draws device noise at every field point.
    Returns the paths."""
    from fetode_tpu_torch.diag.plots import _plt

    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    fields, resp = sweep_loop(params, cfg, e_max=e_max, n_points=n_points,
                              generator=generator)
    n = len(fields) // 2
    host = {name: getattr(params, name).detach().cpu().numpy()
            for name in ("ps", "ec", "k", "coef")}
    paths = []
    for i in range(cfg.in_dim):
        for o in range(cfg.out_dim):
            for k in range(cfg.num_basis):
                if len(paths) >= max_panels:
                    return paths
                fig, ax = plt.subplots(figsize=(4, 3))
                ax.plot(fields[:n], resp[:n, i, o, k], label="up sweep")
                ax.plot(fields[n:], resp[n:, i, o, k], label="down sweep")
                ax.set_xlabel("E")
                ax.set_ylabel("P")
                ax.set_title(
                    f"in{i} out{o} k{k}: "
                    f"Ps={host['ps'][i, o, k]:.2f} "
                    f"Ec={host['ec'][i, o, k]:.2f} "
                    f"k={host['k'][i, o, k]:.2f} "
                    f"coef={host['coef'][i, o, k]:.2f}")
                ax.legend(fontsize=7)
                fig.tight_layout()
                path = os.path.join(out_dir, f"{prefix}_i{i}_o{o}_k{k}.png")
                fig.savefig(path, dpi=120)
                plt.close(fig)
                paths.append(path)
    return paths
