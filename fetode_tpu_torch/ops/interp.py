"""Interpolation of a sampled signal for non-autonomous ODE right-hand
sides (counterpart of ``fetode_tpu/ops/interp.py: linear_interp``).

When the vector field depends on an external signal ``x(t)`` sampled on
a grid, the solver needs ``x`` at arbitrary stage times: a gather of the
two bracketing samples and a lerp.  The conditional-diffusion node
encoder takes it eagerly (``models/cond_diffusion.py``); its CUDA kernel
reads the same two rows in the kernel body (``ops/node_enc.py``).
"""

from __future__ import annotations

import torch


def linear_interp(ts: torch.Tensor, xs: torch.Tensor, t) -> torch.Tensor:
    """Piecewise-linear interpolation, clamped at the ends.

    Args:
      ts: (T,) strictly increasing sample times.
      xs: (..., T, D) sampled values (any leading batch dims).
      t:  scalar query time (a float or a 0-d tensor).

    Returns:
      (..., D) interpolated value.
    """
    t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device).clamp(ts[0],
                                                                   ts[-1])
    hi = torch.searchsorted(ts, t.reshape(1), right=True)[0].clamp(
        1, ts.shape[0] - 1)
    lo = hi - 1
    t0, t1 = ts[lo], ts[hi]
    w = (t - t0) / torch.where(t1 == t0, torch.ones_like(t1), t1 - t0)
    x0 = xs.index_select(-2, lo.reshape(1)).squeeze(-2)
    x1 = xs.index_select(-2, hi.reshape(1)).squeeze(-2)
    return x0 + w * (x1 - x0)
