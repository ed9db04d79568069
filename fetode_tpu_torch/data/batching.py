"""Shared epoch batching: shuffled, stacked (n_batches, B, ...) arrays
(counterpart of ``fetode_tpu/data/batching.py``).

One implementation behind every driver's minibatch epoch.  The shuffle
is numpy's ``default_rng(seed)``, the JAX package's fallback when its
C++ runtime is not built; short last batches are dropped or padded by
wrap-around.
"""

from __future__ import annotations

import numpy as np


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    idx = np.arange(n, dtype=np.int64)
    np.random.default_rng(seed).shuffle(idx)
    return idx


def epoch_batches(*arrays, batch_size: int, seed: int = 0,
                  drop_last: bool = True):
    """Shuffle consistently and stack each array into (n_batches, B, ...).
    ``batch_size`` is clamped to the dataset size; a short last batch is
    dropped or, with ``drop_last=False``, padded by wrap-around."""
    n = len(arrays[0])
    batch_size = min(batch_size, n)
    idx = shuffled_indices(n, seed)
    nb = max(n // batch_size if drop_last else -(-n // batch_size), 1)
    out = []
    for a in arrays:
        batches = []
        for i in range(nb):
            sel = idx[i * batch_size:(i + 1) * batch_size]
            if len(sel) < batch_size:
                sel = np.concatenate([sel, idx[:batch_size - len(sel)]])
            batches.append(a[sel])
        out.append(np.stack(batches))
    return tuple(out)
