"""Shared epoch batching: shuffled, stacked (n_batches, B, ...) arrays
(counterpart of ``fetode_tpu/data/batching.py``).

One implementation behind every driver's minibatch epoch.  The shuffle
is the JAX package's native one (``native/fetode_native.cpp:
fet_shuffle``, which it takes wherever g++ builds its runtime): a
Fisher-Yates pass from the last index down, each swap partner drawn from
a splitmix64 stream in 64-bit unsigned arithmetic, seed 0 read as 1.
The port keeps its own copy, so the same seed gives the same order as
the JAX package.  Short last batches are dropped or padded by
wrap-around.
"""

from __future__ import annotations

import numpy as np

_MASK = (1 << 64) - 1


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """``fet_shuffle`` of ``arange(n)``: for i from n-1 down to 1, swap i
    with ``splitmix64() % (i + 1)``, all arithmetic modulo 2**64."""
    idx = list(range(n))
    s = (seed & _MASK) or 1
    for i in range(n - 1, 0, -1):
        s = (s + 0x9E3779B97F4A7C15) & _MASK
        z = ((s ^ (s >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        j = (z ^ (z >> 31)) % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx, dtype=np.int64)


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
