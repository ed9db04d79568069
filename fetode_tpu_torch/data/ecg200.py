"""ECG200 time-series classification data (counterpart of
``fetode_tpu/data/ecg200.py``).

Whitespace rows with the class label in column 0, labels remapped
consistently to ``0..C-1`` across splits, each 96-point series
z-normalised per row.  ``synthetic_ecg200`` is the in-repo stand-in with
the same shapes and label contract.  Everything is numpy, as in the JAX
package; ``znorm_rows`` is the port's own copy of the JAX package's
native z-norm (``native/fetode_native.cpp: fet_znorm_rows``, which it
takes wherever g++ builds its runtime), so the two give the same bits.
``epoch_batches`` lives in ``data/batching.py`` and is re-exported here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fetode_tpu_torch.data.batching import epoch_batches
from fetode_tpu_torch.data.paths import locate


def znorm_rows(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """``fet_znorm_rows`` of a float32 (n, t) array: the mean and the sum
    of squared deviations in float64, added in row order (a cumulative
    sum, not numpy's pairwise ``sum``); ``sd = float32(sqrt(var / t)) +
    eps`` and ``(x - float32(mu)) / sd`` in float32."""
    x = np.ascontiguousarray(x, np.float32)
    t = x.shape[1]
    x64 = x.astype(np.float64)
    mu = np.cumsum(x64, axis=1)[:, -1:] / t
    var = np.cumsum((x64 - mu) ** 2, axis=1)[:, -1:]
    sd = np.sqrt(var / t).astype(np.float32) + np.float32(eps)
    return (x - mu.astype(np.float32)) / sd


def _parse(path: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.loadtxt(path)
    return raw[:, 1:].astype(np.float32), raw[:, 0]


def load_ecg200(train_path: str | None = None, test_path: str | None = None,
                normalize: bool = True):
    """Returns ``(x_train, y_train, x_test, y_test)`` as numpy arrays,
    labels encoded 0..C-1 consistently across both splits."""
    train_path = train_path or locate("ECG200_TRAIN.txt")
    test_path = test_path or locate("ECG200_TEST.txt")
    if train_path is None or test_path is None:
        raise FileNotFoundError(
            "ECG200 files not found; set FETODE_DATA_DIR or pass paths "
            "(tests can use synthetic_ecg200)")
    xtr, ltr = _parse(train_path)
    xte, lte = _parse(test_path)
    classes = np.unique(np.concatenate([ltr, lte]))
    remap = {c: i for i, c in enumerate(classes)}
    ytr = np.asarray([remap[c] for c in ltr], np.int32)
    yte = np.asarray([remap[c] for c in lte], np.int32)
    if normalize:
        xtr, xte = znorm_rows(xtr), znorm_rows(xte)
    return xtr, ytr, xte, yte


def synthetic_ecg200(seed: int = 0, n_train: int = 64, n_test: int = 32,
                     T: int = 96):
    """Deterministic stand-in with the same shapes and label contract:
    class 0 = smooth beat (gaussian bump), class 1 = beat with a sharp
    notch."""
    rng = np.random.default_rng(seed)

    def make(n):
        t = np.linspace(0, 1, T)
        y = (np.arange(n) % 2).astype(np.int32)   # balanced classes
        rng.shuffle(y)
        bump = np.exp(-((t - 0.4) ** 2) / 0.01)
        notch = -1.5 * np.exp(-((t - 0.6) ** 2) / 0.005)
        x = bump[None, :] + y[:, None] * notch[None, :]
        x = x + rng.normal(0, 0.1, (n, T))
        return znorm_rows(x.astype(np.float32)), y

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


def batch_iterator(x, y, batch_size: int, *, seed: int = 0,
                   drop_last: bool = True):
    """Pre-shuffled full-epoch batch arrays: (n_batches, B, ...)."""
    return epoch_batches(x, y, batch_size=batch_size, seed=seed,
                         drop_last=drop_last)
