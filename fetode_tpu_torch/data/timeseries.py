"""Time-series loading, scaling, splitting and windowing (counterpart of
``fetode_tpu/data/timeseries.py``).

numpy throughout, as in the JAX package.  The windows are one numpy
gather (the JAX package's ``data/native.py: window_gather`` without its
C++ runtime); ``window_batches`` shuffles with the port's
``epoch_batches`` (``data/batching.py``).  ``load_ett_csv`` and
``load_timemmd_csv`` read the CSV as a table of ``data/columns.py`` and
do the JAX loaders' pandas steps on it, so neither needs pandas.
``window_gather`` cuts windows at given starts (the conditional-diffusion
futures).  ``synthetic_series`` is the stand-in the CLI uses when the
ETT or Time-MMD files are absent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from fetode_tpu_torch.data.batching import epoch_batches
from fetode_tpu_torch.data.columns import (
    fill_missing,
    is_numeric,
    isna,
    numeric_matrix,
    read_csv,
    sort_order,
    take,
    to_datetime,
)
from fetode_tpu_torch.data.paths import locate


class Standardizer(NamedTuple):
    mu: np.ndarray
    sd: np.ndarray

    def apply(self, x):
        return (x - self.mu) / self.sd

    def invert(self, x):
        return x * self.sd + self.mu


def standardize_fit(x: np.ndarray, eps: float = 1e-8) -> Standardizer:
    """Train-split-only statistics (leakage-safe)."""
    return Standardizer(mu=x.mean(0, keepdims=True),
                        sd=x.std(0, keepdims=True) + eps)


def load_ett_csv(csv_path: Optional[str] = None, target_col: str = "OT",
                 name: str = "ETTh1"):
    """ETT csv -> (X (N, F) numeric columns incl. the target, y (N,) the
    target, the column names of X)."""
    csv_path = csv_path or locate(f"ETT/{name}.csv")
    if csv_path is None:
        raise FileNotFoundError(f"{name}.csv not found; set FETODE_DATA_DIR")
    table = read_csv(csv_path)
    numeric = [c for c, v in table.items() if is_numeric(v)]
    if target_col not in numeric:
        raise ValueError(f"target {target_col!r} not numeric; have {numeric}")
    X = numeric_matrix(table, numeric).astype(np.float32)
    return X, table[target_col].astype(np.float32), numeric


def _equals(values: np.ndarray, value) -> np.ndarray:
    """``df[col] == value`` of pandas: a text column compares cell by
    cell, a numeric one only with a number."""
    if values.dtype == object:
        return np.asarray([v == value for v in values], bool)
    if isinstance(value, (int, float, np.number)):
        return values == value
    return np.zeros(len(values), bool)


def load_timemmd_csv(csv_path: str, target_col: str,
                     date_col: Optional[str] = None,
                     drop_cols: Tuple[str, ...] = (),
                     area_filter: Optional[Tuple[str, str]] = None):
    """Time-MMD numeric csv loader (Energy / Climate): the rows whose
    ``area_filter`` column equals its value, sorted by ``date_col`` as
    pandas sorts (``columns.sort_order``), ``drop_cols`` dropped, the
    numeric columns that are not all missing, forward- then back-filled.
    Returns (X (N, F) float32, y (N,) float32, the table after the
    filter, the sort and the drops)."""
    df = read_csv(csv_path)
    if area_filter is not None:
        col, val = area_filter
        if col in df:
            df = take(df, np.flatnonzero(_equals(df[col], val)))
    if date_col and date_col in df:
        df[date_col] = to_datetime(df[date_col])
        df = take(df, sort_order(df[date_col]))
    for c in drop_cols:
        df.pop(c, None)
    numeric = [c for c, v in df.items()
               if is_numeric(v) and not isna(v).all()]
    if target_col not in numeric:
        raise ValueError(f"target {target_col!r} not in numeric columns "
                         f"{numeric}")
    filled = {c: fill_missing(df[c]) for c in numeric}
    return numeric_matrix(filled, numeric).astype(np.float32), \
        filled[target_col].astype(np.float32), df


def split_time_series(n: int, train_frac: float = 0.7, val_frac: float = 0.1):
    """Chronological index splits."""
    n_train = int(n * train_frac)
    n_val = int(n * val_frac)
    return slice(0, n_train), slice(n_train, n_train + n_val), \
        slice(n_train + n_val, n)


def make_windows(X: np.ndarray, y: np.ndarray, context_len: int,
                 pred_len: int):
    """All sliding windows: x_ctx (M, context_len, F), y_fut (M, pred_len)."""
    m = len(X) - (context_len + pred_len) + 1
    if m <= 0:
        raise ValueError("series shorter than context_len + pred_len")
    X = np.ascontiguousarray(X, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    starts = np.arange(m)[:, None]
    return (X[starts + np.arange(context_len)[None, :]],
            y[starts + context_len + np.arange(pred_len)[None, :]])


def window_gather(X: np.ndarray, starts: np.ndarray, ctx: int) -> np.ndarray:
    """(n, f) array + m start indices -> (m, ctx, f) windows (the numpy
    form of ``fetode_tpu/data/native.py: window_gather``)."""
    X = np.ascontiguousarray(X, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    return X[starts[:, None] + np.arange(ctx)[None, :]]


def window_batches(x_ctx: np.ndarray, y_fut: np.ndarray, batch_size: int,
                   *, seed: int = 0, drop_last: bool = True):
    """(n_batches, B, ...) stacked shuffled minibatches of one epoch."""
    return epoch_batches(x_ctx, y_fut, batch_size=batch_size, seed=seed,
                         drop_last=drop_last)


def synthetic_series(seed: int = 0, n: int = 400, n_features: int = 4):
    """Deterministic multiscale sinusoid + trend stand-in for ETT."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32)
    feats = []
    for f in range(n_features):
        period = 24.0 * (f + 1)
        feats.append(np.sin(2 * np.pi * t / period + f)
                     + 0.05 * rng.standard_normal(n))
    X = np.stack(feats, 1).astype(np.float32)
    y = (X.sum(1) + 0.002 * t).astype(np.float32)
    X = np.concatenate([X, y[:, None]], axis=1)
    return X, y
