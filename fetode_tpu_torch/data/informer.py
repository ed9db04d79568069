"""Informer-style forecasting datasets: ETT hour / minute, custom,
predict (counterpart of ``fetode_tpu/data/informer.py``, the reference's
``Dataset_ETT_hour``, ``Dataset_ETT_minute``, ``Dataset_Custom`` and
``Dataset_Pred``).

Each split materialises dense window arrays once (numpy fancy indexing):
fixed month borders 12 / 4 / 4 x 24 (x 4 for the 15-minute files) or a
70 / 10 / 20 ratio split, the scaler fit on the train split.  A frame is
a table of ``data/columns.py`` (a dict of numpy columns, the date column
first, as the CSV has it); CSVs are read with ``columns.read_csv``.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Optional

import numpy as np

from fetode_tpu_torch.data.columns import (
    Table,
    numeric_matrix,
    read_csv,
    to_datetime,
)
from fetode_tpu_torch.data.paths import locate
from fetode_tpu_torch.data.timefeatures import time_features
from fetode_tpu_torch.data.timeseries import standardize_fit


class WindowSplit(NamedTuple):
    """Dense window arrays for one split."""

    seq_x: np.ndarray        # (M, seq_len, F)
    seq_y: np.ndarray        # (M, label_len + pred_len, Fy)
    seq_x_mark: np.ndarray   # (M, seq_len, T)
    seq_y_mark: np.ndarray   # (M, label_len + pred_len, T)


_ETT_HOUR_BORDERS = ([0, 12 * 30 * 24, 12 * 30 * 24 + 4 * 30 * 24],
                     [12 * 30 * 24, 12 * 30 * 24 + 4 * 30 * 24,
                      12 * 30 * 24 + 8 * 30 * 24])
_ETT_MIN_BORDERS = ([0, 12 * 30 * 24 * 4, (12 * 30 * 24 + 4 * 30 * 24) * 4],
                    [12 * 30 * 24 * 4, (12 * 30 * 24 + 4 * 30 * 24) * 4,
                     (12 * 30 * 24 + 8 * 30 * 24) * 4])


def _windows(data_x, data_y, marks, seq_len, label_len, pred_len):
    m = len(data_x) - seq_len - pred_len + 1
    if m <= 0:
        raise ValueError("split shorter than seq_len + pred_len")
    s = np.arange(m)[:, None]
    xi = s + np.arange(seq_len)[None, :]
    yi = s + seq_len - label_len + np.arange(label_len + pred_len)[None, :]
    return WindowSplit(
        seq_x=data_x[xi].astype(np.float32),
        seq_y=data_y[yi].astype(np.float32),
        seq_x_mark=marks[xi].astype(np.float32),
        seq_y_mark=marks[yi].astype(np.float32),
    )


def _select_features(df: Table, features: str, target: str) -> np.ndarray:
    """'M' / 'MS': every column after the first (the date); else the
    target alone.  Column-major, as pandas' ``.values`` lays a frame out,
    so that the scaler's float32 sums round as the JAX package's do."""
    names = list(df)[1:] if features in ("M", "MS") else [target]
    return np.asfortranarray(numeric_matrix(df, names), np.float32)


def _load_df(data_path: str, root_path: Optional[str]) -> Table:
    path = None
    if root_path is not None:
        path = os.path.join(root_path, data_path)
        if not os.path.exists(path):
            path = None
    if path is None:
        path = locate(data_path)
    if path is None:
        raise FileNotFoundError(f"{data_path} not found; set FETODE_DATA_DIR")
    return read_csv(path)


def _build(df_raw, borders, flag, seq_len, label_len, pred_len, features,
           target, scale, timeenc, freq):
    i = {"train": 0, "val": 1, "test": 2}[flag]
    b1s = [borders[0][0], borders[0][1] - seq_len, borders[0][2] - seq_len]
    b2s = borders[1]
    b1, b2 = b1s[i], b2s[i]

    data = _select_features(df_raw, features, target)
    scaler = None
    if scale:
        scaler = standardize_fit(data[b1s[0]:b2s[0]])
        data = scaler.apply(data)
    marks = time_features(df_raw["date"][b1:b2], timeenc=timeenc, freq=freq)
    win = _windows(data[b1:b2], data[b1:b2], marks, seq_len, label_len,
                   pred_len)
    return win, scaler


def dataset_ett_hour(flag="train", size=None, features="S",
                     data_path="ETT/ETTh1.csv", target="OT", scale=True,
                     timeenc=0, freq="h", root_path=None):
    seq_len, label_len, pred_len = size or (24 * 4 * 4, 24 * 4, 24 * 4)
    df = _load_df(data_path, root_path)
    return _build(df, _ETT_HOUR_BORDERS, flag, seq_len, label_len, pred_len,
                  features, target, scale, timeenc, freq)


def dataset_ett_minute(flag="train", size=None, features="S",
                       data_path="ETT/ETTm1.csv", target="OT", scale=True,
                       timeenc=0, freq="t", root_path=None):
    seq_len, label_len, pred_len = size or (24 * 4 * 4, 24 * 4, 24 * 4)
    df = _load_df(data_path, root_path)
    return _build(df, _ETT_MIN_BORDERS, flag, seq_len, label_len, pred_len,
                  features, target, scale, timeenc, freq)


def dataset_custom(flag="train", size=None, features="S", data_path=None,
                   target="OT", scale=True, timeenc=0, freq="h",
                   root_path=None, df_raw=None, ratios=(0.7, 0.1)):
    """70/10/20 chronological ratio split over a CSV or a table."""
    seq_len, label_len, pred_len = size or (24 * 4 * 4, 24 * 4, 24 * 4)
    df = _load_df(data_path, root_path) if df_raw is None else df_raw
    n = len(df["date"])
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    borders = ([0, n_train, n_train + n_val],
               [n_train, n_train + n_val, n])
    return _build(df, borders, flag, seq_len, label_len, pred_len, features,
                  target, scale, timeenc, freq)


# pandas offset aliases of a fixed length, in nanoseconds
_FIXED = {"ns": 1, "us": 10 ** 3, "ms": 10 ** 6, "s": 10 ** 9,
          "min": 60 * 10 ** 9, "h": 3600 * 10 ** 9, "d": 86400 * 10 ** 9}


def future_dates(last: np.datetime64, periods: int, freq: str) -> np.ndarray:
    """``pandas.date_range(last, periods=periods, freq=...)[1:]`` as the
    JAX package calls it: ``freq="t"`` means 15 minutes, any other string
    is lower-cased.  Fixed steps (``[n]ns|us|ms|s|min|h|d``) and the
    anchored weekly (``w``, Sundays) and business-day (``b``) ranges,
    which start at the first anchor on or after ``last``."""
    key = "15min" if freq == "t" else freq.lower()
    last = np.datetime64(last, "ns")
    m = re.fullmatch(r"(\d*)(ns|us|ms|s|min|h|d|w|b)", key)
    if m is None:
        raise ValueError(f"freq {freq!r}: the port's date ranges take "
                         f"[n]ns|us|ms|s|min|h|d, 't' (15 min), 'w' or 'b'")
    n, unit = int(m.group(1) or 1), m.group(2)
    if unit in _FIXED:
        step = np.timedelta64(n * _FIXED[unit], "ns")
        return last + step * np.arange(1, periods)
    day = np.timedelta64(1, "D")
    if unit == "w":                     # W-SUN: Sundays from last on
        weekday = int((last.astype("datetime64[D]").astype(np.int64) + 3) % 7)
        first = last + ((6 - weekday) % 7) * day
        return first + 7 * n * day * np.arange(1, periods)

    def business(t):
        return (t.astype("datetime64[D]").astype(np.int64) + 3) % 7 < 5

    t = last                            # business days from last on
    while not business(t):
        t = t + day
    out = []
    for _ in range(periods - 1):
        for _ in range(n):
            t = t + day
            while not business(t):
                t = t + day
        out.append(t)
    return np.asarray(out, "datetime64[ns]")


def dataset_pred(size=None, features="S", data_path="ETT/ETTh1.csv",
                 target="OT", scale=True, timeenc=0, freq="h",
                 root_path=None, df_raw=None):
    """Single inference window at the tail of the series (Dataset_Pred):
    returns (seq_x (1, L, F), seq_x_mark, future marks for pred_len,
    scaler)."""
    seq_len, label_len, pred_len = size or (24 * 4 * 4, 24 * 4, 24 * 4)
    df = df_raw if df_raw is not None else _load_df(data_path, root_path)
    data = _select_features(df, features, target)
    scaler = None
    if scale:
        scaler = standardize_fit(data)
        data = scaler.apply(data)

    stamps = to_datetime(df["date"])
    future = future_dates(stamps[-1], pred_len + 1, freq)
    marks = time_features(np.concatenate([stamps[-seq_len:], future]),
                          timeenc=timeenc, freq=freq)
    seq_x = data[-seq_len:][None]
    seq_x_mark = marks[:seq_len][None]
    seq_y_mark = marks[seq_len - label_len:][None]
    return seq_x, seq_x_mark, seq_y_mark, scaler
