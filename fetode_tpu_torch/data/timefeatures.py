"""Calendar time features for forecasting conditioning (counterpart of
``fetode_tpu/data/timefeatures.py``).

``timeenc=0`` gives raw calendar integers per frequency, ``timeenc=1``
features scaled to [-0.5, 0.5] from the frequency string, as the JAX
package computes them from a pandas ``DatetimeIndex``; here the calendar
fields come from ``datetime64`` arithmetic (the week is the ISO week,
pandas' ``isocalendar().week``).
"""

from __future__ import annotations

import numpy as np

from fetode_tpu_torch.data.columns import to_datetime


def _calendar(dates: np.ndarray) -> dict:
    """The calendar fields of ``datetime64`` dates, as integer arrays."""
    day0 = dates.astype("datetime64[D]")
    year0 = dates.astype("datetime64[Y]")
    month0 = dates.astype("datetime64[M]")
    weekday = (day0.astype(np.int64) + 3) % 7          # 1970-01-01: Thursday
    # ISO week: the week of the Thursday of the date's Monday-first week
    thursday = day0 + (3 - weekday).astype("timedelta64[D]")
    iso_year0 = thursday.astype("datetime64[Y]").astype("datetime64[D]")
    return {
        "second": (dates.astype("datetime64[s]")
                   - dates.astype("datetime64[m]")).astype(np.int64),
        "minute": (dates.astype("datetime64[m]")
                   - dates.astype("datetime64[h]")).astype(np.int64),
        "hour": (dates.astype("datetime64[h]") - day0).astype(np.int64),
        "weekday": weekday,
        "day": (day0 - month0.astype("datetime64[D]")).astype(np.int64) + 1,
        "dayofyear": (day0 - year0.astype("datetime64[D]")).astype(np.int64)
        + 1,
        "month": (month0 - year0.astype("datetime64[M]")).astype(np.int64)
        + 1,
        "week": (thursday - iso_year0).astype(np.int64) // 7 + 1,
    }


_SCALED = {
    "second": lambda c: c["second"] / 59.0 - 0.5,
    "minute": lambda c: c["minute"] / 59.0 - 0.5,
    "hour": lambda c: c["hour"] / 23.0 - 0.5,
    "dayofweek": lambda c: c["weekday"] / 6.0 - 0.5,
    "day": lambda c: (c["day"] - 1) / 30.0 - 0.5,
    "dayofyear": lambda c: (c["dayofyear"] - 1) / 365.0 - 0.5,
    "month": lambda c: (c["month"] - 1) / 11.0 - 0.5,
    "weekofyear": lambda c: (c["week"] - 1) / 52.0 - 0.5,
}

# features per frequency granularity (coarse -> fine), the JAX package's
_FREQ_FEATURES = {
    "y": [],
    "m": ["month"],
    "w": ["day", "weekofyear"],
    "d": ["dayofweek", "day", "dayofyear"],
    "b": ["dayofweek", "day", "dayofyear"],
    "h": ["hour", "dayofweek", "day", "dayofyear"],
    "t": ["minute", "hour", "dayofweek", "day", "dayofyear"],
    "s": ["second", "minute", "hour", "dayofweek", "day", "dayofyear"],
}

_RAW = {
    "month": lambda c: c["month"],
    "day": lambda c: c["day"],
    "weekday": lambda c: c["weekday"],
    "hour": lambda c: c["hour"],
    "minute15": lambda c: c["minute"] // 15,
}

_RAW_BY_FREQ = {
    "h": ["month", "day", "weekday", "hour"],
    "t": ["month", "day", "weekday", "hour", "minute15"],
}


def time_features(dates, timeenc: int = 0, freq: str = "h") -> np.ndarray:
    """dates: ``datetime64`` values, ISO date strings, or a table (a dict
    of columns) with a ``date`` column.  Returns (N, F) float32 features."""
    if isinstance(dates, dict):
        dates = dates["date"]
    cal = _calendar(to_datetime(dates))
    key = freq.lower()[-1] if freq else "h"
    if timeenc == 0:
        cols = _RAW_BY_FREQ.get(key, _RAW_BY_FREQ["h"])
        return np.stack([np.asarray(_RAW[c](cal), np.float32) for c in cols],
                        axis=1)
    feats = _FREQ_FEATURES.get(key, _FREQ_FEATURES["h"])
    return np.stack([np.asarray(_SCALED[f](cal), np.float32) for f in feats],
                    axis=1)
