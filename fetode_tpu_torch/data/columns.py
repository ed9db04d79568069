"""Column tables: the few pandas operations the data layer needs, in
numpy, so that the port needs no pandas.

A table is a ``dict`` of equal-length numpy arrays, in column order.
Numeric columns are float64 (NaN where a cell is missing), dates
``datetime64[ns]`` (NaT where missing), other columns object arrays of
``str`` (None where missing).  ``read_csv`` reads a CSV as pandas'
``read_csv`` types it: a column is numeric when every non-missing cell
reads as a number, and pandas' default missing-value strings are
missing.  ``to_datetime`` takes ISO dates (``2016-07-01``, ``2016-07-01
00:15:00``, ``/`` or ``-`` between the date's fields, as the ETT and
Time-MMD CSVs write them); what it cannot read becomes NaT, as under
pandas' ``errors="coerce"``.  ``sort_order`` is pandas'
``sort_values`` order of one column: numpy's default argsort of the
present values (not a stable sort), the missing ones last in their
order.
"""

from __future__ import annotations

import csv
from typing import Dict, Sequence

import numpy as np

Table = Dict[str, np.ndarray]

# pandas' default missing-value strings (``pandas.read_csv``'s na_values)
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _number(cell: str):
    """The float a CSV cell reads as, or None when it is not a number."""
    if "_" in cell:
        return None
    try:
        return float(cell)
    except ValueError:
        return None


def read_csv(path: str) -> Table:
    """The CSV at ``path`` (a header row, then one row a record) as a
    table, its columns typed as ``pandas.read_csv`` types them (numeric
    or text; dates stay text until ``to_datetime``)."""
    with open(path, newline="", encoding="utf-8") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        raise ValueError(f"{path}: no header row")
    header, body = rows[0], rows[1:]
    table: Table = {}
    for j, name in enumerate(header):
        cells = [r[j] if j < len(r) else "" for r in body]
        missing = [c in _NA_STRINGS for c in cells]
        nums = [None if m else _number(c) for c, m in zip(cells, missing)]
        if all(m or v is not None for m, v in zip(missing, nums)):
            table[name] = np.asarray(
                [np.nan if m else v for m, v in zip(missing, nums)],
                np.float64)
        else:
            table[name] = np.asarray(
                [None if m else c for c, m in zip(cells, missing)], object)
    return table


def isna(values: np.ndarray) -> np.ndarray:
    """Missing cells: NaN, NaT or None."""
    values = np.asarray(values)
    if np.issubdtype(values.dtype, np.datetime64):
        return np.isnat(values)
    if np.issubdtype(values.dtype, np.number):
        return np.isnan(values.astype(np.float64))
    return np.asarray([v is None or (isinstance(v, float) and v != v)
                       for v in values], bool)


def is_numeric(values: np.ndarray) -> bool:
    """Whether a column counts as numeric (pandas' ``select_dtypes(
    include=[np.number])``)."""
    dt = np.asarray(values).dtype
    return np.issubdtype(dt, np.number) and dt != np.bool_


def to_datetime(values) -> np.ndarray:
    """Dates as ``datetime64[ns]``; a cell that is no ISO date is NaT."""
    values = np.asarray(values)
    if np.issubdtype(values.dtype, np.datetime64):
        return values.astype("datetime64[ns]")
    out = np.full(len(values), np.datetime64("NaT"), "datetime64[ns]")
    for i, v in enumerate(values):
        if v is None or (isinstance(v, float) and v != v):
            continue
        text = str(v).strip().replace("/", "-")
        if text in _NA_STRINGS:
            continue
        try:
            out[i] = np.datetime64(text, "ns")
        except ValueError:
            pass
    return out


def sort_order(values: np.ndarray) -> np.ndarray:
    """The row order of pandas' ``sort_values`` on one column
    (``pandas.core.sorting.nargsort``): numpy's default argsort of the
    present values, the missing ones appended in their order."""
    values = np.asarray(values)
    miss = isna(values)
    idx = np.arange(len(values))
    present = values[~miss]
    if present.dtype == object:
        present = present.astype(str)
    return np.concatenate([idx[~miss][present.argsort(kind="quicksort")],
                           idx[miss]])


def take(table: Table, rows: np.ndarray) -> Table:
    """The table's rows ``rows``, in that order."""
    return {k: v[rows] for k, v in table.items()}


def fill_missing(values: np.ndarray) -> np.ndarray:
    """A numeric column forward-filled, then back-filled (pandas'
    ``ffill().bfill()``)."""
    v = np.asarray(values, np.float64)
    ok = ~np.isnan(v)
    if not ok.any():
        return v
    last = np.maximum.accumulate(np.where(ok, np.arange(len(v)), 0))
    v = v[last]
    first = int(np.argmax(ok))
    v[:first] = v[first]
    return v


def numeric_matrix(table: Table, names: Sequence[str]) -> np.ndarray:
    """The columns ``names`` side by side as an (N, F) float64 array."""
    return np.stack([np.asarray(table[n], np.float64) for n in names],
                    axis=1)
