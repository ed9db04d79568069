"""Training and evaluation plots (counterpart of
``fetode_tpu/diag/plots.py``): loss curves, trajectories, forecasts and
the model comparison chart, drawn with matplotlib's Agg backend.

matplotlib is imported inside the functions, never at import: a machine
without it runs everything but ``--plots``, which raises ``ImportError``
naming matplotlib.  Inputs may be numpy arrays, lists or tensors on any
device.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting (--plots) needs matplotlib, which is "
                          "not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, float)


def _figure_path(out_path: str) -> str:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    return out_path


def plot_trajectory(ts, truth, pred, out_path: str, *, train_cut: float = None,
                    labels=("x", "y"), ylim=(0, 8)):
    """Truth against predicted state trajectories (the predprey plot)."""
    plt = _plt()
    ts, truth, pred = _np(ts), _np(truth), _np(pred)
    fig, ax = plt.subplots()
    colors = ["g", "b", "r", "m"]
    for d in range(truth.shape[1]):
        c, name = colors[d % len(colors)], labels[d % len(labels)]
        ax.plot(ts, truth[:, d], color=c, label=f"{name}_data")
        ax.plot(ts, pred[:, d], color=c, linestyle="dashed",
                label=f"{name}_pred")
    if train_cut is not None:
        ax.vlines(train_cut, *ylim)
    ax.set_ylim(ylim)
    ax.set_xlabel("time")
    ax.set_ylabel("state")
    ax.legend()
    fig.savefig(_figure_path(out_path), dpi=150)
    plt.close(fig)
    return out_path


def plot_losses(history: Dict[str, Sequence[float]], out_path: str,
                *, logy: bool = True):
    """Loss curves (semilogy unless ``logy`` is False) of a history dict of
    lists; entries that are not lists of numbers are skipped."""
    plt = _plt()
    fig, ax = plt.subplots()
    for name, values in history.items():
        if isinstance(values, (list, tuple, np.ndarray)) and len(values) and \
                np.isscalar(np.asarray(values).flat[0]):
            (ax.semilogy if logy else ax.plot)(_np(values), label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(_figure_path(out_path), dpi=150)
    plt.close(fig)
    return out_path


def plot_forecast(history_y, forecast, out_path: str, *,
                  context_tail: int = 200):
    """The series' tail and the forecast after it."""
    plt = _plt()
    hist = _np(history_y)[-context_tail:]
    fc = _np(forecast)
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(np.arange(len(hist)), hist, label="history")
    ax.plot(np.arange(len(hist), len(hist) + len(fc)), fc, label="forecast",
            color="r")
    ax.legend()
    fig.tight_layout()
    fig.savefig(_figure_path(out_path), dpi=150)
    plt.close(fig)
    return out_path


def plot_model_comparison(results: Dict[str, Sequence[float]], out_path: str,
                          ylabel: str = "test accuracy"):
    """One curve per model (the ECG comparison chart)."""
    plt = _plt()
    fig, ax = plt.subplots()
    for name, curve in results.items():
        ax.plot(_np(curve), label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.savefig(_figure_path(out_path), dpi=150)
    plt.close(fig)
    return out_path
