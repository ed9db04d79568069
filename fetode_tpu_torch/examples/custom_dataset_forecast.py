"""Your own time series through the forecast driver (the port's
counterpart of ``examples/04_custom_dataset_forecast.py``).

``train/forecast_driver.py: train_point_forecaster(spec, X, y, run)``
takes any numeric feature matrix X (n, F) and target series y (n,):
chronological split, train-only standardisation, sliding windows, the
best-validation snapshot and the test MSE all come from the driver.  A
CSV is read by the port's own reader (``data/columns.py``; its numeric
columns, the last one the target); without one, the example's
three-feature series is synthesised.  On the card the latent solve is
the trajectory kernel pair (B.7).

Run:  python -m fetode_tpu_torch.examples.custom_dataset_forecast
      [my_data.csv] [--device cpu] [--epochs N]

The last line is ``final de-standardised forecast: [...]``.
"""

from __future__ import annotations

import argparse

import numpy as np

from fetode_tpu_torch.data.columns import is_numeric, numeric_matrix, read_csv
from fetode_tpu_torch.models.forecasting import LatentODEForecasterSpec
from fetode_tpu_torch.train.forecast_driver import (
    ForecastRun,
    train_point_forecaster,
)


def series(csv_path=None):
    """(X (n, F) float32, y (n,)): the CSV's numeric columns, the last one
    the target, or the synthetic three-feature series."""
    if csv_path:
        table = read_csv(csv_path)
        X = numeric_matrix(table, [k for k, v in table.items()
                                   if is_numeric(v)]).astype(np.float32)
        return X, X[:, -1]
    print("no CSV given; synthesising a 3-feature series")
    t = np.arange(600, dtype=np.float32)
    rng = np.random.default_rng(0)
    X = np.stack([np.sin(2 * np.pi * t / p) + 0.05 * rng.standard_normal(
        len(t)) for p in (24.0, 48.0, 96.0)], axis=1).astype(np.float32)
    return X, X @ np.asarray([0.5, 0.3, 0.2], np.float32)


def main(argv=None):
    """Train and report; returns the driver's history."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csv", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args(argv)
    X, y = series(args.csv)
    run = ForecastRun(context_len=24, pred_len=4, batch_size=32,
                      epochs=args.epochs, lr=1e-3, log_every=1,
                      device=args.device)
    spec = LatentODEForecasterSpec(num_features=X.shape[1],
                                   context_len=run.context_len,
                                   pred_len=run.pred_len, latent_dim=16)
    _, hist = train_point_forecaster(spec, X, y, run)
    print(f"best-val test MSE (standardised): {hist['test_mse']:.4f}")
    print(f"final de-standardised forecast: {hist['final_forecast']}")
    assert np.isfinite(hist["test_mse"])
    return hist


if __name__ == "__main__":
    main()
