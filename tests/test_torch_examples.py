"""PyTorch port, the twins of ``examples/03_serving_bundle.py`` and
``examples/04_custom_dataset_forecast.py`` (``fetode_tpu_torch/examples/
serving_bundle.py``, ``custom_dataset_forecast.py``), run in-process on
the CPU and once each as ``python -m`` with the repo root on
``PYTHONPATH`` (the package is not installed).

* The serving bundle: 20 ECG series served through the bundle equal
  (bit for bit) a direct call of the exporting process's module on the
  same batch padded to its bucket, as the JAX example holds its served
  logits to its in-process jit.
* The forecast: the port's CSV reader gives the JAX example's pandas
  ``select_dtypes("number")`` matrix and target exactly (a CSV with a
  date column, integer and float columns); the synthetic series is the
  JAX example's; training on it gives a finite test MSE and a forecast of
  ``pred_len`` values.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fetode_tpu_torch.examples import custom_dataset_forecast as CDF
from fetode_tpu_torch.examples import serving_bundle as SB

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serving_bundle_serves_the_direct_calls(tmp_path):
    logits, direct, stats = SB.main([str(tmp_path / "bundle"), "--device",
                                     "cpu"])
    assert logits.shape == (20, 2) and torch.equal(logits, direct)
    assert stats["batch"] == 8 and stats["p50_ms"] > 0
    assert sorted(os.listdir(tmp_path / "bundle")) == ["meta.json",
                                                       "params.pt"]


def test_csv_reader_gives_the_pandas_matrix(tmp_path):
    rng = np.random.default_rng(0)
    n = 50
    path = tmp_path / "mine.csv"
    pd.DataFrame({
        "date": pd.date_range("2020-01-01", periods=n, freq="h").astype(str),
        "count": rng.integers(0, 9, n),
        "temp": rng.normal(size=n).round(4),
        "OT": rng.normal(size=n),
    }).to_csv(path, index=False)
    X, y = CDF.series(str(path))
    want = pd.read_csv(path).select_dtypes("number").to_numpy(np.float32)
    np.testing.assert_array_equal(X, want)
    np.testing.assert_array_equal(y, want[:, -1])


def test_synthetic_series_is_the_jax_examples():
    X, y = CDF.series()
    t = np.arange(600, dtype=np.float32)
    rng = np.random.default_rng(0)
    want = np.stack([np.sin(2 * np.pi * t / p) + 0.05 * rng.standard_normal(
        len(t)) for p in (24.0, 48.0, 96.0)], axis=1).astype(np.float32)
    np.testing.assert_array_equal(X, want)
    np.testing.assert_array_equal(y, want @ np.asarray([0.5, 0.3, 0.2],
                                                      np.float32))


def test_custom_dataset_forecast_trains():
    hist = CDF.main(["--device", "cpu", "--epochs", "2"])
    assert np.isfinite(hist["test_mse"]) and len(hist["train"]) == 2
    assert np.shape(hist["final_forecast"]) == (4,)
    assert np.isfinite(hist["final_forecast"]).all()


@pytest.mark.parametrize("module,args,last", [
    ("serving_bundle", [], "served = direct calls on the padded batch: OK"),
    ("custom_dataset_forecast", ["--epochs", "1"],
     "final de-standardised forecast:"),
])
def test_examples_run_as_modules(module, args, last, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"fetode_tpu_torch.examples.{module}",
         *([str(tmp_path / "b")] if module == "serving_bundle" else []),
         *args, "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1].startswith(last)
