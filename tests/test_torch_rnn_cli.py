"""PyTorch port, ``cli ecg`` with the recurrent models on the CPU, at a
small width (latent 8, 3 bases) on the synthetic ECG200 stand-in:
``--model fepa_rnn`` (clean and with device noise), ``digital_rnn``,
``node_rnn`` and ``all``, the JAX CLI's comparison set, which writes
``accuracy_table.json`` with the JAX CLI's labels.  Finite losses, an
accuracy curve of one point per epoch.
"""

import json

import numpy as np
import pytest
import torch

from fetode_tpu_torch import cli

SMALL = ["--device", "cpu", "--latent_dim", "8", "--num_basis", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread under the suite's workers
    (see tests/test_torch_ecg.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", ["fepa_rnn", "fepa_rnn_noisy",
                                   "digital_rnn", "node_rnn"])
def test_cli_ecg_rnn_on_cpu(model, tmp_path):
    epochs = 1 if model == "node_rnn" else 2    # node_rnn: 96 rk4 steps
    argv = ["ecg", *SMALL, "--epochs", str(epochs), "--model",
            model.replace("_noisy", ""), "--out-dir", str(tmp_path)]
    if model.endswith("noisy"):
        argv += ["--noise_std", "0.2"]
    result = cli.main(argv)
    assert len(result["test_acc_curve"]) == epochs
    assert np.isfinite(result["loss_curve"]).all()
    assert 0.0 <= result["best_test_acc"] <= 1.0


def test_cli_ecg_all_on_cpu(tmp_path):
    result = cli.main(["ecg", *SMALL, "--epochs", "1", "--model", "all",
                       "--out-dir", str(tmp_path)])
    labels = {"digital_rnn", "fepa_rnn", "kanfet_node", "kanfet_mlp_node",
              "kanfet_mlp_node_noisy"}
    assert set(result["best_test_acc"]) == labels
    with open(tmp_path / "accuracy_table.json") as f:
        assert json.load(f) == result["best_test_acc"]
    for label in labels:
        assert (tmp_path / label).is_dir()
    assert all(0.0 <= a <= 1.0 for a in result["best_test_acc"].values())
