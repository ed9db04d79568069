"""PyTorch port, ``diag/`` against the JAX package's (hysteresis sweeps,
metric logging, plots, profiling, the roofline row) and ``--plots`` on
every CLI workload.

* ``sweep_loop`` / ``loop_openness`` on float64 parameters drawn by the
  JAX package: within 1e-10 of JAX's (both feed float32 fields and a
  float32 state through the plain basis).  Noisy sweeps draw from a
  ``torch.Generator``: deterministic for a seed, different from the
  clean one, a fresh draw at every field point.
* ``plot_loops`` writes the JAX function's file names; ``MetricLogger``
  the JAX logger's records (all fields but the wall clock).
* ``roofline_row``: the device-free fields equal JAX's for the same
  numbers; the bound classes at the H100's peaks; ``unknown`` on the CPU.
* ``--plots``: ``predprey``, ``ecg`` (``fepa_rnn`` with device noise and
  ``kanfet_mlp_node``), ``ett`` and ``symbolic`` write the PNG names of
  the JAX CLI's run (the ``symbolic`` run of the JAX CLI itself, the
  others from the JAX CLI's lists and the JAX package's layer configs);
  ``timemmd``, ``cond_diffusion`` and ``mnist`` accept the flag and draw
  nothing, as the JAX CLI does.
"""

import itertools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.diag import hysteresis as JH
from fetode_tpu.diag import logging as JLOG
from fetode_tpu.diag import roofline as JR
from fetode_tpu.ops import ferro as JO
from fetode_tpu_torch import cli
from fetode_tpu_torch.diag import hysteresis as TH
from fetode_tpu_torch.diag import logging as TLOG
from fetode_tpu_torch.diag import plots as TPL
from fetode_tpu_torch.diag import profiling as TPR
from fetode_tpu_torch.diag import roofline as TR
from fetode_tpu_torch.ops import ferro as TO

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ferro(cfg, seed=0):
    jp = JO.ferro_init(jax.random.PRNGKey(seed), cfg, jnp.float64)
    tp = TO.ferro_init(torch.Generator().manual_seed(0),
                       TO.FerroConfig(*cfg), dtype=torch.float64)
    tp.load_state_dict({k: torch.tensor(np.asarray(getattr(jp, k)))
                        for k in tp.state_dict()})
    return jp, tp, TO.FerroConfig(*cfg)


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".png"))


# ------------------------------------------------------------ hysteresis


def test_sweep_loop_matches_jax():
    jp, tp, cfg = _ferro(JO.FerroConfig(2, 3, 4, noise_std=0.3))
    wf, wr = JH.sweep_loop(jp, JO.FerroConfig(2, 3, 4, noise_std=0.3),
                           n_points=21)
    gf, gr = TH.sweep_loop(tp, cfg, n_points=21)
    np.testing.assert_array_equal(gf, wf)
    assert gr.shape == (42, 2, 3, 4)
    np.testing.assert_allclose(gr, wr, rtol=1e-10, atol=1e-10)


def test_loop_openness_matches_jax():
    jp, tp, cfg = _ferro(JO.FerroConfig(1, 2, 3), seed=1)
    want = JH.loop_openness(jp, JO.FerroConfig(1, 2, 3), n_points=31)
    got = TH.loop_openness(tp, cfg, n_points=31)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert np.all(got > 0)


def test_noisy_sweep_draws_from_the_generator():
    _, tp, cfg = _ferro(JO.FerroConfig(1, 2, 3, noise_std=0.3), seed=2)
    _, clean = TH.sweep_loop(tp, cfg, n_points=15)
    _, noisy = TH.sweep_loop(tp, cfg, n_points=15,
                             generator=torch.Generator().manual_seed(7))
    _, again = TH.sweep_loop(tp, cfg, n_points=15,
                             generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(noisy, again)
    d = noisy - clean
    assert np.abs(d).max() > 0.01 and not np.allclose(d[0], d[1])
    _, quiet = TH.sweep_loop(tp, cfg._replace(noise_std=0.0), n_points=15,
                             generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(quiet, clean)


def test_plot_loops_names_match_jax(tmp_path):
    jp, tp, cfg = _ferro(JO.FerroConfig(2, 2, 2), seed=3)
    want = JH.plot_loops(jp, JO.FerroConfig(2, 2, 2), str(tmp_path / "jax"),
                         max_panels=5, n_points=11, prefix="fc1")
    got = TH.plot_loops(tp, cfg, str(tmp_path / "port"), max_panels=5,
                        n_points=11, prefix="fc1")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert all(os.path.getsize(p) > 0 for p in got)


# ------------------------------------------------------- logging, plots


def test_metric_logger_matches_jax(tmp_path, capsys):
    logs = [TLOG.MetricLogger(str(tmp_path / "t" / "m.jsonl")),
            JLOG.MetricLogger(str(tmp_path / "j" / "m.jsonl"))]
    for log, scalar in zip(logs, (torch.tensor(0.7), jnp.asarray(0.7))):
        log.log(0, loss=1.5, acc=0.5, test=None)
        log.log(1, loss=scalar, note="x")
    got, want = (log.read() for log in logs)
    for g, w in zip(got, want):
        assert g.pop("wall") >= 0 and w.pop("wall") >= 0
        assert g.keys() == w.keys()
        assert g == pytest.approx(w)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[2] and out[1].split(" | ")[0] == "step 1"


def test_plots_write_pngs(tmp_path):
    ts = torch.linspace(0.0, 1.0, 9)
    traj = torch.stack([torch.sin(ts), torch.cos(ts)], dim=1)
    paths = [
        TPL.plot_trajectory(ts, traj, traj + 0.1, str(tmp_path / "a" /
                                                      "t.png"), train_cut=0.5),
        TPL.plot_losses({"train": [1.0, 0.5], "test": [], "note": "x"},
                        str(tmp_path / "l.png")),
        TPL.plot_forecast(np.arange(300.0), torch.ones(4),
                          str(tmp_path / "f.png")),
        TPL.plot_model_comparison({"a": [0.5, 0.6], "b": [0.4, 0.7]},
                                  str(tmp_path / "c.png")),
    ]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_plots_name_matplotlib_where_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        TPL.plot_losses({"loss": [1.0]}, str(tmp_path / "l.png"))


# ------------------------------------------------------------ profiling


def test_profiling_on_the_cpu(tmp_path):
    x = torch.randn(32, 32)
    tree = {"a": x, "b": [x, torch.nn.Linear(2, 2)]}
    assert TPR.sync(tree) is tree
    t = TPR.time_fn(torch.matmul, x, x, warmup=1, iters=5)
    assert 0.0 < t < 1.0
    with TPR.trace(str(tmp_path / "tr")):
        with TPR.annotate("step"):
            torch.matmul(x, x)
    with open(tmp_path / "tr" / "trace.json") as fh:
        assert "step" in fh.read()


# ------------------------------------------------------------- roofline


def test_roofline_matches_jax_and_classifies_at_h100_peaks():
    a = torch.ones((64, 64))
    c = TR.flop_cost(torch.matmul, a, a)
    assert c["flops"] == 2 * 64 ** 3 and c["bytes"] == 3 * 64 * 64 * 4
    for args in ((1e9, 1e3, 150_000), (1e3, 1e9, 500), (1e6, 1e6, 10)):
        got, want = TR.roofline_row(*args), JR.roofline_row(*args)
        for key in ("flops_per_unit", "hbm_bytes_per_unit",
                    "achieved_gflops", "achieved_gbps",
                    "arithmetic_intensity_flops_per_byte"):
            assert got[key] == want[key]
        assert got["bound"].startswith("unknown")
        assert got["flop_source"] == TR.FLOP_SOURCE
    peaks = TR.device_peaks(H100)
    assert peaks["peak_flops"] == 67e12 and peaks["peak_hbm_Bps"] == 3.35e12
    assert round(peaks["peak_sfu"] / 1e12, 2) == 4.18
    r = TR.roofline_row(1e9, 1e3, 60_000, device=H100)    # 60 TFLOP/s
    assert r["bound"] == "compute" and r["device"] == H100
    r = TR.roofline_row(1e3, 1e9, 3_000, device=H100)     # 3 TB/s
    assert r["bound"] == "bandwidth" and r["pct_peak_hbm"] > 50
    assert TR.roofline_row(1e6, 1e6, 10, device=H100)["bound"] \
        .startswith("latency")
    assert TR.device_peaks("cpu") is None
    assert TR.device_peaks("NVIDIA H100 PCIe") is None


# ------------------------------------------------------------- --plots


SMALL_ECG = ["--device", "cpu", "--latent_dim", "8", "--num_basis", "3",
             "--epochs", "1"]


def _loop_names(layers, max_panels=6):
    """The panels the JAX CLI's ``plot_loops`` writes for each
    ``(prefix, FerroConfig)``: the first ``max_panels`` (i, o, k)."""
    names = []
    for prefix, c in layers:
        ids = itertools.islice(itertools.product(
            range(c.in_dim), range(c.out_dim), range(c.num_basis)), max_panels)
        names += [os.path.join("hysteresis", f"{prefix}_i{i}_o{o}_k{k}.png")
                  for i, o, k in ids]
    return names


def test_cli_predprey_plots(tmp_path):
    cli.main(["predprey", "--device", "cpu", "--epochs", "2",
              "--epochs_per_call", "1", "--plots", "--out-dir",
              str(tmp_path)])
    assert _pngs(tmp_path) == ["loss.png", "trajectory.png"]
    with open(tmp_path / "metrics.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(set(r) == {"step", "wall", "train", "test"} for r in rows)


@pytest.mark.parametrize("model", ["fepa_rnn", "kanfet_mlp_node"])
def test_cli_ecg_plots(model, tmp_path):
    from fetode_tpu.models import ecg as JE
    from fetode_tpu.nn.rnn import FerroKANRNNConfig

    cli.main(["ecg", *SMALL_ECG, "--model", model, "--noise_std", "0.2",
              "--plots", "--out-dir", str(tmp_path)])
    if model == "fepa_rnn":
        r = FerroKANRNNConfig(hidden_size=8, num_basis=3, noise_std=0.2)
        layers = [("cell_input", r.cell.input_cfg),
                  ("cell_hidden", r.cell.hidden_cfg), ("head", r.head_cfg)]
    else:
        s = JE.KanFetMLPNODESpec(T=96, latent_dim=8, num_basis=3,
                                 noise_std=0.2)
        layers = [("fc1", s.fc1_cfg), ("fc2", s.fc2_cfg)]
    noisy = [(f"{p}_noisy", c) for p, c in layers]
    assert _pngs(tmp_path) == sorted(["loss.png"] + _loop_names(layers)
                                     + _loop_names(noisy))


def test_cli_ett_plots(tmp_path):
    cli.main(["ett", "--device", "cpu", "--epochs", "1", "--latent_dim", "8",
              "--context_len", "12", "--pred_len", "4", "--plots",
              "--out-dir", str(tmp_path)])
    assert _pngs(tmp_path) == ["forecast.png", "loss.png"]


def test_cli_symbolic_plots_match_the_jax_run(tmp_path):
    from fetode_tpu import cli as jcli

    jcli.main(["symbolic", "--epochs", "3", "--plots", "--out-dir",
               str(tmp_path / "jax")])
    cli.main(["symbolic", "--device", "cpu", "--epochs", "3", "--plots",
              "--out-dir", str(tmp_path / "port")])
    assert _pngs(tmp_path / "port") == _pngs(tmp_path / "jax")
    assert len(_pngs(tmp_path / "port")) == 13


@pytest.mark.parametrize("argv", [
    ["timemmd", "--context_len", "10", "--pred_len", "3", "--epochs", "1",
     "--batch_size", "32"],
    ["cond_diffusion", "--denoiser", "mlp", "--seq_len", "12", "--pred_len",
     "4", "--diff_t", "4", "--eval_samples", "2", "--epochs", "1",
     "--batch_size", "512"],
    ["mnist", "--epochs", "1", "--kuramoto_steps", "2", "--batch_size", "64"],
], ids=["timemmd", "cond_diffusion", "mnist"])
def test_cli_plots_accepted_and_nothing_drawn(argv, tmp_path):
    result = cli.main(argv + ["--device", "cpu", "--plots", "--out-dir",
                              str(tmp_path)])
    assert result and _pngs(tmp_path) == []
