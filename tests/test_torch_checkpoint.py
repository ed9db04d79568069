"""PyTorch port, durable training (``train/checkpoint.py``) on the CPU:
the checkpoint manager (atomic saves, retention of 3, ``latest_step``
from the directory, a half-written file never read), ``BestTracker``,
``DurableLoop``, and kill-and-resume of the ECG, ETT ``point`` and
conditional-diffusion trainers at small widths, as
``tests/test_diag_ckpt_cli.py`` holds the JAX package's: a run killed
after a checkpoint (its log raises) and resumed continues the unbroken
run's curve bit for bit.  Then ``cli serve --ckpt_dir`` serving a
predprey training checkpoint's parameters.  The predprey driver's own
kill-and-resume is in ``tests/test_torch_predprey_driver.py``.
"""

import os

import numpy as np
import pytest
import torch

from fetode_tpu_torch import cli
from fetode_tpu_torch.config import make_config
from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
from fetode_tpu_torch.data.timeseries import synthetic_series
from fetode_tpu_torch.models import cond_diffusion as CD
from fetode_tpu_torch.models import ecg as M
from fetode_tpu_torch.models.forecasting import LatentODEForecasterSpec
from fetode_tpu_torch.models.predprey import PredPreyNODE, predict_batch
from fetode_tpu_torch.serve import load_servable
from fetode_tpu_torch.train import checkpoint as ck
from fetode_tpu_torch.train.cond_diffusion_driver import (
    CondDiffusionRun,
    train_conditional_diffusion,
)
from fetode_tpu_torch.train.ecg_driver import ECGRun, train_ecg_model
from fetode_tpu_torch.train.forecast_driver import (
    ForecastRun,
    train_point_forecaster,
)
from fetode_tpu_torch.train.loop import init_state
from fetode_tpu_torch.train.optim import make_optimizer


@pytest.fixture(autouse=True)
def _one_thread():
    # The eager CPU paths under the suite's xdist workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(v):
    return {"w": torch.full((3,), float(v)), "step": v, "nested": [v, {"a": v}]}


def test_manager_saves_restores_and_keeps_three(tmp_path):
    m = ck.CheckpointManager(str(tmp_path / "c"), max_to_keep=3)
    assert m.latest_step() is None
    with pytest.raises(FileNotFoundError):
        m.restore()
    for step in (2, 4, 6, 8, 10):
        assert m.save(step, _payload(step))
    assert m.all_steps() == [6, 8, 10] and m.latest_step() == 10
    assert sorted(os.listdir(m.directory)) == ["ckpt_10.pt", "ckpt_6.pt",
                                               "ckpt_8.pt"]
    got = m.restore()
    assert torch.equal(got["w"], torch.full((3,), 10.0))
    assert got["step"] == 10 and got["nested"] == [10, {"a": 10}]
    assert m.restore(6)["step"] == 6
    # a new manager reads the steps from the directory
    assert ck.CheckpointManager(m.directory).latest_step() == 10


def test_half_written_file_is_not_read(tmp_path, monkeypatch):
    m = ck.CheckpointManager(str(tmp_path / "c"))
    m.save(1, _payload(1))
    # a save killed mid-write: the partial bytes never reach a
    # checkpoint's name, and the temporary file goes
    real = torch.save

    def dies(obj, f):
        f.write(b"\x80\x02partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(ck.torch, "save", dies)
    with pytest.raises(KeyboardInterrupt):
        m.save(2, _payload(2))
    monkeypatch.setattr(ck.torch, "save", real)
    assert os.listdir(m.directory) == ["ckpt_1.pt"]
    # a temporary file a killed process left behind is ignored
    with open(os.path.join(m.directory, ".ckpt_3.abc.tmp"), "wb") as f:
        f.write(b"\x80\x02partial")
    assert m.latest_step() == 1 and m.restore()["step"] == 1


def test_best_tracker_and_durable_loop(tmp_path):
    lin = torch.nn.Linear(3, 2)
    bt = ck.BestTracker("max")
    assert bt.update(0.5, lin) and not bt.update(0.4, lin)
    snap = bt.restore()
    with torch.no_grad():
        lin.weight.add_(1.0)
    assert not torch.equal(snap["weight"], lin.weight)
    assert torch.equal(bt.restore(lin).weight, snap["weight"])

    state = init_state(lin, make_optimizer(1e-2, params=lin.parameters()))
    state.opt.zero_grad()
    lin(torch.ones(4, 3)).sum().backward()
    state.opt.step()
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    dl = ck.DurableLoop(str(tmp_path / "d"), ckpt_every=2)
    assert not dl.save(1, state=state, best_crit=0.1, best_params=lin)
    assert dl.save(2, state=state, best_crit=0.1, best_params=lin, key=gen)
    want = torch.rand(3, generator=gen)
    lin2 = torch.nn.Linear(3, 2)
    state2 = init_state(lin2, make_optimizer(1e-2, params=lin2.parameters()))
    gen2 = torch.Generator().manual_seed(0)
    start, saved = ck.DurableLoop(str(tmp_path / "d"), 2, True).restore(
        state=state2, best_crit=np.inf, best_params=torch.nn.Linear(3, 2),
        key=gen2)
    assert start == 2 and saved["best_crit"] == 0.1 and state2.step == 1
    assert torch.equal(lin2.weight, lin.weight)
    assert torch.equal(torch.rand(3, generator=gen2), want)
    # without resume (or without a directory) nothing is restored or saved
    assert ck.DurableLoop(str(tmp_path / "d"), 2).restore(
        state=state2, best_crit=0, best_params=lin2) == (0, None)
    assert not ck.DurableLoop("", 2).save(2, state=state, best_crit=0,
                                          best_params=lin)


def _killer(after):
    calls = {"n": 0}

    def log(msg):
        calls["n"] += 1
        if calls["n"] >= after:
            raise KeyboardInterrupt
    return log


def _kill_and_resume(train, run_kw, ckpt_kw, after):
    """(unbroken history, resumed history, resume log lines)."""
    _, ref = train(dict(run_kw), None)
    with pytest.raises(KeyboardInterrupt):
        train(dict(run_kw, **ckpt_kw), _killer(after))
    logs = []
    _, res = train(dict(run_kw, **ckpt_kw, resume=True), logs.append)
    return ref, res, logs


def test_ecg_kill_and_resume(tmp_path):
    spec = M.KanFetNODESpec(T=24, latent_dim=8, num_basis=3, max_steps=16,
                            rtol=1e-2, atol=1e-3)
    x_tr, y_tr, x_te, y_te = synthetic_ecg200(seed=1, n_train=16, n_test=8,
                                              T=24)

    def train(kw, log):
        return train_ecg_model(
            lambda g: M.kanfet_node_init(g, spec),
            lambda p, x, g: M.kanfet_node_apply(p, spec, x),
            (x_tr, y_tr, x_te, y_te), ECGRun(**kw), log=log)

    ref, res, logs = _kill_and_resume(
        train, dict(epochs=4, batch_size=8, log_every=1, device="cpu"),
        dict(ckpt_dir=str(tmp_path / "ecg"), ckpt_every=2), after=3)
    assert any("[ckpt] resumed at epoch 2" in m for m in logs)
    for k in ("loss", "train_acc", "test_acc"):
        assert res[k] == ref[k][2:], k
    assert res["best_test_acc"] == ref["best_test_acc"]


def test_forecast_point_kill_and_resume(tmp_path):
    X, y = synthetic_series(n=300, n_features=3)
    spec = LatentODEForecasterSpec(num_features=X.shape[1], context_len=12,
                                   pred_len=4, latent_dim=8, enc_hidden=16,
                                   dyn_hidden=16, dec_hidden=16)

    def train(kw, log):
        return train_point_forecaster(spec, X, y, ForecastRun(**kw), log=log)

    ref, res, logs = _kill_and_resume(
        train, dict(context_len=12, pred_len=4, batch_size=32, epochs=4,
                    log_every=1, device="cpu", aot_cache="unused"),
        dict(ckpt_dir=str(tmp_path / "fc"), ckpt_every=2), after=4)
    assert any("[ckpt] resumed at epoch 2" in m for m in logs)
    assert any("aot_cache" in m for m in logs)
    assert res["train"] == ref["train"][2:] and res["val"] == ref["val"][2:]
    assert res["test_mse"] == ref["test_mse"]
    np.testing.assert_array_equal(res["final_forecast"],
                                  ref["final_forecast"])


def test_cond_diffusion_kill_and_resume(tmp_path):
    rng = np.random.default_rng(0)

    def windows(n):
        return (rng.normal(size=(n, 12, 3)).astype(np.float32),
                rng.normal(size=(n, 4, 3)).astype(np.float32))

    data = {"train": windows(32), "val": windows(16), "test": windows(16)}
    spec = CD.make_denoiser_spec("mlp", d_in=3, pred_len=4, seq_len=12,
                                 cond_dim=16, time_dim=16, hidden=32)

    def train(kw, log):
        return train_conditional_diffusion(spec, data,
                                           CondDiffusionRun(**kw), log=log)

    ref, res, logs = _kill_and_resume(
        train, dict(seq_len=12, pred_len=4, diff_T=8, epochs=6,
                    batch_size=16, log_every=1, device="cpu"),
        dict(ckpt_dir=str(tmp_path / "cd"), ckpt_every=2), after=3)
    assert any("[ckpt] resumed at epoch 2" in m for m in logs)
    assert res["train"] == ref["train"][2:] and res["val"] == ref["val"][2:]


def test_serve_predprey_from_checkpoint(tmp_path):
    """``serve --ckpt_dir`` serves the checkpoint's best parameters, not
    the source's fresh ones: the bundle's module holds them, and requests
    through it equal direct ``predict_batch`` calls with them."""
    ckdir = str(tmp_path / "pp")
    cli.main(["predprey", "--device", "cpu", "--epochs", "2",
              "--epochs_per_call", "1", "--rtol", "1e-3", "--atol", "1e-5",
              "--ckpt_dir", ckdir, "--ckpt_every", "1",
              "--out-dir", str(tmp_path / "train")])
    saved = ck.CheckpointManager(ckdir).restore()
    argv = ["serve", "--source", "predprey", "--device", "cpu", "--ckpt_dir",
            ckdir, "--buckets", "4", "--iters", "1", "--n_points", "8",
            "--horizon", "2.0", "--out-dir", str(tmp_path / "serve")]
    result = cli.main(argv)
    cfg = make_config("serve", cli._parse(argv)[1])
    fresh, fn, _ = cli.predprey_serving(cfg, torch.device("cpu"))
    sv = load_servable(result["bundle"], fn, fresh)
    for k, v in saved["best_params"].items():
        assert torch.equal(sv.params.state_dict()[k], v), k
    fresh2, _, _ = cli.predprey_serving(cfg, torch.device("cpu"))
    assert not all(torch.equal(fresh2.state_dict()[k], v)
                   for k, v in saved["best_params"].items())
    # a full bucket: no padding rows, so the eager solve sees the same
    # batch as the direct call
    x = torch.rand((4, 2), generator=torch.Generator().manual_seed(1)) + 0.5
    fresh2.load_state_dict(saved["best_params"])
    with torch.no_grad():
        want = predict_batch(fresh2, PredPreyNODE.kanfet(), x,
                             torch.linspace(0.0, 2.0, 8))
        assert torch.equal(sv.predict(x), want)
