"""PyTorch port, the forecasting slice against the JAX package: the data
helpers of ``data/timeseries.py``, the diffusion math, the point and
diffusion forecasters (``models/forecasting.py``) through the eager
solve, their losses and gradients, the parameter conversion, the
trainers, ``cli ett`` and ``cli serve --source ett|ddpm`` on the CPU, and
the refusals of what is not ported.

Small widths: 3 features (plus the target), context 12, pred_len 4,
latent 8, hidden 16, diff_T 20, eps-head hidden 16, B = 6; dopri5 at the
specs' rtol 1e-3 / atol 1e-4, max_steps 32; parameters from
``PRNGKey(0)``, inputs from a numpy seed.  Tolerances:
* forecasts and losses in float32, 1e-5: the eager solve at rtol 1e-3
  (the diffusion loss fed the JAX package's own ``t_idx`` and ``eps``);
* gradients in float64 against the JAX scan solve's autodiff (its step
  control cut from the graph, as the port's is), relative norm 1e-9: one
  algorithm on one step mesh (1e-6 for the diffusion loss, whose
  t-embedding both packages compute in float32);
* data helpers exact or 1e-6.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.data import timeseries as jts
from fetode_tpu.models import forecasting as JF
from fetode_tpu.nn.diffusion import eps_head_apply as j_eps_apply
from fetode_tpu.nn.diffusion import make_schedule as j_schedule
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import (
    forecast_grads_to_numpy,
    forecast_params_from_numpy,
    forecast_params_to_numpy,
)
from fetode_tpu_torch.data import timeseries as tts
from fetode_tpu_torch.models import forecasting as TF
from fetode_tpu_torch.nn import diffusion as TD
from fetode_tpu_torch.ops import ddpm as DD
from fetode_tpu_torch.train import forecast_driver as tdrv

SMALL = dict(num_features=4, context_len=12, pred_len=4, latent_dim=8,
             enc_hidden=16, dyn_hidden=16)
DIFF = dict(SMALL, diff_T=20, diff_hidden=16)
B = 6


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _zero_grids(tree):
    """``jax.grad`` differentiates a KAN's knot grid, which the port keeps
    as a buffer: zero those leaves."""
    if isinstance(tree, dict):
        return {k: (jax.tree_util.tree_map(np.zeros_like, v)
                    if k == "_buffers" else _zero_grids(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zero_grids(v) for v in tree]
    return tree


def _inputs(dtype=np.float32):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, SMALL["context_len"],
                             SMALL["num_features"])).astype(dtype)
    y = rng.standard_normal((B, SMALL["pred_len"])).astype(dtype)
    return x, y


def _point(dtype=torch.float32, **kw):
    jspec = JF.LatentODEForecasterSpec(dec_hidden=16, **SMALL, **kw)
    jp = JF.latent_ode_forecaster_init(jax.random.PRNGKey(0), jspec)
    tspec = TF.LatentODEForecasterSpec(dec_hidden=16, **SMALL, **kw)
    tp = TF.latent_ode_forecaster_init(torch.Generator().manual_seed(0),
                                       tspec, dtype=dtype)
    tp.load_state_dict(forecast_params_from_numpy(_np(jp, np.float64)))
    return jspec, jp, tspec, tp.to(dtype)


def _diffusion(encoder, dtype=torch.float32, **kw):
    jspec = JF.DiffusionForecasterSpec(encoder=encoder, **DIFF, **kw)
    jp = JF.diffusion_forecaster_init(jax.random.PRNGKey(0), jspec)
    tspec = TF.DiffusionForecasterSpec(encoder=encoder, **DIFF, **kw)
    tp = TF.diffusion_forecaster_init(torch.Generator().manual_seed(0),
                                      tspec, dtype=dtype)
    tp.load_state_dict(forecast_params_from_numpy(_np(jp, np.float64)))
    return jspec, jp, tspec, tp.to(dtype)


def _jax_loss_draws(key, T):
    """``t_idx`` and ``eps`` as ``diffusion_forecaster_loss`` draws them."""
    k_t, k_q = jax.random.split(key)
    t_idx = jax.random.randint(k_t, (B,), 0, T)
    eps = jax.random.normal(k_q, (B, SMALL["pred_len"]), jnp.float32)
    return np.array(t_idx), np.array(eps)


# ------------------------------------------------------------------ data


def test_windows_match_jax():
    X, y = tts.synthetic_series(n=100, n_features=2)
    jX, jy = jts.synthetic_series(n=100, n_features=2)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    xc, yf = tts.make_windows(X, y, context_len=10, pred_len=4)
    assert xc.shape == (87, 10, 3) and yf.shape == (87, 4)
    np.testing.assert_array_equal(yf[0], y[10:14])
    np.testing.assert_array_equal(xc[5], X[5:15])
    jxc, jyf = jts.make_windows(X, y, 10, 4)
    np.testing.assert_array_equal(xc, jxc)
    np.testing.assert_array_equal(yf, jyf)
    with pytest.raises(ValueError, match="shorter"):
        tts.make_windows(X[:5], y[:5], 10, 4)


def test_standardizer_and_split():
    X, _ = tts.synthetic_series(n=50)
    s = tts.standardize_fit(X)
    Z = s.apply(X)
    np.testing.assert_allclose(Z.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(s.invert(Z), X, atol=1e-4)
    js = jts.standardize_fit(X)
    np.testing.assert_allclose(s.sd, js.sd, rtol=1e-6)
    assert tts.split_time_series(100, 0.7, 0.1) == (
        slice(0, 70), slice(70, 80), slice(80, 100))
    run = tdrv.ForecastRun(context_len=12, pred_len=4)
    X, y = tts.synthetic_series(n=200, n_features=3)
    from fetode_tpu.train.forecast_driver import ForecastRun as JRun
    from fetode_tpu.train.forecast_driver import prepare_windows as j_prep
    got, _, sy = tdrv.prepare_windows(X, y, run)
    want, _, jsy = j_prep(X, y, JRun(context_len=12, pred_len=4))
    for k in ("train", "val", "test"):
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sy.mu, jsy.mu, rtol=1e-6)


def test_load_ett_csv_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    rows = ["date,HUFL,HULL,OT"] + [
        f"2016-07-01 {h:02d}:00:00,{a:.3f},{b:.3f},{c:.3f}"
        for h, (a, b, c) in enumerate(rng.standard_normal((10, 3)))]
    path = tmp_path / "ETTh1.csv"
    path.write_text("\n".join(rows) + "\n")
    X, y, cols = tts.load_ett_csv(str(path))
    jX, jy, _ = jts.load_ett_csv(str(path))
    assert cols == ["HUFL", "HULL", "OT"]
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    monkeypatch.setattr(tts, "locate", lambda relpath: None)
    with pytest.raises(FileNotFoundError, match="FETODE_DATA_DIR"):
        tts.load_ett_csv()


def test_window_batches_shapes():
    X, y = tts.synthetic_series(n=60, n_features=2)
    xc, yf = tts.make_windows(X, y, 8, 4)
    bx, by = tts.window_batches(xc, yf, 16, seed=3)
    assert bx.shape == (len(xc) // 16, 16, 8, 3) and by.shape[:2] == \
        bx.shape[:2]
    bx2, _ = tts.window_batches(xc, yf, 16, seed=3)
    np.testing.assert_array_equal(bx, bx2)


# ------------------------------------------------------------- diffusion


def test_p_sample_loop_recovers_simple_target():
    """With a perfect eps-model oracle for a zero target, sampling must
    contract toward zero."""
    sched = TD.make_schedule(T=50)

    def eps_model(y_t, t_idx, cond):
        c = sched.sqrt_one_minus_alphas_bar[t_idx][:, None]
        return y_t / torch.clamp(c, min=1e-3)

    y = TD.p_sample_loop(sched, eps_model, (8, 6), None,
                         torch.Generator().manual_seed(0))
    assert float(y.abs().mean()) < 0.3


# ---------------------------------------------------------- forecasters


def test_latent_ode_forecast_matches_jax():
    jspec, jp, tspec, tp = _point()
    x, _ = _inputs()
    want = JF.latent_ode_forecast(jp, jspec, jnp.asarray(x))
    with torch.no_grad():
        got = TF.latent_ode_forecast(tp, tspec, torch.from_numpy(x))
    assert got.shape == (B, SMALL["pred_len"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_point_gradients_match_jax_float64():
    jspec, jp, tspec, tp = _point(torch.float64, solver_mode="scan")
    x, y = _inputs(np.float64)
    p64 = _np(jp, np.float64)

    def loss(p):
        return jnp.mean((JF.latent_ode_forecast(p, jspec, jnp.asarray(x))
                         - y) ** 2)

    g = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, p64))
    out = TF.latent_ode_forecast(tp, tspec, torch.from_numpy(x))
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    assert _rel(_flat(forecast_grads_to_numpy(tp, np.float64)),
                _flat(_np(g, np.float64))) < 1e-9


# The kanrnn encoder at a small width: hidden 8, 3 logistic bases.
RNN = dict(rnn_hidden=8, num_basis=3)


@pytest.mark.parametrize("encoder", ["mlp", "kan", "kanrnn"])
def test_diffusion_loss_matches_jax(encoder):
    """float32: the epsilon loss on the JAX package's own draws; float64:
    its gradients (the mlp encoder) against ``jax.grad``."""
    jspec, jp, tspec, tp = _diffusion(encoder,
                                      **(RNN if encoder == "kanrnn" else {}))
    x, y = _inputs()
    key = jax.random.PRNGKey(4)
    t_idx, eps = _jax_loss_draws(key, DIFF["diff_T"])
    want = JF.diffusion_forecaster_loss(jp, jspec, j_schedule(DIFF["diff_T"]),
                                        jnp.asarray(x), jnp.asarray(y), key)
    with torch.no_grad():
        got = TF.diffusion_forecaster_loss(
            tp, tspec, TD.make_schedule(DIFF["diff_T"]), torch.from_numpy(x),
            torch.from_numpy(y), t_idx=torch.from_numpy(t_idx),
            eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        cond = TF._cond(tp, tspec, torch.from_numpy(x),
                        torch.arange(SMALL["pred_len"], dtype=torch.float32))
        samples = TF.diffusion_forecaster_sample(
            tp, tspec, TD.make_schedule(DIFF["diff_T"]), torch.from_numpy(x),
            torch.Generator().manual_seed(0), n_samples=2)
    assert cond.shape == (B, SMALL["pred_len"] * SMALL["latent_dim"])
    assert samples.shape == (2, B, SMALL["pred_len"])
    assert torch.isfinite(samples).all()


def test_diffusion_gradients_match_jax_float64():
    jspec, jp, tspec, tp = _diffusion("mlp", torch.float64,
                                      solver_mode="scan")
    x, y = _inputs(np.float64)
    key = jax.random.PRNGKey(4)
    t_idx, eps = _jax_loss_draws(key, DIFF["diff_T"])
    jsched = j_schedule(DIFF["diff_T"], dtype=jnp.float64)
    p64 = jax.tree_util.tree_map(jnp.asarray, _np(jp, np.float64))

    def loss(p):
        cond = JF._cond(p, jspec, jnp.asarray(x),
                        jnp.arange(SMALL["pred_len"], dtype=jnp.float64))
        y_t = (jsched.sqrt_alphas_bar[t_idx][:, None] * y
               + jsched.sqrt_one_minus_alphas_bar[t_idx][:, None] * eps)
        e = j_eps_apply(p["eps_head"], jspec.eps_cfg, y_t,
                        jnp.asarray(t_idx), cond)
        return jnp.mean((e - eps) ** 2)

    g = jax.grad(loss)(p64)
    TF.diffusion_forecaster_loss(
        tp, tspec, TD.make_schedule(DIFF["diff_T"], dtype=torch.float64),
        torch.from_numpy(x), torch.from_numpy(y),
        t_idx=torch.from_numpy(t_idx),
        eps=torch.from_numpy(eps.astype(np.float64))).backward()
    # Both packages compute the t-embedding in float32 (``sinusoidal_emb``)
    # and their float32 sin/cos differ by an ulp: 1e-6, not 1e-9.
    assert _rel(_flat(forecast_grads_to_numpy(tp, np.float64)),
                _flat(_zero_grids(_np(g, np.float64)))) < 1e-6


@pytest.mark.parametrize("kind", ["point", "mlp", "kan", "kanrnn"])
def test_convert_round_trip(kind):
    _, jp, _, tp = _point() if kind == "point" else _diffusion(
        kind, **(RNN if kind == "kanrnn" else {}))
    back = forecast_params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_np(jp))
    np.testing.assert_array_equal(_flat(back), _flat(_np(jp)))


def test_logistic_linear_matches_jax():
    jp = JF.logistic_linear_init(jax.random.PRNGKey(0), 5, 3, 4)
    tp = TF.logistic_linear_init(torch.Generator().manual_seed(0), 5, 3, 4)
    tp.load_state_dict({
        "basis.a": torch.from_numpy(np.array(jp["basis"]["a"])),
        "basis.b": torch.from_numpy(np.array(jp["basis"]["b"])),
        "w": torch.from_numpy(np.array(jp["w"])),
        "b": torch.from_numpy(np.array(jp["b"]))})
    x = np.random.default_rng(2).standard_normal((7, 5)).astype(np.float32)
    with torch.no_grad():
        got = TF.logistic_linear_apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        JF.logistic_linear_apply(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- trainers


def _series():
    return tts.synthetic_series(n=160, n_features=3)


def test_train_point_forecaster_two_epochs():
    X, y = _series()
    spec = TF.LatentODEForecasterSpec(num_features=4, context_len=12,
                                      pred_len=4, latent_dim=8,
                                      enc_hidden=16, dec_hidden=16,
                                      dyn_hidden=16)
    logs = []
    params, hist = tdrv.train_point_forecaster(
        spec, X, y, tdrv.ForecastRun(context_len=12, pred_len=4,
                                     batch_size=32, epochs=2, log_every=1,
                                     device="cpu"), log=logs.append)
    assert set(hist) == {"train", "val", "test_mse", "wall_seconds",
                         "final_forecast"}
    assert len(hist["train"]) == 2 and np.isfinite(hist["train"]).all()
    assert np.isfinite(hist["test_mse"])
    assert hist["final_forecast"].shape == (4,)
    assert [line.split("|")[0].strip() for line in logs[:2]] == [
        "epoch   0", "epoch   1"]
    assert isinstance(params, torch.nn.ModuleDict)


def test_train_diffusion_forecaster_one_sample():
    """``eval_samples=1``: the sampler returns (B, P) and the eval keeps
    the batch axis (the shape guard)."""
    X, y = _series()
    spec = TF.DiffusionForecasterSpec(num_features=4, context_len=12,
                                      pred_len=4, latent_dim=8,
                                      enc_hidden=16, dyn_hidden=16,
                                      diff_T=10, diff_hidden=16)
    _, hist = tdrv.train_diffusion_forecaster(
        spec, X, y, tdrv.ForecastRun(context_len=12, pred_len=4,
                                     batch_size=32, epochs=1,
                                     eval_samples=1, device="cpu"),
        log=None)
    assert np.isfinite(hist["train"]).all() and np.isfinite(hist["test_mse"])
    assert hist["final_forecast"].shape == (4,)


def test_chunked_mean_cuts_as_the_jax_package():
    calls = []

    def sum_fn(p, x, y):
        calls.append(len(x))
        return float(np.sum(x)), len(x)

    x = np.ones(600)
    assert tdrv._chunked_mean(sum_fn, None, x, x, chunk=256) == 1.0
    assert calls == [256, 256, 88]


# ------------------------------------------------------------------ CLI

_CLI_SMALL = ["--device", "cpu", "--epochs", "2", "--latent_dim", "8",
              "--context_len", "12", "--pred_len", "4", "--batch_size",
              "256"]


@pytest.mark.parametrize("model", ["point", "diffusion", "kan_diffusion",
                                   "kan_fet_diffusion"])
def test_cli_ett_on_cpu(model, tmp_path):
    argv = ["ett", "--model", model, *_CLI_SMALL, "--out-dir",
            str(tmp_path)]
    if model != "point":
        argv += ["--diff_t", "10", "--eval_samples", "2", "--epochs", "1"]
    result = cli.main(argv)
    assert np.isfinite(result["test_mse"]) and result["wall_seconds"] > 0
    assert np.isfinite(result["train_curve"]).all()
    assert (tmp_path / "result.json").exists()


@pytest.mark.parametrize("source", ["ett", "ddpm"])
def test_cli_serve_forecasters_on_cpu(source, tmp_path):
    """Requests through the bundle equal direct calls on the same padded
    batch (the padding rows share the latent solve's step control)."""
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.serve import load_servable

    argv = ["serve", "--source", source, "--device", "cpu", "--latent_dim",
            "8", "--context_len", "12", "--num_features", "3", "--diff_t",
            "10", "--n_samples", "3", "--iters", "2", "--buckets", "4,8",
            "--out-dir", str(tmp_path)]
    result = cli.main(argv)
    assert result["source"] == source
    assert [row["batch"] for row in result["bench"]] == [4, 8]
    cfg = make_config("serve", cli._parse(argv)[1])
    params, fn, _ = cli.SERVING[source](cfg, torch.device("cpu"))
    sv = load_servable(result["bundle"], fn, params)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 12, 3)).astype(np.float32))
    padded = torch.cat([x, x[-1:]])
    with torch.no_grad():
        got = sv.predict(x)
        assert got.shape == (3, 8)
        np.testing.assert_array_equal(got.numpy(),
                                      fn(sv.params, padded)[:3].numpy())
        np.testing.assert_array_equal(got.numpy(), sv.predict(x).numpy())


@pytest.mark.parametrize("n_samples", [1, 3])
def test_diffusion_sample_is_the_chain_on_the_encoded_condition(n_samples):
    """The forecaster's sampler is the whole-chain sampler (its plain
    version on the CPU) on the encoder's condition, with the same
    generator stream; one sample keeps (B, P)."""
    _, _, tspec, tp = _diffusion("mlp")
    x, _ = _inputs()
    sched = TD.make_schedule(DIFF["diff_T"])
    with torch.no_grad():
        cond = TF._cond(tp, tspec, torch.from_numpy(x),
                        torch.arange(SMALL["pred_len"], dtype=torch.float32))
        want = DD.eps_head_sample(tp["eps_head"], tspec.eps_cfg, sched, cond,
                                  torch.Generator().manual_seed(5),
                                  n_samples=n_samples)
    got = TF.diffusion_forecaster_sample(tp, tspec, sched,
                                         torch.from_numpy(x),
                                         torch.Generator().manual_seed(5),
                                         n_samples=n_samples)
    assert got.shape == ((B, SMALL["pred_len"]) if n_samples == 1 else
                         (n_samples, B, SMALL["pred_len"]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("case", ["kanrnn", "kan_fet_diffusion", "run_knob",
                                  "plots", "no_card"])
def test_refusals(case, tmp_path):
    # The kanrnn encoder and kan_fet_diffusion are ported (the kanrnn
    # cases of test_diffusion_loss_matches_jax, test_convert_round_trip and
    # test_cli_ett_on_cpu); an unknown encoder or model is still refused.
    if case == "kanrnn":
        with pytest.raises(ValueError, match="unknown encoder"):
            TF.diffusion_forecaster_init(torch.Generator(), TF.
                                         DiffusionForecasterSpec(
                                             num_features=3,
                                             encoder="kanrnn2"))
    elif case == "kan_fet_diffusion":
        with pytest.raises(SystemExit, match="unknown ETT model"):
            cli.main(["ett", "--device", "cpu", "--model",
                      "kan_fet_diffusion2", "--out-dir", str(tmp_path)])
    elif case == "run_knob":
        # the mesh is ported (tests/test_torch_mesh_drivers.py); without a
        # process group of its ranks it refuses before any work
        for kw in (dict(mesh_devices=2), dict(mesh_devices=4, mesh_model=2)):
            with pytest.raises(RuntimeError, match="process group"):
                tdrv.train_point_forecaster(None, None, None,
                                            tdrv.ForecastRun(device="cpu",
                                                             **kw))
    elif case == "plots":
        # ported: the loss curves and the forecast, as the JAX CLI draws
        cli.main(["ett", "--device", "cpu", "--plots", "--epochs", "1",
                  "--latent_dim", "8", "--context_len", "12", "--pred_len",
                  "4", "--out-dir", str(tmp_path)])
        assert sorted(p.name for p in tmp_path.glob("*.png")) == \
            ["forecast.png", "loss.png"]
    elif case == "no_card":
        if torch.cuda.is_available():
            pytest.skip("checks the refusal of --device cuda without CUDA")
        for argv in (["ett"], ["serve", "--source", "ett"],
                     ["serve", "--source", "ddpm"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(argv + ["--out-dir", str(tmp_path)])


@pytest.mark.cuda
def test_ett_training_on_card_launches_the_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.ops import ddpm as DD
    from fetode_tpu_torch.ops import ode_dyn as OD

    for model in ("point", "diffusion"):
        kernels = (OD.ode_dyn_fwd, OD.ode_dyn_bwd) + (
            (DD.ddpm_chain,) if model == "diffusion" else ())
        for k in kernels:
            k.launches = 0
        result = cli.main(["ett", "--model", model, "--device", "cuda",
                           "--solver_mode", "pallas", "--epochs", "1",
                           "--out-dir", str(tmp_path)])
        assert np.isfinite(result["train_curve"]).all()
        assert all(k.launches > 0 for k in kernels)
