"""PyTorch port, the Time-MMD slice against the JAX package: the data
layer without pandas or sklearn (``data/{timefeatures,informer,
timeseries,multimodal,metrics,masking,batching,columns}.py``) and ``cli
timemmd``, unimodal and text-fused.

Inputs from numpy seeds; CSVs written to ``tmp_path`` with pandas, which
drives the JAX side.  Tolerances:
* time features, Informer windows and marks, ``load_timemmd_csv``,
  ``merge_with_text``, metrics and masks: exact (scalers 1e-6);
* ``fuse_features`` against the JAX package's sklearn TF-IDF + truncated
  SVD: 1e-5 (the port repeats sklearn's arithmetic with the same numpy
  and scipy calls, so the two agree far closer);
* the slice: the feature matrix ``cli timemmd`` trains on, its numeric
  columns exact and its text columns 1e-5 as ``fuse_features`` (the
  synthetic texts span 3 of 7 SVD directions; the other 4 are a basis of
  a null space that two calls of sklearn itself do not reproduce, and
  the texts' coordinates along them are rounding, about 1e-15);
  the ``kanrnn`` diffusion forecaster's loss on it, JAX-initialised
  parameters converted, on the JAX package's own noise draws, 1e-5
  (float32, the eager solve at the spec's rtol 1e-3);
* the small ``cli timemmd`` runs (context 10, pred 3, 1 epoch, batch 32,
  as ``tests/test_cli_workloads.py``): a finite test MSE.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fetode_tpu import cli as jcli
from fetode_tpu.config import make_config as j_make_config
from fetode_tpu.data import informer as jinf
from fetode_tpu.data import masking as jmask
from fetode_tpu.data import metrics as jmet
from fetode_tpu.data import multimodal as jmm
from fetode_tpu.data import timefeatures as jtf
from fetode_tpu.data import timeseries as jts
from fetode_tpu.models import forecasting as JF
from fetode_tpu.nn.diffusion import make_schedule as j_schedule
from fetode_tpu.train import forecast_driver as j_fdrv
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import forecast_params_from_numpy
from fetode_tpu_torch.data import batching, ecg200
from fetode_tpu_torch.data import informer as tinf
from fetode_tpu_torch.data import masking as tmask
from fetode_tpu_torch.data import metrics as tmet
from fetode_tpu_torch.data import multimodal as tmm
from fetode_tpu_torch.data import timefeatures as ttf
from fetode_tpu_torch.data import timeseries as tts
from fetode_tpu_torch.models import forecasting as TF
from fetode_tpu_torch.nn import diffusion as TD
from fetode_tpu_torch.train import forecast_driver as t_fdrv


def _table(df: pd.DataFrame) -> dict:
    """A pandas frame as the port's table: numeric columns as they are,
    text as object arrays with None where missing."""
    out = {}
    for c in df.columns:
        v = df[c]
        if pd.api.types.is_numeric_dtype(v) or \
                pd.api.types.is_datetime64_any_dtype(v):
            out[c] = v.to_numpy()
        else:
            out[c] = np.asarray([None if pd.isna(x) else str(x) for x in v],
                                object)
    return out


# ------------------------------------------------------------ time features


@pytest.mark.parametrize("timeenc", [0, 1])
def test_time_features_match_jax(timeenc):
    """Every key of ``_FREQ_FEATURES`` (and multiples, '15min'), on dates
    from 1907 to 2096, leap days and ISO weeks 53 / 1 at year ends
    among them, as datetime64, as strings and as a table."""
    rng = np.random.default_rng(0)
    secs = rng.integers(-2 * 10 ** 9, 4 * 10 ** 9, 4000)
    edges = np.asarray(["2020-12-31", "2021-01-03", "2021-01-04",
                        "2015-12-31", "2016-02-29", "2018-12-31",
                        "2026-12-31", "2027-01-01"], "datetime64[s]")
    dates = np.concatenate([np.asarray(secs, "datetime64[s]"), edges]
                           ).astype("datetime64[ns]")
    index = pd.DatetimeIndex(dates)
    for freq in ["m", "w", "d", "b", "h", "t", "s", "15min", "5T", "x"]:
        want = jtf.time_features(index, timeenc=timeenc, freq=freq)
        got = ttf.time_features(dates, timeenc=timeenc, freq=freq)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=freq)
    strings = ttf.time_features(np.asarray(index.astype(str), object),
                                timeenc=timeenc, freq="t")
    frame = ttf.time_features({"date": dates}, timeenc=timeenc, freq="t")
    np.testing.assert_array_equal(strings, frame)
    np.testing.assert_array_equal(frame, jtf.time_features(
        pd.DataFrame({"date": index}), timeenc=timeenc, freq="t"))
    for fn, arg in ((jtf.time_features, index), (ttf.time_features, dates)):
        with pytest.raises(ValueError):       # 'y' has no features
            fn(arg, timeenc=1, freq="y")


# ------------------------------------------------------------ Informer


def _ett_frame(n, freq, start="2016-07-01"):
    rng = np.random.default_rng(1)
    return pd.DataFrame({
        "date": pd.date_range(start, periods=n, freq=freq).astype(str),
        "HUFL": rng.standard_normal(n).astype(np.float32),
        "MULL": np.sin(np.arange(n) / 24.0),
        "OT": rng.standard_normal(n) * 3 + 10,
    })


def _same_split(got, want):
    (gw, gs), (ww, ws) = got, want
    for a, b in zip(gw, ww):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if ws is None:
        assert gs is None
    else:
        np.testing.assert_allclose(gs.mu, ws.mu, rtol=1e-6)
        np.testing.assert_allclose(gs.sd, ws.sd, rtol=1e-6)


@pytest.mark.parametrize("kind", ["hour", "minute"])
def test_informer_ett_datasets_match_jax(kind, tmp_path):
    n = (12 * 30 * 24 + 8 * 30 * 24) * (1 if kind == "hour" else 4)
    _ett_frame(n, "h" if kind == "hour" else "15min").to_csv(
        tmp_path / "ETT.csv", index=False)
    jfn, tfn = ((jinf.dataset_ett_hour, tinf.dataset_ett_hour)
                if kind == "hour" else
                (jinf.dataset_ett_minute, tinf.dataset_ett_minute))
    for flag, features, timeenc, scale in (("train", "S", 0, True),
                                           ("val", "M", 1, True),
                                           ("test", "MS", 0, False)):
        kw = dict(flag=flag, size=(16, 8, 8), features=features,
                  data_path="ETT.csv", root_path=str(tmp_path),
                  timeenc=timeenc, scale=scale)
        _same_split(tfn(**kw), jfn(**kw))


def test_informer_custom_and_pred_match_jax(tmp_path):
    df = _ett_frame(500, "h")
    df.to_csv(tmp_path / "custom.csv", index=False)
    for flag in ("train", "val", "test"):
        kw = dict(flag=flag, size=(24, 12, 6), features="M", timeenc=1)
        _same_split(tinf.dataset_custom(df_raw=_table(df), **kw),
                    jinf.dataset_custom(df_raw=df, **kw))
        _same_split(tinf.dataset_custom(data_path="custom.csv",
                                        root_path=str(tmp_path), **kw),
                    jinf.dataset_custom(data_path="custom.csv",
                                        root_path=str(tmp_path), **kw))
    for freq, timeenc in (("h", 0), ("t", 0), ("t", 1), ("d", 1),
                          ("b", 1), ("w", 1)):
        kw = dict(size=(48, 12, 12), features="S", target="OT", freq=freq,
                  timeenc=timeenc)
        got = tinf.dataset_pred(df_raw=_table(df), **kw)
        want = jinf.dataset_pred(df_raw=df, **kw)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b, err_msg=freq)
        np.testing.assert_allclose(got[3].mu, want[3].mu, rtol=1e-6)
    seq_x, _, _, _ = tinf.dataset_pred(data_path="custom.csv",
                                       root_path=str(tmp_path),
                                       size=(48, 12, 12))
    assert seq_x.shape == (1, 48, 1)
    with pytest.raises(ValueError, match="date ranges"):
        tinf.dataset_pred(df_raw=_table(df), freq="m")


# ------------------------------------------------------------ Time-MMD CSV


def test_load_timemmd_csv_matches_jax(tmp_path):
    """NaNs (an all-missing column too), an area column, an id column to
    drop, a text column, and out-of-order dates with many ties and an
    unreadable one: the rows, their order and the filled values."""
    rng = np.random.default_rng(2)
    n = 400
    days = np.datetime64("2020-01-01") + rng.integers(0, 30, n).astype(
        "timedelta64[D]")
    df = pd.DataFrame({
        "date": days.astype(str),
        "AreaOfInterest": rng.choice(["US", "EU", "Asia"], n),
        "id": np.arange(n),
        "OT": np.where(rng.random(n) < 0.2, np.nan, rng.standard_normal(n)),
        "empty": np.nan,
        "load": np.where(rng.random(n) < 0.1, np.nan, rng.integers(0, 9, n)),
        "note": rng.choice(["dry", "wet", None], n),
    })
    df.loc[3, "date"] = "not a date"
    df.loc[0, "OT"] = np.nan            # a leading gap: back-filled
    path = str(tmp_path / "Energy.csv")
    df.to_csv(path, index=False)
    for kw in (dict(), dict(date_col="date"),
               dict(date_col="date", drop_cols=("id", "nope"),
                    area_filter=("AreaOfInterest", "US")),
               dict(area_filter=("missing_col", "US"))):
        X, y, table = tts.load_timemmd_csv(path, "OT", **kw)
        Xj, yj, dfj = jts.load_timemmd_csv(path, "OT", **kw)
        assert X.dtype == np.float32 and y.dtype == np.float32
        np.testing.assert_array_equal(X, Xj)
        np.testing.assert_array_equal(y, yj)
        assert list(table) == list(dfj.columns)
        if "id" in table:
            np.testing.assert_array_equal(table["id"], dfj["id"].to_numpy())
        # the raw column as read: pandas' fast float parser is not
        # correctly rounded (a few float64 ulps); X and y are float32
        np.testing.assert_allclose(table["OT"], dfj["OT"].to_numpy(),
                                   rtol=0, atol=1e-15)
        if "date_col" in kw:
            np.testing.assert_array_equal(
                table["date"], dfj["date"].to_numpy().astype(
                    "datetime64[ns]"))
    with pytest.raises(ValueError, match="not in numeric"):
        tts.load_timemmd_csv(path, "note")


# ------------------------------------------------------------ text fusion


_WORDS = ("drought heavy rain storm heat wave cold front wind demand load "
          "grid price peak outage solar output region alpha beta north "
          "south coast inland forecast expects rise fall stable record "
          "high low week month reservoir level temperature humidity").split()


def _reports(n, rng, vocab=200):
    extra = [f"site{i}" for i in range(vocab)]
    out = []
    for i in range(n):
        k = int(rng.integers(6, 30))
        words = list(rng.choice(_WORDS + extra, k))
        out.append(f"Week {i % 52 + 1}: " + " ".join(words) +
                   f". Level {rng.integers(10, 99)} percent.")
    return out


def test_merge_with_text_matches_jax():
    rng = np.random.default_rng(3)
    n, m = 80, 60
    starts = np.datetime64("2021-01-03") + 7 * rng.integers(0, 30, n).astype(
        "timedelta64[D]")
    numeric = pd.DataFrame({
        "start_date": starts.astype(str),
        "end_date": (starts + np.timedelta64(6, "D")).astype(str),
        "OT": rng.standard_normal(n), "val": np.arange(n, dtype=float)})
    rs = np.datetime64("2021-01-03") + 7 * rng.integers(0, 35, m).astype(
        "timedelta64[D]")
    texts = _reports(m, rng)
    report = pd.DataFrame({
        "start_date": rs.astype(str),
        "end_date": (rs + np.timedelta64(6, "D")).astype(str),
        "fact": [t if rng.random() < 0.9 else None for t in texts],
        "preds": [f"forecast {i}" for i in range(m)],
        "other": np.arange(m)})
    search = report.sample(frac=0.7, random_state=1).reset_index(drop=True)
    for variant in ("dates", "mapdate", "valid"):
        num = numeric.copy()
        if variant == "mapdate":
            num["MapDate"] = pd.to_datetime(num["start_date"]).dt.strftime(
                "%Y%m%d").astype(int)
        if variant == "valid":
            num = num.rename(columns={"start_date": "ValidStart",
                                      "end_date": "ValidEnd"})
        want = jmm.merge_with_text(num, report, search)
        got = tmm.merge_with_text(_table(num), _table(report),
                                  _table(search))
        assert list(got) == list(want.columns), variant
        assert list(got["text"]) == list(want["text"]), variant
        np.testing.assert_array_equal(got["OT"], want["OT"].to_numpy())
        np.testing.assert_array_equal(
            got["date"], want["date"].to_numpy().astype("datetime64[ns]"))


@pytest.mark.parametrize("max_features,embed_dim", [(20_000, 7), (60, 7),
                                                    (None, 3)])
def test_fuse_features_matches_sklearn(max_features, embed_dim):
    """Report texts; at 60 features the vocabulary (a few hundred terms
    past min_df) is cut, its ties broken as sklearn breaks them."""
    rng = np.random.default_rng(4)
    texts = _reports(300, rng)
    texts[5], texts[9] = None, ""
    X_num = rng.standard_normal((300, 4)).astype(np.float32)
    got, aux = tmm.fuse_features(X_num, texts, 210, embed_dim=embed_dim,
                                 max_features=max_features)
    want, jaux = jmm.fuse_features(X_num, texts, 210, embed_dim=embed_dim,
                                   max_features=max_features)
    assert got.shape == want.shape == (300, 4 + embed_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    vec = jaux["vectorizer"]
    assert aux["vectorizer"].vocabulary == vec.vocabulary_
    if max_features is not None:
        assert len(vec.vocabulary_) <= max_features
    np.testing.assert_allclose(aux["vectorizer"].idf, vec.idf_, rtol=1e-12)
    np.testing.assert_allclose(aux["svd"], jaux["svd"].components_,
                               rtol=1e-9, atol=1e-12)
    tmm.assert_feature_dim(4 + embed_dim, got)
    with pytest.raises(ValueError, match="features but data has"):
        tmm.assert_feature_dim(9, got)


def test_embed_text_tiny_vocabulary_pads():
    """Two terms: one SVD component, padded to embed_dim as the JAX
    package pads."""
    texts = ["up up down", "down up", "up down", "down down"] * 5
    got, _, _ = tmm.embed_text(texts, 12, embed_dim=4, ngram_range=(1, 1))
    want, _, _ = jmm.embed_text(texts, 12, embed_dim=4, ngram_range=(1, 1))
    assert got.shape == (20, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ metrics, masks


def test_metrics_and_masks_match_jax():
    rng = np.random.default_rng(5)
    pred, true = rng.standard_normal((2, 50, 3)) + 2.0
    for name in ("rse", "corr", "mae", "mse", "rmse", "mape", "mspe"):
        assert getattr(tmet, name)(pred, true) == \
            getattr(jmet, name)(pred, true), name
    assert tmet.metric(pred, true) == jmet.metric(pred, true)

    B, H, L, n_top = 2, 3, 7, 4
    np.testing.assert_array_equal(tmask.causal_mask(B, L).numpy(),
                                  np.asarray(jmask.causal_mask(B, L)))
    index = rng.integers(0, L, size=(B, H, n_top))
    scores = rng.standard_normal((B, H, n_top, L)).astype(np.float32)
    mask = tmask.prob_mask(torch.from_numpy(index), torch.from_numpy(scores),
                           L)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jmask.prob_mask(index, scores, L)))
    np.testing.assert_array_equal(
        tmask.apply_mask(torch.from_numpy(scores), mask).numpy(),
        np.asarray(jmask.apply_mask(scores, mask.numpy())))
    # the batching helpers moved to data/batching.py, re-exported
    assert ecg200.epoch_batches is batching.epoch_batches


# ------------------------------------------------------------ the slice


SMALL_ARGS = ["--domain", "Nonexistent", "--context_len", "10", "--pred_len",
              "3", "--epochs", "1", "--batch_size", "32"]


def _captured_X(monkeypatch, module, call):
    seen = {}

    def capture(spec, X, y, run, *a, **kw):
        seen.update(X=X, y=y, spec=spec)
        return None, {"test_mse": 0.0, "wall_seconds": 0.0, "train": [],
                      "val": []}
    monkeypatch.setattr(module, "train_diffusion_forecaster", capture)
    call()
    return seen


@pytest.mark.parametrize("multimodal", [False, True])
def test_cli_timemmd_features_match_jax(multimodal, monkeypatch, tmp_path):
    """The feature matrix ``cli timemmd`` trains on (the synthetic series,
    with ``--multimodal`` its synthetic texts' embedding), and the spec."""
    extra = ["--multimodal", "true"] if multimodal else []
    port = _captured_X(monkeypatch, t_fdrv, lambda: cli.main(
        ["timemmd", "--device", "cpu", "--out-dir", str(tmp_path)]
        + SMALL_ARGS + extra))
    jargs = jcli._parse(["timemmd"] + SMALL_ARGS + extra)[1]
    jax_ = _captured_X(monkeypatch, j_fdrv, lambda: jcli.run_timemmd(
        j_make_config("timemmd", jargs), str(tmp_path), False))
    assert port["X"].shape == jax_["X"].shape == (
        1200, 5 + (7 if multimodal else 0))
    np.testing.assert_array_equal(port["X"][:, :5], jax_["X"][:, :5])
    np.testing.assert_allclose(port["X"][:, 5:], jax_["X"][:, 5:],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port["y"], jax_["y"])
    for f in ("num_features", "context_len", "pred_len", "encoder",
              "latent_dim", "rnn_hidden", "num_basis", "diff_T"):
        assert getattr(port["spec"], f) == getattr(jax_["spec"], f), f


def test_kanrnn_loss_on_fused_features_matches_jax(monkeypatch, tmp_path):
    """JAX-initialised ``kanrnn`` forecaster parameters at the preset's
    widths, converted, on the first train windows of the fused matrix:
    the epsilon loss on the JAX package's own draws."""
    port = _captured_X(monkeypatch, t_fdrv, lambda: cli.main(
        ["timemmd", "--device", "cpu", "--multimodal", "true",
         "--out-dir", str(tmp_path)] + SMALL_ARGS))
    X, y = port["X"], port["y"]
    run = t_fdrv.ForecastRun(context_len=10, pred_len=3, device="cpu")
    windows, _, _ = t_fdrv.prepare_windows(X, y, run)
    x, yf = (a[:6] for a in windows["train"])
    kw = dict(num_features=X.shape[1], context_len=10, pred_len=3,
              encoder="kanrnn")
    jspec = JF.DiffusionForecasterSpec(**kw)
    jp = JF.diffusion_forecaster_init(jax.random.PRNGKey(0), jspec)
    tspec = TF.DiffusionForecasterSpec(**kw)
    tp = TF.diffusion_forecaster_init(torch.Generator().manual_seed(0),
                                      tspec)
    tp.load_state_dict(forecast_params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jp)))
    tp = tp.to(torch.float32)
    key = jax.random.PRNGKey(7)
    k_t, k_q = jax.random.split(key)
    t_idx = np.array(jax.random.randint(k_t, (6,), 0, jspec.diff_T))
    eps = np.array(jax.random.normal(k_q, (6, 3), jnp.float32))
    want = JF.diffusion_forecaster_loss(jp, jspec, j_schedule(jspec.diff_T),
                                        jnp.asarray(x), jnp.asarray(yf), key)
    with torch.no_grad():
        got = TF.diffusion_forecaster_loss(
            tp, tspec, TD.make_schedule(tspec.diff_T), torch.from_numpy(x),
            torch.from_numpy(yf), t_idx=torch.from_numpy(t_idx),
            eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("extra", [[], ["--multimodal", "true",
                                        "--text_embed_dim", "3"]],
                         ids=["unimodal", "multimodal"])
def test_cli_timemmd_small_run(extra, tmp_path):
    r = cli.main(["timemmd", "--device", "cpu", "--out-dir", str(tmp_path)]
                 + SMALL_ARGS + extra)
    assert np.isfinite(r["test_mse"])
    assert np.isfinite(r["train_curve"] + r["val_curve"]).all()


def test_cli_timemmd_refusals(tmp_path):
    # --mesh_devices runs: main starts two gloo ranks itself, every rank
    # computes the whole minibatch, and rank 0's result is the
    # single-device one
    got = cli.main(["timemmd", "--device", "cpu", "--out-dir",
                    str(tmp_path / "mesh"), "--mesh_devices", "2"]
                   + SMALL_ARGS)
    want = cli.main(["timemmd", "--device", "cpu", "--out-dir",
                     str(tmp_path / "one")] + SMALL_ARGS)
    for k in ("train_curve", "val_curve", "test_mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    # checkpoint/resume is ported: the flags reach the trainer
    ck = str(tmp_path / "ck")
    cli.main(["timemmd", "--device", "cpu", "--out-dir", str(tmp_path),
              "--ckpt_dir", ck, "--ckpt_every", "1"] + SMALL_ARGS)
    assert sorted(os.listdir(ck)) == ["ckpt_1.pt"]
    # --plots is accepted and draws nothing, as in the JAX CLI
    cli.main(["timemmd", "--device", "cpu", "--out-dir", str(tmp_path),
              "--plots"] + SMALL_ARGS)
    assert not list(tmp_path.glob("*.png"))
