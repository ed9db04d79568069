"""PyTorch port, the drivers on a mesh against the port's own single-device
runs: the trajectory driver (``n_devices``, ``model_axis``), multiple
shooting over ranks (``shooting_devices``), the ECG trainer
(``mesh_devices``, ``mesh_model``; ``kanfet_mlp_node`` with ``mesh=``),
the noise-study population over ranks, the forecasting and
conditional-diffusion trainers, ``cli mnist --mesh`` inside the ranks
and ``cli.main([... "--mesh", "2"])`` starting its own ranks.

The JAX package's random streams differ from the port's, so these are
port against port (``tests/test_torch_parallel.py`` and
``tests/test_torch_sharded_solves.py`` hold the mesh against the JAX
package).  The ranks (``parallel.spawn_local``, gloo, CPU, one torch
thread each; this module imports no JAX, so neither does a rank) run
every scenario in one spawn of two ranks and one of four (data = 2 x
model = 2).  Tolerances: the JAX package's
for its mesh drivers (``tests/test_parallel.py``), curves rtol 2e-4 /
atol 1e-6; the population's members within atol 5e-6
(``tests/test_population.py``); the per-shard ECG solve against the
whole-batch one at the JAX test's rtol 1e-3 / atol 1e-5 (each shard
controls its own steps).
"""

import os
import sys

import numpy as np
import pytest
import torch

from fetode_tpu_torch import cli
from fetode_tpu_torch.models import ecg as M
from fetode_tpu_torch.models.cond_diffusion import make_denoiser_spec
from fetode_tpu_torch.models.forecasting import (
    DiffusionForecasterSpec,
    LatentODEForecasterSpec,
)
from fetode_tpu_torch.models.predprey import PredPreyNODE, PredPreyTask
from fetode_tpu_torch.parallel import driver_mesh, is_rank0, spawn_local
from fetode_tpu_torch.train.cond_diffusion_driver import (
    CondDiffusionRun,
    train_conditional_diffusion,
)
from fetode_tpu_torch.train.ecg_driver import (
    ECGRun,
    train_ecg_model,
    train_ecg_population,
)
from fetode_tpu_torch.train.forecast_driver import (
    ForecastRun,
    train_diffusion_forecaster,
    train_point_forecaster,
)
from fetode_tpu_torch.train.predprey_driver import PredPreyRun, train_predprey
from fetode_tpu_torch.train.traj_driver import (
    TrajParallelRun,
    train_traj_parallel,
)

CURVE = dict(rtol=2e-4, atol=1e-6)
TWO = ("traj", "shooting", "ecg", "ecg_per_shard", "population", "forecast",
       "cond_diffusion", "mnist")
FOUR = ("traj_scan", "ecg", "ecg_resume")


def _np(t):
    return t.detach().cpu().numpy().copy()


def ecg_data(seed=0, n_train=16, n_test=8, T=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_train, T)).astype(np.float32),
            (rng.random(n_train) > 0.5).astype(np.int32),
            rng.normal(size=(n_test, T)).astype(np.float32),
            (rng.random(n_test) > 0.5).astype(np.int32))


def cond_windows(seed=0):
    rng = np.random.default_rng(seed)

    def windows(k):
        return (rng.normal(size=(k, 12, 3)).astype(np.float32),
                rng.normal(size=(k, 4, 3)).astype(np.float32))

    return {"train": windows(32), "val": windows(16), "test": windows(16)}


def forecast_series(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(220, 3)).astype(np.float32),
            rng.normal(size=220).astype(np.float32))


def traj_run(**kw):
    task = PredPreyTask(n_train=6, tf_learn=0.8, tf=1.6, n_t=12)
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 4, 2), ferro_num_basis=2,
                               solver_mode=kw.pop("solver_mode", "auto"))
    return TrajParallelRun(task=task, spec=spec, n_traj=8, epochs=4,
                           epochs_per_call=2, device="cpu", **kw)


def shooting_run(**kw):
    task = PredPreyTask(n_train=13, tf_learn=1.2, tf=2.4, n_t=26)
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 4, 2), ferro_num_basis=2,
                               max_steps=64)
    return PredPreyRun(task=task, spec=spec, epochs=4, epochs_per_call=2,
                       shooting_points=4, device="cpu", **kw)


ECG_SPEC = dict(T=12, latent_dim=8, ode_hidden=8, num_basis=2, max_steps=8)


def driver_curves(mesh_devices=0, mesh_model=1, which=(), ckpt_root=""):
    """The driver-level curves the mesh tests compare, for a mesh of
    ``mesh_devices`` ranks (0: one device).  ``which`` picks the
    scenarios; ``ckpt_root`` is a directory every rank sees."""
    n = mesh_devices or None
    md = dict(mesh_devices=mesh_devices, mesh_model=mesh_model)
    out = {}
    if "traj" in which:
        _, h = train_traj_parallel(traj_run(n_devices=n,
                                            model_axis=mesh_model), log=None)
        out["traj"] = h["train"]
    if "traj_scan" in which:
        _, h = train_traj_parallel(traj_run(
            solver_mode="scan", n_devices=n, model_axis=mesh_model), log=None)
        out["traj_scan"] = h["train"]
    if "shooting" in which:
        _, h = train_predprey(shooting_run(shooting_devices=mesh_devices),
                              log=None)
        out["shooting"] = h["train"]
    data = ecg_data()
    spec = M.KanFetMLPNODESpec(**ECG_SPEC)
    init = lambda g: M.kanfet_mlp_node_init(g, spec)  # noqa: E731
    kw = dict(epochs=2, batch_size=8, log_every=100, device="cpu")
    if "ecg" in which:
        _, h = train_ecg_model(init, lambda p, x, g: M.kanfet_mlp_node_apply(
            p, spec, x), data, ECGRun(**kw, **md), log=None)
        out["ecg"] = (h["loss"], h["test_acc"])
    if "ecg_resume" in which:
        # checkpointed after epoch 1 (rank 0 writes the optimiser's
        # moments gathered whole) and resumed by every rank for epoch 2
        ck = os.path.join(ckpt_root, f"ecg_{mesh_devices}_{mesh_model}")
        apply = lambda p, x, g: M.kanfet_mlp_node_apply(  # noqa: E731
            p, spec, x)
        ckw = dict(kw, ckpt_dir=ck, ckpt_every=1, **md)
        train_ecg_model(init, apply, data, ECGRun(**dict(ckw, epochs=1)),
                        log=None)
        params, h = train_ecg_model(init, apply, data,
                                    ECGRun(**ckw, resume=True), log=None)
        whole = True
        if is_rank0():      # the writer; the other ranks may be ahead
            sd = torch.load(os.path.join(ck, "ckpt_2.pt"),
                            weights_only=True)
            whole = [tuple(st["exp_avg"].shape) for _, st in sorted(
                sd["state"]["opt"]["inner"]["state"].items())] == [
                tuple(p.shape) for p in params.parameters()]
        out["ecg_resume"] = (h["loss"], h["test_acc"], whole)
    if "ecg_per_shard" in which:
        spec_a = spec._replace(solver_mode="auto")
        mesh = driver_mesh(mesh_devices, mesh_model)
        _, h = train_ecg_model(init, lambda p, x, g: M.kanfet_mlp_node_apply(
            p, spec_a, x, mesh=mesh), data, ECGRun(**kw, **md), log=None)
        out["ecg_per_shard"] = h["loss"]
    if "population" in which:
        spec_a = spec._replace(solver_mode="auto")
        members = [(0.0, 0), (0.2, 0), (0.0, 1), (0.2, 1)]
        best, hs = train_ecg_population(
            init, lambda ps, x, gens, stds: M.kanfet_mlp_node_apply_members(
                ps, spec_a, x, generators=gens, noise_stds=stds),
            data, ECGRun(epochs=2, batch_size=8, log_every=100, device="cpu",
                         mesh_devices=mesh_devices), members, log=None)
        out["population"] = ([h["loss"] for h in hs],
                             [h["test_acc"] for h in hs],
                             {k: _np(v) for k, v in best.items()})
    if "forecast" in which:
        X, y = forecast_series()
        fk = dict(context_len=12, pred_len=4, batch_size=16, epochs=2,
                  log_every=100, device="cpu", eval_samples=2)
        _, h = train_point_forecaster(
            LatentODEForecasterSpec(num_features=3, context_len=12,
                                    pred_len=4, latent_dim=8), X, y,
            ForecastRun(**fk, **md), log=None)
        out["forecast"] = (h["train"], h["val"], h["test_mse"])
        _, h = train_diffusion_forecaster(
            DiffusionForecasterSpec(num_features=3, context_len=12,
                                    pred_len=4, latent_dim=8, enc_hidden=16,
                                    dyn_hidden=16, diff_T=8, diff_hidden=16),
            X, y,
            ForecastRun(**fk, **md), log=None)
        out["forecast_diffusion"] = (h["train"], h["val"])
    if "cond_diffusion" in which:
        for den in ("mlp", "kan_node"):
            cspec = make_denoiser_spec(den, d_in=3, pred_len=4, seq_len=12,
                                       cond_dim=16, time_dim=16, hidden=32)
            _, h = train_conditional_diffusion(cspec, cond_windows(),
                                               CondDiffusionRun(
                seq_len=12, pred_len=4, diff_T=8, epochs=2, batch_size=16,
                log_every=100, device="cpu", **md), log=None)
            out[f"cond_diffusion_{den}"] = (h["train"], h["val"])
    if "mnist" in which:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            argv = ["mnist", "--device", "cpu", "--epochs", "2",
                    "--kuramoto_steps", "2", "--batch_size", "64",
                    "--out-dir", tmp]
            if mesh_devices:
                argv += ["--mesh", f"data={mesh_devices // mesh_model},"
                                   f"model={mesh_model}"]
            out["mnist"] = cli.main(argv)
    return out


def _rank(rank, mesh_devices, mesh_model, which, ckpt_root):
    """A rank: the curves of ``which`` on the mesh, with one torch thread
    and no JAX loaded."""
    torch.set_num_threads(1)
    out = driver_curves(mesh_devices, mesh_model, which, ckpt_root)
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("ckpt"))
    try:
        single = driver_curves(0, 1, TWO + FOUR, root)
    finally:
        torch.set_num_threads(n)
    two = spawn_local(_rank, 2, (2, 1, TWO, root), device="cpu", timeout=120)
    four = spawn_local(_rank, 4, (4, 2, FOUR, root), device="cpu",
                       timeout=120)
    return single, two, four


def _same(got, want, key):
    if key == "ecg":
        np.testing.assert_allclose(got[0], want[0], **CURVE)
        np.testing.assert_allclose(got[1], want[1])
    elif key == "ecg_per_shard":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    elif key == "population":
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-6)
        np.testing.assert_allclose(got[1], want[1])
        assert set(got[2]) == set(want[2])
        for k in want[2]:
            np.testing.assert_allclose(got[2][k], want[2][k], atol=5e-6,
                                       err_msg=k)
    elif key == "ecg_resume":
        # the resumed epoch is the unbroken run's second, and the
        # checkpoint's moments have the whole leaves' shapes
        np.testing.assert_allclose(got[0], want[0][1:], **CURVE)
        np.testing.assert_allclose(got[1], want[1][1:])
        assert got[2]
    elif key == "mnist":
        np.testing.assert_allclose(got["test_acc"], want["test_acc"])
    elif isinstance(want, tuple):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **CURVE)
    else:
        np.testing.assert_allclose(got, want, **CURVE)


def _expand(keys):
    out = []
    for k in keys:
        if k == "forecast":
            out += ["forecast", "forecast_diffusion"]
        elif k == "cond_diffusion":
            out += ["cond_diffusion_mlp", "cond_diffusion_kan_node"]
        else:
            out.append(k)
    return out


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("key", _expand(TWO))
def test_two_ranks_match_single_device(runs, key, rank):
    single, two, _ = runs
    assert not two[rank]["jax_loaded"]
    _same(two[rank][key], single[key], key)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("key", FOUR)
def test_data_x_model_ranks_match_single_device(runs, key, rank):
    single, _, four = runs
    _same(four[rank][key], single["ecg" if key == "ecg_resume" else key],
          key)


def test_cli_mesh_starts_its_ranks(runs, tmp_path):
    """``cli.main`` run alone with ``--mesh 2`` starts two local ranks
    (spawn, gloo on the CPU); rank 0 writes ``result.json``, which main
    returns: the single-device result."""
    single, _, _ = runs
    r = cli.main(["mnist", "--device", "cpu", "--epochs", "2",
                  "--kuramoto_steps", "2", "--batch_size", "64", "--mesh",
                  "2", "--out-dir", str(tmp_path)])
    assert r == single["mnist"]
    assert (tmp_path / "result.json").exists()


def _world_of_one(rank):
    """A group of one rank: the trajectory driver on a one-rank mesh
    runs shard_map_rows' collectives (counted) as over many."""
    import fetode_tpu_torch.parallel.collectives as C

    torch.set_num_threads(1)
    calls = []
    gather = C.all_gather_cat

    def counted(*a, **k):
        calls.append(1)
        return gather(*a, **k)

    C.all_gather_cat = counted
    try:
        _, h = train_traj_parallel(traj_run(n_devices=1), log=None)
    finally:
        C.all_gather_cat = gather
    return h["train"], len(calls), torch.distributed.get_world_size()


def test_world_of_one_runs_the_collectives():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, want = train_traj_parallel(traj_run(), log=None)
    finally:
        torch.set_num_threads(n)
    (losses, gathers, size), = spawn_local(_world_of_one, 1, device="cpu",
                                           timeout=120)
    assert size == 1 and gathers > 0
    np.testing.assert_array_equal(losses, want["train"])


@pytest.mark.parametrize("case", ["population", "segments",
                                  "shooting_without_segments", "pallas_tp",
                                  "no_group", "cli_workload"])
def test_mesh_refusals(case, tmp_path):
    if case == "population":
        with pytest.raises(ValueError, match="not divisible by "
                                             "mesh_devices=2"):
            train_ecg_population(None, None, ecg_data(), ECGRun(
                device="cpu", mesh_devices=2), [(0.0, 0)] * 3, log=None)
        with pytest.raises(ValueError, match="mesh_model"):
            train_ecg_population(None, None, ecg_data(), ECGRun(
                device="cpu", mesh_devices=2, mesh_model=2), [(0.0, 0)] * 4,
                log=None)
    elif case == "segments":
        # 12 intervals of the 13 fit times -> 4 segments, not over 3 ranks
        with pytest.raises(ValueError, match="not divisible by "
                                             "shooting_devices=3"):
            train_predprey(shooting_run(shooting_devices=3),
                              log=None)
    elif case == "shooting_without_segments":
        with pytest.raises(ValueError, match="shooting_devices"):
            train_predprey(PredPreyRun(shooting_devices=4,
                                             device="cpu"), log=None)
    elif case == "pallas_tp":
        with pytest.raises(ValueError, match="tensor parallelism"):
            train_traj_parallel(traj_run(
                solver_mode="pallas", n_devices=4, model_axis=2), log=None)
    elif case == "no_group":
        with pytest.raises(RuntimeError, match="process group"):
            train_traj_parallel(traj_run(n_devices=2), log=None)
    elif case == "cli_workload":
        with pytest.raises(SystemExit, match="--mesh is not supported"):
            cli.main(["symbolic", "--device", "cpu", "--mesh", "2",
                      "--out-dir", str(tmp_path)])
