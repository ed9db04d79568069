"""PyTorch port, the conditional-diffusion slice (``models/cond_diffusion.py``,
``train/cond_diffusion_driver.py``, ``cli cond_diffusion``, ``serve
--source cond_diffusion``) against the JAX package's
``models/cond_diffusion.py`` and ``train/cond_diffusion_driver.py``, as
``tests/test_cond_diffusion.py`` runs them.

Size of the JAX tests: d_in 2, pred_len 4, seq_len 12, cond_dim 8,
time_dim 8, hidden 16, ferro_num_basis 2 (the node encoder keeps its
x_proj / hidden widths of 128), B = 3; parameters from the JAX
``cond_denoiser_init(PRNGKey(0))`` converted with
``convert.cond_diffusion_params_from_numpy``, the inputs from a numpy
seed.  The JAX node encoders run their kernel in interpret mode
(``solver_mode="pallas"``); the port's run its eager solve on the CPU.

Tolerances, float32:
* eps_hat: 1e-5 for the conv encoders (the same arithmetic); 1e-4 for the
  node encoders (two solves of one ODE that agree to 1e-5, then the net).
* gradients: cosine > 0.999 and rtol 0.02 / atol 5e-5 for every leaf
  (the JAX node-encoder test's own); the KAN grids, buffers in the port,
  are zeroed.
* the reverse chains on JAX's own draws: 1e-4, the JAX hoist tests' own.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import cond_diffusion as JCD
from fetode_tpu.nn.diffusion import make_schedule as j_schedule
from fetode_tpu.nn.diffusion import p_sample_loop as j_p_sample_loop
from fetode_tpu.train.cond_diffusion_driver import sample_forecasts as j_sample
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import (
    cond_diffusion_grads_to_numpy,
    cond_diffusion_params_from_numpy,
    cond_diffusion_params_to_numpy,
)
from fetode_tpu_torch.models import cond_diffusion as CD
from fetode_tpu_torch.nn import diffusion as TD
from fetode_tpu_torch.train import cond_diffusion_driver as drv

TINY = dict(d_in=2, pred_len=4, seq_len=12, cond_dim=8, time_dim=8,
            hidden=16, ferro_num_basis=2)
B, T = 3, 10
NAMES = sorted(CD.DENOISER_VARIANTS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager solves here are thousands of small ops: with the suite's
    workers sharing the cores, torch's intra-op thread pool oversubscribes
    them (one CLI test took 62 s under load with 8 threads, 4 s with
    one).  One thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _specs(name):
    """(JAX spec, port spec): the JAX node encoders take their kernel in
    interpret mode, the port's the eager solve of the CPU."""
    jspec = JCD.make_denoiser_spec(name, **TINY)
    if jspec.encoder == "node":
        jspec = jspec._replace(solver_mode="pallas")
    return jspec, CD.make_denoiser_spec(name, **TINY)


def _module(tspec, tree):
    mod = CD.cond_denoiser_init(torch.Generator().manual_seed(0), tspec)
    mod.load_state_dict(cond_diffusion_params_from_numpy(tree))
    return mod


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return dict(x_t=rng.standard_normal((B, 4, 2)).astype(np.float32),
                past=rng.standard_normal((B, 12, 2)).astype(np.float32),
                t_idx=np.array([0, 5, 9]),
                ct=rng.standard_normal((B, 4, 2)).astype(np.float32))


def _zero_grids(tree):
    for layer in tree["net"]:
        if "_buffers" in layer:
            layer["_buffers"]["grid"] = np.zeros_like(
                layer["_buffers"]["grid"])
    return tree


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                 + 1e-30))


@pytest.fixture(scope="module", params=NAMES)
def variant(request):
    name = request.param
    jspec, tspec = _specs(name)
    params = JCD.cond_denoiser_init(jax.random.PRNGKey(0), jspec)
    x = _inputs()

    @jax.jit
    def fwd_vjp(p):
        eps, vjp = jax.vjp(lambda q: JCD.cond_denoiser_apply(
            q, jspec, jnp.asarray(x["x_t"]), jnp.asarray(x["past"]),
            jnp.asarray(x["t_idx"])), p)
        return eps, vjp(jnp.asarray(x["ct"]))[0]

    eps, grads = fwd_vjp(params)
    return dict(name=name, jspec=jspec, tspec=tspec, params=params,
                tree=_tree(params), x=x, eps=np.asarray(eps),
                grads=_zero_grids(_tree(grads)))


# ------------------------------------------------------------ encoders


def test_conv_encoder_matches_jax():
    cfg = JCD.ConvEncoderCfg(d_in=3, hidden=8, out_dim=6)
    params = JCD.conv_encoder_init(jax.random.PRNGKey(1), cfg)
    past = np.random.default_rng(2).standard_normal((4, 10, 3)).astype(
        np.float32)
    want = JCD.conv_encoder_apply(params, cfg, jnp.asarray(past))
    tcfg = CD.ConvEncoderCfg(d_in=3, hidden=8, out_dim=6)
    enc = CD.conv_encoder_init(torch.Generator().manual_seed(0), tcfg)
    state = cond_diffusion_params_from_numpy({"encoder": _tree(params),
                                              "net": []})
    enc.load_state_dict({k.removeprefix("encoder."): v
                         for k, v in state.items()})
    with torch.no_grad():
        got = CD.conv_encoder_apply(enc, tcfg, torch.from_numpy(past))
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_variant_forward_matches_jax(variant):
    """eps_hat of every variant, the KANFET net's ferro branch and the
    node encoder's solve included."""
    v = variant
    mod = _module(v["tspec"], v["tree"])
    x = v["x"]
    with torch.no_grad():
        cond = CD.cond_denoiser_encode(mod, v["tspec"],
                                       torch.from_numpy(x["past"]))
        eps = CD.cond_denoiser_apply(mod, v["tspec"],
                                     torch.from_numpy(x["x_t"]),
                                     torch.from_numpy(x["past"]),
                                     torch.from_numpy(x["t_idx"]))
    assert cond.shape == (B, TINY["cond_dim"]) and eps.shape == (B, 4, 2)
    tol = 1e-5 if v["tspec"].encoder == "conv" else 1e-4
    np.testing.assert_allclose(eps.numpy(), v["eps"], rtol=tol, atol=tol)


def test_variant_grads_match_jax(variant):
    v = variant
    mod = _module(v["tspec"], v["tree"])
    x = v["x"]
    eps = CD.cond_denoiser_apply(mod, v["tspec"], torch.from_numpy(x["x_t"]),
                                 torch.from_numpy(x["past"]),
                                 torch.from_numpy(x["t_idx"]))
    torch.sum(eps * torch.from_numpy(x["ct"])).backward()
    got = jax.tree_util.tree_leaves(cond_diffusion_grads_to_numpy(mod))
    want = jax.tree_util.tree_leaves(v["grads"])
    assert len(got) == len(want)
    assert any(np.abs(g).sum() > 0 for g in got)
    for a, b in zip(got, want):
        a, b = a.ravel(), b.ravel()
        if np.abs(b).max() > 0:
            assert _cos(a, b) > 0.999
        np.testing.assert_allclose(a, b, rtol=0.02, atol=5e-5)


def test_convert_round_trip(variant):
    v = variant
    back = cond_diffusion_params_to_numpy(_module(v["tspec"], v["tree"]))
    want = jax.tree_util.tree_leaves_with_path(v["tree"])
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ samplers


def _jax_draws(key, shape):
    """y0 and the per-step noise (T, ...) as the JAX chains draw them."""
    k_init, k_loop = jax.random.split(key)
    y0 = jax.random.normal(k_init, shape, jnp.float32)
    noise = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(k_loop, T))
    return torch.from_numpy(np.array(y0)), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("net", ["mlp", "kan", "kanfet"])
def test_chain_matches_generic_and_jax(net):
    """The port's chain of each net on JAX's draws: the hoisted loops of
    ``mlp`` and ``kan`` equal the generic ``p_sample_loop`` over
    ``cond_denoiser_eps``, and the ``kan`` and KANFET chains equal the JAX
    package's (its hoisted loop, its generic loop); the ``mlp`` loop's
    JAX counterpart is held by the fold test below."""
    name = {"mlp": "mlp", "kan": "kan", "kanfet": "kan_fet_linear_ode"}[net]
    jspec, tspec = _specs(name)
    params = JCD.cond_denoiser_init(jax.random.PRNGKey(3), jspec)
    mod = _module(tspec, _tree(params))
    cond = np.random.default_rng(4).standard_normal((B, 8)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    y0, noise = _jax_draws(key, (B, 4, 2))
    sched, c = TD.make_schedule(T), torch.from_numpy(cond)
    with torch.no_grad():
        got = CD.cond_denoiser_sample_loop(mod, tspec, sched, c, y0=y0,
                                           noise=noise)
        generic = TD.p_sample_loop(
            sched, lambda y, t, cc: CD.cond_denoiser_eps(mod, tspec, y, cc,
                                                         t),
            (B, 4, 2), c, y0=y0, noise=noise)
    assert got.shape == (B, 4, 2)
    np.testing.assert_allclose(got.numpy(), generic.numpy(), rtol=1e-4,
                               atol=1e-4)
    if net == "mlp":
        return
    if net == "kan":
        want = JCD.cond_denoiser_kan_sample_loop(params, jspec, j_schedule(T),
                                                 jnp.asarray(cond), key)
    else:
        want = j_p_sample_loop(
            j_schedule(T), lambda y, t, c_: JCD.cond_denoiser_eps(
                params, jspec, y, c_, t), (B, 4, 2), jnp.asarray(cond), key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_hoisted_loops_reject_other_nets():
    sched, cond = TD.make_schedule(4), torch.zeros((2, 8))
    with pytest.raises(ValueError, match="mlp"):
        CD.cond_denoiser_mlp_sample_loop(None, _specs("kan")[1], sched, cond)
    with pytest.raises(ValueError, match="kan"):
        CD.cond_denoiser_kan_sample_loop(None, _specs("mlp")[1], sched, cond)


def test_sample_forecasts_fold_matches_jax():
    """S = 3 samples folded into rows s*B + b of one chain on the
    conditioning encoded once: JAX's ``sample_forecasts`` (a vmap over the
    samples' keys) on its own draws, and each sample its own chain."""
    jspec, tspec = _specs("mlp")
    params = JCD.cond_denoiser_init(jax.random.PRNGKey(6), jspec)
    mod = _module(tspec, _tree(params))
    past = _inputs(7)["past"]
    key = jax.random.PRNGKey(8)
    want = j_sample(params, jspec, j_schedule(T), jnp.asarray(past), key,
                    n_samples=3)
    draws = [_jax_draws(k, (B, 4, 2)) for k in jax.random.split(key, 3)]
    y0 = torch.stack([d[0] for d in draws])
    noise = torch.stack([d[1] for d in draws])
    sched, p = TD.make_schedule(T), torch.from_numpy(past)
    got = drv.sample_forecasts(mod, tspec, sched, p, n_samples=3, y0=y0,
                               noise=noise)
    assert got.shape == (3, B, 4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for s in range(3):
        one = drv.sample_forecasts(mod, tspec, sched, p, n_samples=1,
                                   y0=y0[s:s + 1], noise=noise[s:s + 1])
        np.testing.assert_allclose(got[s].numpy(), one[0].numpy(),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ training


def _toy_windows(n=48, Lx=12, Ly=4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n + Lx + Ly)
    base = np.stack([np.sin(t / 7.0), np.cos(t / 5.0)], -1).astype(np.float32)
    past = np.stack([base[i:i + Lx] for i in range(n)])
    fut = np.stack([base[i + Lx:i + Lx + Ly] for i in range(n)])
    return past + rng.normal(0, 0.01, past.shape).astype(np.float32), fut


@pytest.mark.parametrize("name", ["mlp", "kan_fet_all_node"])
def test_training_and_eval_run(name):
    spec = _specs(name)[1]
    data = {"train": _toy_windows(seed=0), "val": _toy_windows(n=16, seed=1),
            "test": _toy_windows(n=16, seed=2)}
    run = drv.CondDiffusionRun(seq_len=12, pred_len=4, diff_T=8, epochs=2,
                               batch_size=16, eval_samples=2, device="cpu")
    params, hist = drv.train_conditional_diffusion(spec, data, run, log=None)
    assert len(hist["train"]) == len(hist["val"]) == 2
    assert np.isfinite(hist["train"] + hist["val"]).all()
    res = drv.evaluate_forecast(params, spec, run, *data["test"],
                                torch.Generator().manual_seed(0),
                                n_samples=2)
    assert np.isfinite(res["mse"]) and np.isfinite(res["mae"])
    assert res["samples"].shape == (2, 16, 4, 2)


def test_loss_takes_the_given_draws():
    """``cond_diffusion_loss`` with explicit steps and noise is the MSE of
    the denoiser on ``q_sample`` of them."""
    tspec = _specs("kan")[1]
    mod = CD.cond_denoiser_init(torch.Generator().manual_seed(0), tspec)
    x = _inputs(9)
    fut, past = torch.from_numpy(x["ct"]), torch.from_numpy(x["past"])
    t_idx, eps = torch.from_numpy(x["t_idx"]), torch.from_numpy(x["x_t"])
    sched = TD.make_schedule(T)
    with torch.no_grad():
        got = drv.cond_diffusion_loss(mod, tspec, sched, past, fut,
                                      t_idx=t_idx, eps=eps)
        y_t, _ = TD.q_sample(sched, fut, t_idx, eps=eps)
        want = torch.mean((CD.cond_denoiser_apply(mod, tspec, y_t, past,
                                                  t_idx) - eps) ** 2)
    assert float(got) == float(want)


_CLI = ["--device", "cpu", "--seq_len", "12", "--pred_len", "4", "--diff_t",
        "4", "--eval_samples", "2", "--epochs", "1", "--batch_size", "512"]


@pytest.mark.parametrize("denoiser", ["mlp", "kan_node"])
def test_cli_cond_diffusion_on_cpu(denoiser, tmp_path):
    result = cli.main(["cond_diffusion", "--denoiser", denoiser, *_CLI,
                       "--out-dir", str(tmp_path)])
    assert np.isfinite([result["final_val"], result["test_mse"],
                        result["test_mae"]]).all()
    assert np.isfinite(result["train_curve"]).all()
    assert (tmp_path / "result.json").exists()


def test_cli_serve_cond_diffusion_on_cpu(tmp_path):
    """Requests through the bundle equal direct calls on the same padded
    batch (the padding rows share the node encoder's step control), and a
    forecast is the same in two calls (a fixed serving generator)."""
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.serve import load_servable

    argv = ["serve", "--source", "cond_diffusion", "--device", "cpu",
            "--context_len", "12", "--pred_len", "4", "--num_features", "3",
            "--diff_t", "4", "--n_samples", "2", "--iters", "2",
            "--buckets", "4,8", "--out-dir", str(tmp_path)]
    result = cli.main(argv)
    assert result["source"] == "cond_diffusion"
    assert [row["batch"] for row in result["bench"]] == [4, 8]
    cfg = make_config("serve", cli._parse(argv)[1])
    assert cfg.denoiser == "kan_node"
    params, fn, _ = cli.SERVING["cond_diffusion"](cfg, torch.device("cpu"))
    sv = load_servable(result["bundle"], fn, params)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 12, 3)).astype(np.float32))
    with torch.no_grad():
        got = sv.predict(x)
        assert got.shape == (3, 4, 3)
        np.testing.assert_array_equal(
            got.numpy(), fn(sv.params, torch.cat([x, x[-1:]]))[:3].numpy())
        np.testing.assert_array_equal(got.numpy(), sv.predict(x).numpy())


@pytest.mark.parametrize("case", ["solver", "run_knob", "plots", "names",
                                  "no_card"])
def test_refusals(case, tmp_path):
    if case == "solver":
        # Fixed-step solvers run (tests/test_torch_fixed.py); an unknown
        # one names the choices.
        cfg = CD.NodeEncoderCfg(d_in=2, cond_dim=8, solver="rk9")
        enc = CD.node_encoder_init(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(ValueError, match="rk4"):
            CD.node_encoder_apply(enc, cfg, torch.zeros((2, 12, 2)))
    elif case == "run_knob":
        # checkpoint/resume and the AOT flag are ported: a small run
        # writes its checkpoint, and a resumed run continues from it
        ck = str(tmp_path / "ck")
        argv = ["cond_diffusion", "--device", "cpu", "--denoiser", "mlp",
                "--seq_len", "12", "--pred_len", "4", "--diff_t", "4",
                "--eval_samples", "2", "--epochs", "1", "--batch_size",
                "512", "--ckpt_dir", ck, "--ckpt_every", "1", "--aot_cache",
                str(tmp_path / "aot"), "--out-dir", str(tmp_path)]
        cli.main(argv)
        assert sorted(os.listdir(ck)) == ["ckpt_1.pt"]
        argv[argv.index("--epochs") + 1] = "2"
        cli.main(argv + ["--resume", "true"])
        assert sorted(os.listdir(ck)) == ["ckpt_1.pt", "ckpt_2.pt"]
        # the mesh is ported (tests/test_torch_mesh_drivers.py); without a
        # process group of its ranks it refuses before any work
        for kw in (dict(mesh_devices=2), dict(mesh_devices=4, mesh_model=2)):
            with pytest.raises(RuntimeError, match="process group"):
                drv.train_conditional_diffusion(
                    None, None, drv.CondDiffusionRun(device="cpu", **kw))
    elif case == "plots":
        # accepted, and nothing drawn, as in the JAX CLI
        cli.main(["cond_diffusion", "--device", "cpu", "--plots",
                  "--denoiser", "mlp", "--seq_len", "12", "--pred_len", "4",
                  "--diff_t", "4", "--eval_samples", "2", "--epochs", "1",
                  "--batch_size", "512", "--out-dir", str(tmp_path)])
        assert not any(f.endswith(".png") for f in os.listdir(tmp_path))
    elif case == "names":
        with pytest.raises(ValueError, match="unknown denoiser"):
            CD.make_denoiser_spec("kan_fet_rnn", d_in=2, pred_len=4)
        with pytest.raises(ValueError, match="unknown net"):
            CD.cond_denoiser_init(torch.Generator(), CD.CondDenoiserSpec(
                d_in=2, pred_len=4, net="rnn"))
    elif case == "no_card":
        if torch.cuda.is_available():
            pytest.skip("checks the refusal of --device cuda without CUDA")
        for argv in (["cond_diffusion"], ["serve", "--source",
                                          "cond_diffusion"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(argv + ["--out-dir", str(tmp_path)])
