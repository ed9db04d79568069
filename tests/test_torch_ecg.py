"""PyTorch port, the ECG classification slice against the JAX package: the
KanFet NODE classifiers (``models/ecg.py``: ``KanFetNODE`` with the
'plain' and the 'mlp' latent field, ``KanFetMLPNODE``) through the eager
scan solve and through their kernels' plain versions, one AdamW training
epoch of each against the JAX package's ``make_minibatch_epoch``, the
ECG200 data, AdamW against optax, the parameter conversion, the trainer,
``cli ecg`` and ``cli serve --source ecg`` on the CPU, and the refusals
of what is not ported.

Small widths, as the JAX package's kernel tests use them:
``KanFetNODESpec(T=24, latent_dim=8, num_basis=4)`` (with ``field="mlp"``
and ``ode_hidden=16``) and ``KanFetMLPNODESpec(T=24, latent_dim=8,
ode_hidden=12, num_basis=3)``, max_steps 16, rtol 1e-2 / atol 1e-3,
parameters from ``PRNGKey(0)``, inputs from a numpy seed.  Tolerances:
* logits and gradients in float64, 1e-9 (relative norm for gradients):
  one algorithm on one step mesh; the kernels' plain versions record the
  mesh and replay it, which the scan solve's autodiff (its step control
  cut from the graph) differentiates too.  ``jax.grad`` also
  differentiates the 'mlp' field's knot grids, which the port keeps as
  buffers: those leaves are zeroed before comparing;
* one training epoch (two AdamW steps with the global-norm clip) in
  float64: losses and parameters 1e-9;
* synthetic data 1e-6 (the JAX package z-normalises with its C++ runtime
  where it is built); AdamW against optax 1e-6 absolute on parameters of
  order one (float32 rounding of one update).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fetode_tpu.data import ecg200 as jdata
from fetode_tpu.models import ecg as JM
from fetode_tpu.train import ecg_driver as jdrv
from fetode_tpu.train.loop import init_state as j_init_state
from fetode_tpu.train.loop import make_minibatch_epoch as j_minibatch_epoch
from fetode_tpu.train.optim import make_optimizer as j_make_optimizer
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import (
    ecg_grads_to_numpy,
    ecg_params_from_numpy,
    ecg_params_to_numpy,
)
from fetode_tpu_torch.data import ecg200 as tdata
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.models.predprey import (
    PredPreyNODE,
    predict,
    predprey_init,
)
from fetode_tpu_torch.nn.kan import KANConfig, kan_init
from fetode_tpu_torch.ops.mlp_node import mlp_node_solve
from fetode_tpu_torch.train import ecg_driver as tdrv
from fetode_tpu_torch.train.loop import init_state, make_minibatch_epoch
from fetode_tpu_torch.train.optim import make_optimizer

SMALL = {"kanfet_node": dict(T=24, latent_dim=8, num_basis=4, max_steps=16),
         "kanfet_node_mlp": dict(T=24, latent_dim=8, num_basis=4,
                                 ode_hidden=16, field="mlp", max_steps=16),
         "kanfet_mlp_node": dict(T=24, latent_dim=8, ode_hidden=12,
                                 num_basis=3, max_steps=16)}
_KANFET_NODE = (JM.KanFetNODESpec, JM.kanfet_node_init, JM.kanfet_node_apply,
                TM.KanFetNODESpec, TM.kanfet_node_init, TM.kanfet_node_apply)
MODELS = {"kanfet_node": _KANFET_NODE, "kanfet_node_mlp": _KANFET_NODE,
          "kanfet_mlp_node": (JM.KanFetMLPNODESpec, JM.kanfet_mlp_node_init,
                              JM.kanfet_mlp_node_apply,
                              TM.KanFetMLPNODESpec, TM.kanfet_mlp_node_init,
                              TM.kanfet_mlp_node_apply)}
B, N_BATCHES, LR, WD = 8, 2, 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager solves here are many small ops: with the suite's workers
    sharing the cores, torch's intra-op thread pool oversubscribes them
    (see tests/test_torch_cond_diffusion.py).  One thread for this
    module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _zero_grids(tree):
    """``jax.grad`` also differentiates the KAN knot grids (``_buffers``),
    which the port keeps as buffers and reports zero gradients for."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if any(
            getattr(k, "key", None) == "_buffers" for k in path) else a,
        tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """One model: its JAX params, inputs, and in one program the float64
    scan gradients of sum(logits * gbar) and one AdamW epoch."""
    name = request.param
    jspec_cls, jinit, japply, tspec_cls, tinit, tapply = MODELS[name]
    jspec = jspec_cls(**SMALL[name], solver_mode="scan")
    jparams = jinit(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N_BATCHES, B, jspec.T))
    y = rng.integers(0, 2, (N_BATCHES, B)).astype(np.int32)
    gbar = rng.standard_normal((B, jspec.num_classes))
    p64 = _f64(tree)
    tx = j_make_optimizer(LR, kind="adamw", weight_decay=WD, grad_clip=1.0,
                          params=p64)

    def loss_fn(p, key, xb, yb):
        return jdrv.cross_entropy(japply(p, jspec, xb), yb)

    epoch = j_minibatch_epoch(loss_fn, tx, keyed=True)

    @jax.jit
    def run(p):
        logits, vjp = jax.vjp(lambda q: japply(q, jspec, x[0]), p)
        state, losses = epoch(j_init_state(p, tx), jax.random.PRNGKey(1),
                              (x, y))
        return logits, vjp(gbar)[0], losses, state.params

    logits, grads, losses, params1 = jax.tree_util.tree_map(np.asarray,
                                                            run(p64))
    return dict(name=name, tree=tree, x=x, y=y, gbar=gbar, logits=logits,
                grads=grads, losses=losses, params1=params1,
                spec=tspec_cls(**SMALL[name], solver_mode="scan"),
                init=tinit, apply=tapply)


def _module(m, dtype=torch.float64):
    mod = m["init"](torch.Generator().manual_seed(0), m["spec"], dtype=dtype)
    mod.load_state_dict(ecg_params_from_numpy(m["tree"], dtype=np.float64))
    return mod


@pytest.mark.parametrize("path", ["scan", "kernel_plain"])
def test_logits_and_grads_match_jax(model, path, monkeypatch):
    """float64: logits and every parameter gradient of the port's model,
    through the eager scan solve or through its kernels' plain versions
    (record the mesh, replay it under autograd), against the JAX model's
    scan solve."""
    m = model
    if path == "kernel_plain":      # the kernel path; on the CPU its plain
        monkeypatch.setattr(TM, "use_kernel", lambda spec, x: True)
    mod = _module(m)
    x = torch.from_numpy(m["x"][0])
    logits = m["apply"](mod, m["spec"], x)
    torch.sum(logits * torch.from_numpy(m["gbar"])).backward()
    np.testing.assert_allclose(logits.detach().numpy(), m["logits"],
                               rtol=1e-9, atol=1e-12)
    got = ecg_grads_to_numpy(mod, np.float64)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(m["grads"]))
    assert _rel(_flat(got), _flat(_zero_grids(m["grads"]))) < 1e-9


def test_training_epoch_matches_jax(model):
    """float64: two AdamW steps (weight decay, global-norm clip 1.0) on the
    same minibatches: the losses and the parameters after them equal the
    JAX package's keyed ``make_minibatch_epoch``."""
    m = model
    mod = _module(m)
    opt = make_optimizer(LR, params=mod.parameters(), kind="adamw",
                         weight_decay=WD, grad_clip=1.0)

    def loss_fn(p, generator, xb, yb):
        return tdrv.cross_entropy(m["apply"](p, m["spec"], xb), yb)

    epoch = make_minibatch_epoch(loss_fn, keyed=True)
    state, losses = epoch(init_state(mod, opt), (0, 0),
                          (torch.from_numpy(m["x"]),
                           torch.from_numpy(m["y"]).long()))
    np.testing.assert_allclose(losses.detach().numpy(), m["losses"],
                               rtol=1e-9)
    got = ecg_params_to_numpy(state.params, np.float64)
    assert _rel(_flat(got), _flat(m["params1"])) < 1e-9
    moved = _flat(got) - _flat(m["tree"])
    assert np.abs(moved).max() > 1e-4          # the update did something


def test_convert_round_trip(model):
    m = model
    mod = _module(m, torch.float32)
    back = ecg_params_to_numpy(mod)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(m["tree"]))
    np.testing.assert_array_equal(_flat(back), _flat(m["tree"]))


def test_adamw_matches_optax():
    """Three AdamW steps with the global-norm clip, from the same numpy
    gradients (the first two clipped)."""
    rng = np.random.default_rng(5)
    shapes = {"w": (4, 6), "b": (6,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for scale in (2.0, 1.0, 1e-3)]
    tx = j_make_optimizer(3e-3, kind="adamw", weight_decay=0.1,
                          grad_clip=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(3e-3, params=tp.values(), kind="adamw",
                         weight_decay=0.1, grad_clip=1.0)
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


def test_synthetic_data_matches_jax():
    got = tdata.synthetic_ecg200(seed=3)
    want = jdata.synthetic_ecg200(seed=3)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    x_tr, y_tr, x_te, y_te = got
    assert x_tr.shape == (64, 96) and x_te.shape == (32, 96)
    assert set(np.unique(y_tr)) == {0, 1}


@pytest.mark.parametrize("n", [0, 1, 2, 10, 97, 1297])
def test_shuffle_is_the_native_runtimes(n):
    """``data/batching.py: shuffled_indices`` is the JAX package's native
    splitmix64 Fisher-Yates (``native/fetode_native.cpp: fet_shuffle``),
    bit for bit, seed 0 read as 1 (ROADMAP C, F7)."""
    from fetode_tpu.data import native
    from fetode_tpu_torch.data.batching import shuffled_indices

    assert native.available()
    for seed in (0, 1, 7, 123456789, 2 ** 40 + 3):
        got = shuffled_indices(n, seed)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, native.shuffled_indices(n, seed))
    if n == 10:
        np.testing.assert_array_equal(shuffled_indices(10, 0),
                                      [4, 2, 8, 1, 9, 3, 0, 6, 7, 5])
        np.testing.assert_array_equal(shuffled_indices(10, 0),
                                      shuffled_indices(10, 1))


@pytest.mark.parametrize("shape", [(100, 96), (8, 30), (5, 7), (3, 1)])
def test_znorm_is_the_native_runtimes(shape):
    """``znorm_rows`` is ``fet_znorm_rows`` bit for bit: float64 sums in
    row order, the scale and quotient in float32 (ROADMAP C, F7)."""
    from fetode_tpu.data import native

    for seed in range(3):
        x = (3.0 * np.random.default_rng(seed).standard_normal(shape)
             + 1.0).astype(np.float32)
        got = tdata.znorm_rows(x)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, native.znorm_rows(x))


def test_load_ecg200_matches_jax(tmp_path, monkeypatch):
    """Files in the UCR layout (label in column 0): the same series, labels
    remapped to 0..C-1 across both splits; without files it raises."""
    rng = np.random.default_rng(6)
    paths = []
    for name, n in (("ECG200_TRAIN.txt", 6), ("ECG200_TEST.txt", 4)):
        rows = np.concatenate([rng.choice([-1.0, 1.0], (n, 1)),
                               rng.standard_normal((n, 10))], axis=1)
        np.savetxt(tmp_path / name, rows)
        paths.append(str(tmp_path / name))
    got = tdata.load_ecg200(*paths)
    want = jdata.load_ecg200(*paths)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert set(np.unique(got[1])) <= {0, 1}
    monkeypatch.setattr(tdata, "locate", lambda relpath: None)
    with pytest.raises(FileNotFoundError):
        tdata.load_ecg200()


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator(drop_last):
    x = np.arange(20 * 3, dtype=np.float32).reshape(20, 3)
    y = np.arange(20, dtype=np.int32)
    bx, by = tdata.batch_iterator(x, y, 8, seed=2, drop_last=drop_last)
    nb = 2 if drop_last else 3
    assert bx.shape == (nb, 8, 3) and by.shape == (nb, 8)
    np.testing.assert_array_equal(bx[..., 0], 3 * by)  # rows stay paired
    flat = by.reshape(-1)
    assert len(set(flat[:16].tolist())) == 16
    if not drop_last:                 # the short batch wraps around
        np.testing.assert_array_equal(flat[20:], flat[:4])
    again, _ = tdata.batch_iterator(x, y, 8, seed=2, drop_last=drop_last)
    np.testing.assert_array_equal(bx, again)


def test_epochs_scanner_draws_as_single_epochs():
    """Keyed, a block of epochs takes the same steps, with the same
    per-step generators, as the epochs run one at a time."""
    from fetode_tpu_torch.train.loop import make_minibatch_epochs_scanner

    def loss_fn(p, generator, xb):
        noise = torch.randn(xb.shape, generator=generator)
        return ((p.weight * (xb + noise)).sum() - 1.0) ** 2

    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 3, 4, 5)).astype(np.float32))         # (epochs, batches, B, 5)

    def fresh():
        p = torch.nn.Linear(5, 1, bias=False)
        with torch.no_grad():
            p.weight.fill_(0.1)
        return init_state(p, make_optimizer(1e-2, params=p.parameters(),
                                            kind="adamw", weight_decay=0.1))

    block, block_losses = make_minibatch_epochs_scanner(
        loss_fn, keyed=True)(fresh(), (5, 10), (x,))
    single = fresh()
    epoch = make_minibatch_epoch(loss_fn, keyed=True)
    single_losses = []
    for e in range(2):
        single, losses = epoch(single, (5, 10 + e), (x[e],))
        single_losses.append(losses)
    assert block_losses.shape == (2, 3)
    torch.testing.assert_close(block_losses, torch.stack(single_losses),
                               rtol=0, atol=0)
    torch.testing.assert_close(block.params.weight, single.params.weight,
                               rtol=0, atol=0)


def test_chunked_logits_pad_with_the_last_row():
    calls = []

    def apply_i(xc, i):
        calls.append(xc.shape[0])
        return xc[:, :2] * (i + 1)

    x = torch.arange(14.0).reshape(7, 2)
    got = tdrv._chunked_logits(apply_i, x, 2, 3)
    torch.testing.assert_close(got, 1.5 * x)
    assert calls == [3, 3, 3, 3, 3, 3]
    np.testing.assert_array_equal(
        tdrv._chunked_logits(apply_i, x, 1, 0).numpy(), x.numpy())


def test_train_ecg_model_history_and_best(tmp_path):
    """The trainer's history has the JAX package's keys, keeps the best
    test accuracy's parameters and logs on the JAX rule."""
    spec = TM.KanFetNODESpec(**SMALL["kanfet_node"])
    data = tdata.synthetic_ecg200(n_train=16, n_test=8, T=spec.T)
    logs = []
    params, hist = tdrv.train_ecg_model(
        lambda g: TM.kanfet_node_init(g, spec),
        lambda p, x, g: TM.kanfet_node_apply(p, spec, x), data,
        tdrv.ECGRun(epochs=3, epochs_per_call=2, log_every=2, device="cpu"),
        log=logs.append)
    assert set(hist) == {"loss", "train_acc", "test_acc", "wall_seconds",
                         "best_test_acc"}
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert hist["best_test_acc"] == max(hist["test_acc"])
    assert [line.split("|")[0].strip() for line in logs] == ["epoch   1",
                                                             "epoch   2"]
    assert isinstance(params, TM.KanFetNODEParams)


@pytest.mark.parametrize("model_name", ["kanfet_node", "kanfet_mlp_node",
                                        "kanfet_node_mlp"])
def test_cli_ecg_on_cpu(model_name, tmp_path):
    argv = ["ecg", "--device", "cpu", "--epochs", "2", "--latent_dim", "8",
            "--num_basis", "3", "--out-dir", str(tmp_path)]
    if model_name == "kanfet_node_mlp":
        argv += ["--model", "kanfet_node", "--field", "mlp"]
    else:
        argv += ["--model", model_name]
    if model_name == "kanfet_mlp_node":
        argv += ["--noise_std", "0.2"]
    result = cli.main(argv)
    assert len(result["test_acc_curve"]) == 2
    assert np.isfinite(result["loss_curve"]).all()
    assert 0.0 <= result["best_test_acc"] <= 1.0


def _serve_ecg_on_cpu(tmp_path, extra):
    """``serve`` with the default source (ecg): bundle export, load, bench;
    requests through the bundle equal direct calls on the same padded
    batch (the padding rows share the batch's step control)."""
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.serve import load_servable

    argv = ["serve", "--device", "cpu", "--latent_dim", "8", "--num_basis",
            "3", "--iters", "2", "--buckets", "4,8", "--out-dir",
            str(tmp_path), *extra]
    result = cli.main(argv)
    assert result["source"] == "ecg"
    assert [row["batch"] for row in result["bench"]] == [4, 8]
    cfg = make_config("serve", cli._parse(argv)[1])
    params, fn, _ = cli.ecg_serving(cfg, torch.device("cpu"))
    sv = load_servable(result["bundle"], fn, params)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, cfg.t_len)).astype(np.float32))
    padded = torch.cat([x, x[-1:].expand(1, cfg.t_len)])
    with torch.no_grad():
        served = sv.predict(x)
        np.testing.assert_array_equal(served.numpy(),
                                      fn(sv.params, padded)[:3].numpy())
    return params, served


def test_cli_serve_ecg_on_cpu(tmp_path):
    _serve_ecg_on_cpu(tmp_path, [])


def test_cli_serve_ecg_mlp_field_on_cpu(tmp_path):
    """``serve --source ecg --field mlp``: finite logits of the right shape
    from the 'mlp' field's parameters."""
    params, served = _serve_ecg_on_cpu(tmp_path, ["--source", "ecg",
                                                  "--field", "mlp"])
    assert hasattr(params, "kan") and not hasattr(params, "proj_w")
    assert served.shape == (3, 2) and torch.isfinite(served).all()


@pytest.mark.parametrize("case", ["mlp_field", "fixed_step", "rnn_model",
                                  "plots", "serve_source", "run_knob"])
def test_refusals(case, tmp_path):
    spec = TM.KanFetNODESpec(**SMALL["kanfet_node"])
    if case == "mlp_field":
        # An unknown field, and a KAN other than the init-time one of
        # KanFetNODESpec.kan_cfg on the kernel path (grid refinement, A.2).
        with pytest.raises(ValueError, match="field"):
            TM.kanfet_node_init(torch.Generator(), spec._replace(field="x"))
        params = TM.kanfet_node_init(torch.Generator(), spec)
        with pytest.raises(ValueError, match="field"):
            TM.kanfet_node_apply(params, spec._replace(field="x"),
                                 torch.zeros(2, spec.T))
        mspec = TM.KanFetNODESpec(**SMALL["kanfet_node_mlp"])
        params = TM.kanfet_node_init(torch.Generator(), mspec)
        params.kan = kan_init(torch.Generator(), KANConfig.make(
            [32, 16, 16], grid_size=7))
        with pytest.raises(NotImplementedError, match="grid refit"):
            mlp_node_solve(params, torch.zeros(2, 8), mspec)
    elif case == "fixed_step":
        # The ECG models take the fixed-step solvers (tests/
        # test_torch_fixed.py), and so does predprey: its rk4 solve
        # against the JAX package's on the same parameters.
        from fetode_tpu.models import predprey as jpp
        from fetode_tpu_torch.convert import params_to_numpy

        pspec = PredPreyNODE.kanfet(layers_hidden=(2, 3, 2), method="rk4")
        params = predprey_init(torch.Generator().manual_seed(0), pspec)
        with torch.no_grad():
            got = predict(params, pspec, torch.ones(2),
                          torch.linspace(0, 1, 3))
        want = jpp.predict(params_to_numpy(params), jpp.PredPreyNODE.kanfet(
            layers_hidden=(2, 3, 2), method="rk4"), jnp.ones(2, jnp.float32),
            jnp.linspace(0, 1, 3, dtype=jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    elif case == "rnn_model":
        # The RNN models, 'all' (tests/test_torch_rnn.py) and the noise
        # study (tests/test_torch_population.py) are ported; an unknown
        # model is refused.
        with pytest.raises(SystemExit, match="unknown ECG model"):
            cli.main(["ecg", "--device", "cpu", "--model", "no_such_model",
                      "--out-dir", str(tmp_path)])
    elif case == "plots":
        # ported: the loss curve (kanfet_node has no ferro layer to loop)
        cli.main(["ecg", "--device", "cpu", "--plots", "--epochs", "1",
                  "--latent_dim", "8", "--num_basis", "3", "--out-dir",
                  str(tmp_path)])
        assert sorted(p.name for p in tmp_path.rglob("*.png")) == \
            ["loss.png"]
    elif case == "serve_source":
        with pytest.raises(ValueError, match="unknown serve source"):
            cli.main(["serve", "--source", "no_such_source", "--device",
                      "cpu", "--out-dir", str(tmp_path)])
    elif case == "run_knob":
        # the mesh is ported (tests/test_torch_mesh_drivers.py); without a
        # process group of its ranks it refuses before any work
        for kw in (dict(mesh_devices=2), dict(mesh_devices=4, mesh_model=2)):
            with pytest.raises(RuntimeError, match="process group"):
                tdrv.train_ecg_model(None, None, None, tdrv.ECGRun(
                    device="cpu", **kw))


@pytest.mark.cuda
def test_ecg_training_on_card_launches_the_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.ops import ferro_node as FN
    from fetode_tpu_torch.ops import logistic_node as LN
    from fetode_tpu_torch.ops import mlp_node as MN

    for argv, kernels in (
            (["--model", "kanfet_node"],
             (LN.logistic_node_fwd, LN.logistic_node_bwd)),
            (["--model", "kanfet_node", "--field", "mlp"],
             (MN.mlp_node_fwd, MN.mlp_node_bwd)),
            (["--model", "kanfet_mlp_node"],
             (FN.ferro_node_fwd, FN.ferro_node_bwd))):
        for k in kernels:
            k.launches = 0
        result = cli.main(["ecg", "--device", "cuda", "--solver_mode",
                           "pallas", "--epochs", "1", *argv,
                           "--out-dir", str(tmp_path)])
        assert np.isfinite(result["loss_curve"]).all()
        assert all(k.launches > 0 for k in kernels)
