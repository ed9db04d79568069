"""PyTorch port, the predprey training path against the JAX package: the
differentiable eager solve (``odeint_dopri5`` in scan mode) through
``trajectory_loss``, the discrete adjoint against it, the optimiser
against optax, the KAN regulariser, the two drivers and the ``predprey``
CLI workload, and the refusals of what is not ported.

The scan comparison uses the config of ``tests/test_pallas_adjoint.py``
(flagship KANFET [2,10,2], params from ``PRNGKey(0)``, rtol 1e-4 / atol
1e-6, max_steps 64, the first 12 fit times, x0 = (1, 1)).  The JAX scan
runs with ``solver_unroll=1`` and ``solver_checkpoint=False``: both are
TPU performance knobs (the port accepts and ignores them) and these
values compile fastest.  Tolerances:
* scan value and gradients, 1e-8 in float64 (relative norm for the
  gradients): the error estimate is far above rounding, so both take the
  same steps.  The port's float32 solve against that: value 1e-4,
  gradients 1e-3.  In float32 the first attempt's error estimate is about
  5e-6 of the tolerance, at rounding, so the step meshes of two
  frameworks part after it (1.8e-4 measured).  The knot grid is a
  buffer, so the grid entries of ``jax.grad`` are zeroed, as in
  ``tests/test_pallas_adjoint.py``;
* discrete adjoint against scan, cosine > 0.999 (the JAX test's bound,
  ``tests/test_pallas_adjoint.py:140-158``);
* optimiser, 1e-6 absolute on parameters of order one: float32 rounding
  of the same update.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu.nn.kan import kan_regularization as j_kan_regularization
from fetode_tpu.train.optim import make_optimizer as j_make_optimizer
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import (
    grads_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn.kan import KAN, kan_regularization
from fetode_tpu_torch.ops import kanfet_adjoint as KA
from fetode_tpu_torch.train import loop
from fetode_tpu_torch.train.optim import cosine_decay_schedule, make_optimizer
from fetode_tpu_torch.train.checkpoint import CheckpointManager
from fetode_tpu_torch.train.predprey_driver import (
    PredPreyRun,
    train_predprey,
)
from fetode_tpu_torch.train.traj_driver import (
    TrajParallelRun,
    make_batched_data,
    train_traj_parallel,
)

RTOL, ATOL, MAX_STEPS = 1e-4, 1e-6, 64
# A fast spec for the driver runs (a few epochs, loose tolerance).
FAST = dict(max_steps=32, rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    task = jpp.PredPreyTask()
    _, ts_learn, truth = jpp.generate_data(task)
    ts = np.asarray(ts_learn[:12], np.float32)
    target = np.asarray(truth[:12], np.float32)
    jspec = jpp.PredPreyNODE.kanfet(max_steps=MAX_STEPS, rtol=RTOL,
                                    atol=ATOL, solver_mode="scan",
                                    solver_unroll=1, solver_checkpoint=False)
    jparams = jpp.predprey_init(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    x0 = np.asarray([1.0, 1.0], np.float32)
    f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: jpp.trajectory_loss(p, jspec, f64(x0), f64(ts),
                                      f64(target))))(
        jax.tree_util.tree_map(f64, jparams))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    for layer in grads:   # jax.grad differentiates the grid; it is a buffer
        layer["_buffers"]["grid"] = np.zeros_like(layer["_buffers"]["grid"])
    spec = tpp.PredPreyNODE.kanfet(max_steps=MAX_STEPS, rtol=RTOL, atol=ATOL)
    return dict(tree=tree, spec=spec, ts=ts, target=target, x0=x0,
                value=float(value), grads=grads)


@pytest.fixture(scope="module")
def jax_history_keys():
    """The history keys of the JAX drivers, from a run of each with no
    epochs (the keys do not depend on them).  The single-trajectory driver
    still makes its warm call, so its epoch program is swapped for a stub
    that compiles nothing."""
    from fetode_tpu.train import predprey_driver as jdrv
    from fetode_tpu.train.traj_driver import TrajParallelRun as JTraj
    from fetode_tpu.train.traj_driver import train_traj_parallel as j_traj

    def stub_scanner(loss_fn, tx, n):
        return lambda state, *batch: (state, jnp.zeros((n,)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdrv, "make_epoch_scanner", stub_scanner)
        _, h1 = jdrv.train_predprey(jdrv.PredPreyRun(
            epochs=0, epochs_per_call=1, eval_every_call=False,
            cosine_decay=False), log=None)
    _, h2 = j_traj(JTraj(n_traj=2, epochs=0, epochs_per_call=1,
                         cosine_decay=False), log=None)
    return set(h1), set(h2)


def _model(s, dtype=torch.float32):
    model = KAN(s["spec"].kan, dtype=dtype)
    model.load_state_dict(params_from_numpy(s["tree"]))
    return model


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(
        tree)])


def _port_loss_grads(s, spec, dtype=torch.float32):
    model = _model(s, dtype)
    arg = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    loss = tpp.trajectory_loss(model, spec, arg(s["x0"]), arg(s["ts"]),
                               arg(s["target"]))
    loss.backward()
    return float(loss), _flat(grads_to_numpy(model, np.float64))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_scan_trajectory_loss_matches_jax(setup, dtype):
    s = setup
    value, g = _port_loss_grads(s, s["spec"]._replace(solver_mode="scan"),
                                dtype)
    want = _flat(s["grads"])
    if dtype == torch.float64:
        np.testing.assert_allclose(value, s["value"], rtol=1e-8)
        assert _rel(g, want) < 1e-8
    else:
        np.testing.assert_allclose(value, s["value"], rtol=1e-4)
        assert _rel(g, want) < 1e-3


def test_auto_on_cpu_under_autograd_is_scan(setup):
    s = setup
    auto = _port_loss_grads(s, s["spec"]._replace(solver_mode="auto"))
    scan = _port_loss_grads(s, s["spec"]._replace(solver_mode="scan"))
    assert auto[0] == scan[0]
    np.testing.assert_array_equal(auto[1], scan[1])


def test_discrete_adjoint_close_to_scan(setup):
    """The discrete adjoint (the plain version of the kernels, its own
    mesh) against the JAX scan-mode gradient."""
    s = setup
    model = _model(s)
    out = KA.kanfet_solve_train(model, s["spec"].kan,
                                torch.from_numpy(s["x0"])[None],
                                torch.from_numpy(s["ts"]), rtol=RTOL,
                                atol=ATOL, max_steps=MAX_STEPS)
    torch.mean((out[0] - torch.from_numpy(s["target"])) ** 2).backward()
    g, want = _flat(grads_to_numpy(model)), _flat(s["grads"])
    cos = float(g @ want / (np.linalg.norm(g) * np.linalg.norm(want)))
    assert cos > 0.999


def test_cosine_schedule_matches_optax():
    sched = cosine_decay_schedule(2e-3, 10, alpha=0.05)
    want = optax.cosine_decay_schedule(2e-3, 10, alpha=0.05)
    for count in range(14):
        np.testing.assert_allclose(sched(count), float(want(count)),
                                   rtol=1e-6)


def test_optimizer_matches_optax(setup):
    """Three Adam + global-norm clip + cosine steps from the same numpy
    gradients; the first two are clipped, the third is not."""
    s = setup
    jparams = jax.tree_util.tree_map(jnp.asarray, s["tree"])
    rng = np.random.default_rng(3)
    grad_trees = []
    for scale in (3.0, 1.5, 1e-3):
        g = jax.tree_util.tree_map(
            lambda a: (scale * rng.standard_normal(a.shape)
                       / np.sqrt(a.size * 16)).astype(np.float32), s["tree"])
        for layer in g:                 # the grid is not trained
            layer["_buffers"]["grid"] = np.zeros_like(
                layer["_buffers"]["grid"])
        grad_trees.append(g)
    norms = [np.linalg.norm(_flat(g)) for g in grad_trees]
    assert norms[0] > 1.0 and norms[1] > 1.0 and norms[2] < 1.0

    tx = j_make_optimizer(optax.cosine_decay_schedule(2e-3, 10, alpha=0.05),
                          kind="adam", grad_clip=1.0, params=jparams)
    opt_state = tx.init(jparams)
    model = _model(s)
    opt = make_optimizer(cosine_decay_schedule(2e-3, 10, alpha=0.05),
                         params=model.parameters(), kind="adam",
                         grad_clip=1.0)
    for g in grad_trees:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = params_from_numpy(g)
        for name, p in model.named_parameters():
            p.grad = grads[name].clone()
        opt.step()
    assert opt.count == 3
    np.testing.assert_allclose(_flat(params_to_numpy(model)),
                               _flat(jax.tree_util.tree_map(np.asarray,
                                                            jparams)),
                               rtol=0, atol=1e-6)


def test_kan_regularization_matches_jax(setup):
    s = setup
    spec = jpp.PredPreyNODE.kanfet()
    jparams = jax.tree_util.tree_map(jnp.asarray, s["tree"])
    value, grads = jax.value_and_grad(
        lambda p: j_kan_regularization(p, spec.kan))(jparams)
    model = _model(s)
    reg = kan_regularization(model)
    reg.backward()
    np.testing.assert_allclose(float(reg), float(value), rtol=1e-5)
    np.testing.assert_allclose(_flat(grads_to_numpy(model)),
                               _flat(jax.tree_util.tree_map(np.asarray,
                                                            grads)),
                               rtol=1e-4, atol=1e-6)


def test_epoch_scanner_steps_in_place():
    model = torch.nn.Linear(2, 1)
    with torch.no_grad():
        model.weight.copy_(torch.tensor([[1.0, -2.0]]))
        model.bias.fill_(0.5)
    opt = make_optimizer(0.1, params=model.parameters())
    state = loop.init_state(model, opt)
    x, y = torch.ones(4, 2), torch.zeros(4, 1)
    run = loop.make_epoch_scanner(
        lambda p, a, b: torch.mean((p(a) - b) ** 2), 5)
    state2, losses = run(state, x, y)
    assert state2 is state and state.step == 5
    assert losses.shape == (5,) and losses[-1] < losses[0]


def test_make_batched_data():
    run = TrajParallelRun(n_traj=5, device="cpu")
    ts, x0s, targets = make_batched_data(run)
    assert ts.shape == (35,) and x0s.shape == (5, 2)
    assert targets.shape == (5, 35, 2)
    np.testing.assert_array_equal(x0s[0].numpy(), [1.0, 1.0])  # canonical
    assert ((x0s[1:] >= 0.5) & (x0s[1:] < 2.0)).all()
    np.testing.assert_array_equal(targets[:, 0].numpy(), x0s.numpy())
    again = make_batched_data(run)[1]
    np.testing.assert_array_equal(again.numpy(), x0s.numpy())   # seeded


def test_traj_driver_trains_on_cpu(jax_history_keys):
    spec = tpp.PredPreyNODE.kanfet(**FAST)
    params, hist = train_traj_parallel(TrajParallelRun(
        spec=spec, n_traj=4, epochs=6, epochs_per_call=2, device="cpu"),
        log=None)
    assert set(hist) == jax_history_keys[1]
    assert np.isfinite(hist["train"]).all()
    assert hist["train"][-1] < hist["train"][0]
    assert hist["epoch"] == [2, 4, 6]
    assert isinstance(params, KAN)


def test_predprey_driver_trains_on_cpu(jax_history_keys):
    spec = tpp.PredPreyNODE.kanfet(**FAST)
    params, hist = train_predprey(PredPreyRun(
        spec=spec, epochs=6, epochs_per_call=2, val_points=5,
        reg_lambda=1e-3, device="cpu"), log=None)
    assert set(hist) == jax_history_keys[0]
    assert np.isfinite(hist["train"] + hist["test"] + hist["val"]).all()
    assert hist["train"][-1] < hist["train"][0]
    assert hist["epoch"] == [2, 4, 6] and hist["budget"] == [32] * 3
    assert len(hist["test"]) == len(hist["val"]) == 3
    assert isinstance(params, KAN)


def test_predprey_driver_keeps_init_params():
    spec = tpp.PredPreyNODE.kanfet(**FAST)
    init = tpp.predprey_init(torch.Generator().manual_seed(5), spec)
    before = {k: v.clone() for k, v in init.state_dict().items()}
    params, _ = train_predprey(PredPreyRun(
        spec=spec, epochs=2, epochs_per_call=1, init_params=init,
        eval_every_call=False, device="cpu"), log=None)
    for k, v in init.state_dict().items():
        assert torch.equal(v, before[k])          # a warm start is copied
    assert not torch.equal(params.layers[0].base_weight,
                           init.layers[0].base_weight)


def test_cli_predprey_on_cpu(tmp_path):
    result = cli.main(["predprey", "--device", "cpu", "--epochs", "4",
                       "--epochs_per_call", "2", "--max_steps", "32",
                       "--rtol", "1e-3", "--atol", "1e-5",
                       "--out-dir", str(tmp_path)])
    assert set(result) == {"epochs_per_sec", "final_train"}
    assert np.isfinite(result["final_train"]) and result["epochs_per_sec"] > 0
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 4]
    assert json.loads((tmp_path / "result.json").read_text()) == result


# The knobs that raised NotImplementedError until the step-budget ladder,
# shooting, anchoring, the grid refit, checkpoints and the AOT flag were
# ported; each now runs, or raises the JAX driver's ValueError.
_JAX_KNOBS = ("aot_cache", "anchor_cycles", "budget_headroom", "ckpt_dir",
              "ckpt_every", "dense_anchor", "grid_update_every",
              "jitter_anchor", "phase_anchor_periods", "resume",
              "select_anchor_k", "shooting_devices", "shooting_points",
              "step_budget_schedule")
_JAX_VALUE_ERRORS = {"jitter_anchor": "requires dense_anchor",
                     "shooting_devices": "requires shooting_points"}


@pytest.mark.parametrize("knob", _JAX_KNOBS)
def test_unported_predprey_knobs_raise(knob):
    default = {f.name: f.default for f in dataclasses.fields(PredPreyRun)}
    value = {bool: True, int: 2, float: 0.5, str: "x",
             tuple: (1,)}[type(default[knob])]
    run = PredPreyRun(device="cpu", epochs=2, epochs_per_call=1,
                      eval_every_call=False,
                      spec=tpp.PredPreyNODE.kanfet(**FAST), **{knob: value})
    if knob in _JAX_VALUE_ERRORS:
        with pytest.raises(ValueError, match=_JAX_VALUE_ERRORS[knob]):
            train_predprey(run, log=None)
        return
    logs = []
    _, hist = train_predprey(run, log=logs.append)
    assert hist["epoch"] == [1, 2] and np.isfinite(hist["train"]).all()
    if knob == "aot_cache":
        assert any("aot_cache" in m for m in logs)


@pytest.mark.parametrize("case", ["traj_mesh", "optimizer", "plots",
                                  "cli_ckpt", "pallas_cpu", "cuda"])
def test_refusals(case, tmp_path):
    if case == "traj_mesh":
        # the mesh is ported (tests/test_torch_mesh_drivers.py); without a
        # process group of its ranks it refuses
        with pytest.raises(RuntimeError, match="process group"):
            train_traj_parallel(TrajParallelRun(n_devices=2, device="cpu"))
    elif case == "optimizer":
        with pytest.raises(ValueError, match="unknown optimiser"):
            make_optimizer(1e-3, params=[], kind="lion")
    elif case == "plots":
        # ported: the JAX CLI's trajectory and loss plots
        cli.main(["predprey", "--device", "cpu", "--plots", "--epochs", "2",
                  "--epochs_per_call", "1", "--rtol", "1e-3", "--atol",
                  "1e-5", "--max_steps", "32", "--out-dir", str(tmp_path)])
        assert sorted(p.name for p in tmp_path.glob("*.png")) == \
            ["loss.png", "trajectory.png"]
    elif case == "cli_ckpt":
        # checkpoint/resume is ported: the CLI's flags reach the trainer
        ck = str(tmp_path / "ck")
        cli.main(["predprey", "--device", "cpu", "--ckpt_dir", ck,
                  "--ckpt_every", "1", "--epochs", "2", "--epochs_per_call",
                  "1", "--rtol", "1e-3", "--atol", "1e-5", "--max_steps",
                  "32", "--out-dir", str(tmp_path)])
        assert CheckpointManager(ck).all_steps() == [1, 2]
    elif case == "pallas_cpu":
        # the kernels take CUDA tensors; under autograd too
        spec = tpp.PredPreyNODE.kanfet(solver_mode="pallas")
        model = tpp.predprey_init(torch.Generator().manual_seed(0), spec)
        with pytest.raises(ValueError, match="CUDA"):
            tpp.trajectory_loss(model, spec, torch.ones(2),
                                torch.linspace(0, 1, 5), torch.ones(5, 2))
    else:
        if torch.cuda.is_available():
            pytest.skip("checks the refusal of --device cuda without CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["predprey", "--out-dir", str(tmp_path)])


@pytest.mark.cuda
def test_training_on_card_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for f in (KA.kanfet_adjoint_fwd, KA.kanfet_adjoint_bwd):
        f.launches = 0
    _, hist = train_traj_parallel(TrajParallelRun(
        n_traj=16, epochs=4, epochs_per_call=2,
        spec=tpp.PredPreyNODE.kanfet(solver_mode="pallas")), log=None)
    assert KA.kanfet_adjoint_fwd.launches == 4
    assert KA.kanfet_adjoint_bwd.launches == 4
    assert np.isfinite(hist["train"]).all()
