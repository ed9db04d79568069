"""PyTorch port, the rest of the predprey driver against the JAX package:
the step-budget ladder, the period estimate, the fit construction of
anchored, dense, jittered and shooting runs, the shooting loss and
gradient, kill-and-resume, and the twin of
``examples/01_predprey_train_loop.py``.  The per-row times behind
shooting are held in ``tests/test_torch_per_row_times.py``.

The JAX driver is never trained here: its fit construction is captured by
replacing the name ``make_epoch_scanner`` in
``fetode_tpu.train.predprey_driver`` with a recorder that keeps each
call's loss function and fit arguments and returns the state unchanged
(no JAX file changes).  The port builds the same problem with
``train/predprey_driver.py: fit_problem``.

Tolerances:
* fit times 1e-6 and targets 1e-5, relative: float32 linspaces and two
  tight-tolerance ground-truth solves (the JAX package's and the port's
  dopri5 at rtol 1e-8) that part at float32 rounding; the budgets, the
  ladder and the segment index exactly;
* the period estimate 1e-6 relative (a grid point of the same 4,001-point
  grid, read in float32);
* the shooting loss 1e-8 and its gradient 1e-7 (relative norm) in
  float64: one algorithm per segment, the error estimate far above
  rounding, so both take the same steps (``jax.grad``'s knot-grid leaves
  are zeroed, as the port keeps the grid as a buffer);
* the example's epoch-0 loss 1e-4 and first gradient 1e-3 in float32, as
  ``tests/test_torch_train.py`` holds the float32 scan solve: at rtol
  1e-7 the first attempt's error estimate sits at rounding, and the two
  frameworks' step meshes part after it;
* kill-and-resume: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu.train import predprey_driver as jdrv
from fetode_tpu_torch.convert import grads_to_numpy, params_from_numpy
from fetode_tpu_torch.examples import predprey_train_loop as example
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn import kan as tkan
from fetode_tpu_torch.train import predprey_driver as tdrv


@pytest.fixture(autouse=True)
def _one_thread():
    # The eager CPU paths under the suite's xdist workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _to_port(jtree, spec, dtype):
    """A JAX KAN parameter list -> the port's KAN in ``dtype``, bits
    kept."""
    kan = tkan.KAN(spec.kan, dtype=dtype)
    kan.load_state_dict(params_from_numpy(jtree, dtype=dtype))
    return kan


def _flat_jax_grads(g):
    """``jax.grad``'s tree, knot grids zeroed, flattened in the port's
    ``grads_to_numpy`` order."""
    out = []
    for layer in g:
        for name in sorted(layer):
            v = layer[name]
            if name == "_buffers":
                out.append(np.zeros_like(np.asarray(v["grid"])))
            elif isinstance(v, dict):
                out += [np.asarray(v[k]) for k in sorted(v)]
            else:
                out.append(np.asarray(v))
    return np.concatenate([a.ravel() for a in out])


def _flat_port_grads(kan):
    out = []
    for layer in grads_to_numpy(kan, np.float64):
        for name in sorted(layer):
            v = layer[name]
            if name == "_buffers":
                out.append(v["grid"])
            elif isinstance(v, dict):
                out += [v[k] for k in sorted(v)]
            else:
                out.append(v)
    return np.concatenate([a.ravel() for a in out])


def _capture(monkeypatch, **kw):
    """Run the JAX driver for two calls with a recording scanner: the
    (loss function, fit arguments) of the warm call and of each call."""
    calls = []

    def recorder(loss_fn, tx, n):
        def scan(state, *args):
            calls.append((loss_fn, args))
            return state, jnp.zeros((n,))
        return scan

    monkeypatch.setattr(jdrv, "make_epoch_scanner", recorder)
    jdrv.train_predprey(jdrv.PredPreyRun(eval_every_call=False, epochs=2,
                                         epochs_per_call=1, **kw), log=None)
    return calls


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _port_fit(**kw):
    run = tdrv.PredPreyRun(device="cpu", **kw)
    ts, ts_learn, truth = tpp.generate_data(run.task, dtype=run.dtype)
    x0 = torch.tensor([run.task.x0, run.task.y0], dtype=run.dtype)
    return run, tdrv.fit_problem(run, x0, ts, ts_learn,
                                 truth[:run.task.n_train])


@pytest.mark.parametrize("max_steps", [16, 32, 64, 100, 128, 256, 1024, 3072])
def test_budget_ladder_matches_jax(max_steps):
    assert tdrv._budget_ladder(max_steps) == jdrv._budget_ladder(max_steps)


def test_estimate_period_matches_jax():
    task = tpp.PredPreyTask()
    got = tdrv._estimate_period(task, torch.float32)
    want = jdrv._estimate_period(jpp.PredPreyTask(), jnp.float32)
    assert abs(got - want) <= 1e-6 * want and 3.3 < got < 3.35
    with pytest.raises(ValueError, match="full period"):
        tdrv._estimate_period(task._replace(tf_learn=1.2), torch.float32)


@pytest.mark.parametrize("kw", [
    dict(phase_anchor_periods=2), dict(anchor_cycles=(1, 2), val_points=5),
    dict(dense_anchor=2), dict(dense_anchor=3, jitter_anchor=True,
                               phase_anchor_periods=1),
    dict(shooting_points=3), dict(shooting_points=18,
                                  consistent_time_base=True)],
    ids=["phase_anchor", "anchor_cycles", "dense", "jitter", "shoot3",
         "shoot18"])
def test_fit_construction_matches_jax(kw, monkeypatch):
    calls = _capture(monkeypatch, **kw)
    run, fit = _port_fit(**kw)
    # the warm call's arguments, then (jitter) the two calls' draws
    draws = ([fit.fit_args] if not run.jitter_anchor
             else [fit.fit_args, fit.resample_fit(), fit.resample_fit()])
    for (loss_fn, jargs), targs in zip(calls, draws):
        x0j, tsj, tgj = (np.asarray(a) for a in jargs)
        x0t, tst, tgt = (a.numpy() for a in targs)
        assert tsj.shape == tst.shape and tgj.shape == tgt.shape
        assert _rel(tst, tsj) < 1e-6 and _rel(tgt, tgj) < 1e-5
        assert _rel(x0t, x0j) < 1e-5
    env = _closure(calls[0][0])
    assert fit.spec.max_steps == env["spec_b"].max_steps
    if run.shooting_points:
        assert fit.spec_shoot.max_steps == env["spec_shoot"].max_steps
        P = run.shooting_points
        n_seg = (fit.ts_fit.shape[0] - 1) // (P - 1)
        assert fit.fit_args[1].shape == (n_seg, P)
    else:
        assert env["spec_shoot"] is None and fit.spec_shoot is None
    if run.jitter_anchor:
        assert not np.array_equal(draws[1][1].numpy(), draws[2][1].numpy())


def test_shooting_refusals():
    for kw, match in ((dict(shooting_points=3, phase_anchor_periods=1),
                       "incompatible"),
                      (dict(shooting_points=3, step_budget_schedule=True),
                       "incompatible"),
                      (dict(shooting_points=4), "not divisible"),
                      (dict(shooting_devices=2), "requires shooting_points"),
                      (dict(jitter_anchor=True), "requires dense_anchor")):
        with pytest.raises(ValueError, match=match):
            _port_fit(**kw)
    # the 17 segments of 3 points do not divide over 2 ranks
    with pytest.raises(ValueError, match="not divisible by "
                                         "shooting_devices=2"):
        _port_fit(shooting_points=3, shooting_devices=2)


def test_shooting_loss_and_gradient_match_jax(monkeypatch):
    """The 17 segments of 3 points at the 35 fit times, float64, through
    ``predict_batch`` with a row of times a segment (the eager per-row scan
    solve on the CPU) against the JAX driver's captured loss."""
    common = dict(layers_hidden=(2, 4, 2), ferro_num_basis=4, rtol=1e-5,
                  atol=1e-7, max_steps=64)
    jspec = jpp.PredPreyNODE.kanfet(solver_unroll=1, solver_checkpoint=False,
                                    **common)
    tspec = tpp.PredPreyNODE.kanfet(**common)
    calls = _capture(monkeypatch, spec=jspec, shooting_points=3,
                     dtype=jnp.float64, reg_lambda=1e-3)
    loss_fn, jargs = calls[0]
    jparams = jpp.predprey_init(jax.random.PRNGKey(2), jspec, jnp.float64)
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jparams, *jargs)

    run, fit = _port_fit(spec=tspec, shooting_points=3, dtype=torch.float64,
                         reg_lambda=1e-3)
    assert fit.spec_shoot.max_steps == 32 and fit.fit_args[1].shape == (17, 3)
    kan = _to_port(jparams, tspec, torch.float64)
    loss = tdrv.make_loss(run, fit, fit.spec.max_steps)(kan, *fit.fit_args)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-8 * abs(float(jl))
    gj, gt = _flat_jax_grads(jg), _flat_port_grads(kan)
    assert np.linalg.norm(gt - gj) <= 1e-7 * np.linalg.norm(gj)


def test_predprey_kill_and_resume(tmp_path):
    """Ladder on (a small headroom, so that it climbs), jittered dense
    collocation (the draws fast-forwarded on resume) and the grid refit:
    a run killed after its second call's checkpoint and resumed continues
    the unbroken run's curve and budgets bit for bit."""
    task = tpp.PredPreyTask(n_train=12, tf_learn=1.2, tf=2.4, n_t=24)
    spec = tpp.PredPreyNODE.kanfet(layers_hidden=(2, 4, 2), ferro_num_basis=2,
                                   rtol=1e-3, atol=1e-5, max_steps=128)
    kw = dict(task=task, spec=spec, epochs=40, epochs_per_call=10,
              eval_every_call=False, step_budget_schedule=True,
              budget_headroom=0.05, dense_anchor=2, jitter_anchor=True,
              grid_update_every=1, device="cpu")
    _, ref = tdrv.train_predprey(tdrv.PredPreyRun(**kw), log=None)
    assert len(set(ref["budget"])) > 1      # the ladder climbed
    ck = str(tmp_path / "ck")
    seen = []

    def killer(msg):
        seen.append(msg)
        if sum(m.startswith("epoch") for m in seen) >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tdrv.train_predprey(tdrv.PredPreyRun(**kw, ckpt_dir=ck,
                                             ckpt_every=10), log=killer)
    logs = []
    _, res = tdrv.train_predprey(tdrv.PredPreyRun(
        **kw, ckpt_dir=ck, ckpt_every=10, resume=True), log=logs.append)
    assert any("[ckpt] resumed at epoch 20" in m for m in logs)
    assert res["epoch"] == [30, 40]
    assert res["train"] == ref["train"][2:]
    assert res["budget"] == ref["budget"][2:]


def test_example_twin_matches_jax():
    """The twin's problem and step at the JAX example's converted init:
    the epoch-0 loss and the first gradient against the JAX example's
    ``trajectory_loss`` (its ``max_steps=128`` flagship)."""
    jspec = jpp.PredPreyNODE.kanfet(max_steps=128, solver_unroll=1,
                                    solver_checkpoint=False)
    ts, ts_learn, truth = jpp.generate_data(jpp.PredPreyTask())
    x0 = jnp.asarray([1.0, 1.0], jnp.float32)
    jparams = jpp.predprey_init(jax.random.PRNGKey(0), jspec)
    jl, jg = jax.jit(jax.value_and_grad(jpp.trajectory_loss),
                     static_argnums=1)(jparams, jspec, x0, ts_learn,
                                       truth[:35])
    spec, tx0, tts, target = example.problem(torch.device("cpu"))
    kan = _to_port(jparams, spec, torch.float32)
    kan_, losses = example.train(1, device="cpu", params=kan, log=None)
    assert abs(losses[0] - float(jl)) <= 1e-4 * float(jl)
    # the first gradient: the step's own backward (Adam has stepped, the
    # gradients are still in .grad)
    gj, gt = _flat_jax_grads(jg), _flat_port_grads(kan_)
    assert np.linalg.norm(gt - gj) <= 1e-3 * np.linalg.norm(gj)
    assert abs(float(jl) - 4.088171) < 1e-5    # the JAX example's epoch 0
