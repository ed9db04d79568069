"""PyTorch port, the rest of ``solvers/`` against the JAX package:
``Dopri5Stats`` / ``full_output`` (whole state and per row), the
``odeint`` dispatch and its error, the stateful fixed-step integrators,
the continuous adjoint ``odeint_adjoint`` (forward, gradients for y0,
parameters and ``ts``), and predprey's fixed-step methods (``predict``
and a training step), mirroring ``tests/test_solvers.py`` and
``tests/test_adjoint.py``.

Inputs from numpy seeds, flagship KANFET [2,10,2] parameters from
``PRNGKey(0)``.  Tolerances:
* step counts and ``success``: exact, in float64, where the error
  estimate is far above rounding so both solvers take the same attempts;
* trajectories in float64: 1e-12 (one algorithm, one step mesh); the
  fixed-step predprey solves in float32: 1e-6.  Where a solve runs out
  of attempts its unreached tail holds the last state, and there 1e-8:
  jitted, XLA's float64 ``pow`` in the step controller moves the step
  sizes by about 1e-10 relative (the JAX package under
  ``jax.disable_jit`` takes the port's steps to the last bit), which
  moves the reached time, not the accuracy of the solution; the same
  shift inside predprey's KAN solve moves its outputs by about 7e-12,
  and there 1e-10;
* ``odeint_adjoint``: forward 1e-9 against the direct solve, gradients
  relative 1e-6 against ``jax.grad`` of the JAX adjoint in float64;
* the predprey training step in float64: loss and gradients relative
  1e-10, parameters after one Adam step 1e-9 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fetode_tpu import solvers as js
from fetode_tpu.models import predprey as jpp
from fetode_tpu.train.optim import make_optimizer as j_make_optimizer
from fetode_tpu_torch import solvers as ts_
from fetode_tpu_torch.convert import (
    grads_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn.kan import KAN
from fetode_tpu_torch.train.optim import make_optimizer
from fetode_tpu_torch.train.predprey_driver import PredPreyRun, train_predprey


def _t(a, dtype=torch.float64):
    return torch.tensor(np.array(a), dtype=dtype)


def j_lv(t, y):
    return jnp.stack([1.5 * y[..., 0] - y[..., 0] * y[..., 1],
                      y[..., 0] * y[..., 1] - 3.0 * y[..., 1]], axis=-1)


def t_lv(t, y):
    return torch.stack([1.5 * y[..., 0] - y[..., 0] * y[..., 1],
                        y[..., 0] * y[..., 1] - 3.0 * y[..., 1]], dim=-1)


# ------------------------------------------------------------ Dopri5Stats


def _assert_solves_close(got, want, ts, reached):
    """1e-12 on the output times a solve reached, 1e-8 on its unreached
    tail (the last state; see the module docstring)."""
    reached = np.asarray(ts) <= reached
    np.testing.assert_allclose(got[..., reached, :], want[..., reached, :],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("max_steps,rtol", [(512, 1e-8), (20, 1e-8),
                                            (64, 1e-4)])
def test_dopri5_stats_match_jax(max_steps, rtol):
    ts = np.linspace(0.0, 6.0, 13)
    y0 = np.asarray([1.0, 0.7])
    kw = dict(rtol=rtol, atol=rtol * 1e-2, max_steps=max_steps)
    jys, jst = js.odeint_dopri5(j_lv, jnp.asarray(y0), jnp.asarray(ts),
                                mode="while", full_output=True, **kw)
    tys, tst = ts_.odeint_dopri5(t_lv, _t(y0), _t(ts), mode="while",
                                 full_output=True, **kw)
    assert isinstance(tst, ts_.Dopri5Stats)
    for a, b in zip(tst, jst):
        assert int(a) == int(b)
    assert bool(tst.success) == (max_steps == 512 or rtol == 1e-4)
    rec = []
    ts_.odeint_dopri5(t_lv, _t(y0), _t(ts), mode="while", **kw,
                      record=lambda m, a, t, dt, adv, *_: rec.append(
                          float(t[0] + dt[0]) if adv[0] else 0.0))
    _assert_solves_close(tys.numpy()[None], np.asarray(jys)[None], ts,
                         max(rec))
    # without full_output the same trajectory alone
    alone = ts_.odeint_dopri5(t_lv, _t(y0), _t(ts), mode="while", **kw)
    assert torch.equal(alone, tys)


def test_dopri5_stats_per_row_match_vmap():
    """The per-row form's stats are ``jax.vmap``'s: one per trajectory;
    scan mode (under autograd) counts as while mode does."""
    rng = np.random.default_rng(0)
    x0s = rng.uniform(0.5, 2.0, (5, 2))
    ts = np.linspace(0.0, 4.0, 9)
    kw = dict(rtol=1e-6, atol=1e-8, max_steps=40)   # rows need 33-52
    jys, jst = jax.vmap(lambda x: js.odeint_dopri5(
        j_lv, x, jnp.asarray(ts), mode="while", full_output=True, **kw))(
        jnp.asarray(x0s))
    x = _t(x0s).requires_grad_()
    tys, tst = ts_.odeint_dopri5(lambda t, y: t_lv(t, y), x, _t(ts),
                                 per_row=True, full_output=True, **kw)
    assert tys.requires_grad and tst.n_accepted.shape == (5,)
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not bool(tst.success.all()) and bool(tst.success.any())
    for i in range(5):
        reached = ts[-1] if bool(tst.success[i]) else -1.0
        _assert_solves_close(tys[i:i + 1].detach().numpy(),
                             np.asarray(jys)[i:i + 1], ts, reached)


# ------------------------------------------------------------ odeint


@pytest.mark.parametrize("method", ["dopri5", "rk4", "euler", "midpoint",
                                    "heun", "rk2", "dopri5_fixed"])
def test_odeint_dispatch_matches_jax(method):
    ts = np.linspace(0.0, 2.0, 9)
    y0 = np.asarray([1.0, 0.5])
    kw = dict(rtol=1e-9, atol=1e-11) if method == "dopri5" else dict(
        n_substeps=2)
    want = js.odeint(j_lv, jnp.asarray(y0), jnp.asarray(ts), method=method,
                     **kw)
    got = ts_.odeint(t_lv, _t(y0), _t(ts), method=method, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_odeint_extra_args_and_unknown_method():
    ts = np.linspace(0.0, 1.0, 5)
    y0 = np.asarray([1.0])
    got = ts_.odeint(lambda t, y, k: -k * y, _t(y0), _t(ts), _t(0.3),
                     method="rk4")
    want = js.odeint(lambda t, y, k: -k * y, jnp.asarray(y0),
                     jnp.asarray(ts), jnp.asarray(0.3), method="rk4")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-14)
    assert ts_.ADAPTIVE_METHODS == js.ADAPTIVE_METHODS
    assert ts_.FIXED_METHODS == js.FIXED_METHODS
    with pytest.raises(ValueError) as tmsg:
        ts_.odeint(t_lv, _t([1.0, 1.0]), _t(ts), method="nope")
    with pytest.raises(ValueError) as jmsg:
        js.odeint(j_lv, jnp.asarray([1.0, 1.0]), jnp.asarray(ts),
                  method="nope")
    assert str(tmsg.value) == str(jmsg.value)


# ------------------------------------------------------------ stateful


def _hysteretic(xp):
    """A field with a side state (last x, branch sign): the branch flips
    when x turns, the field's offset follows the branch."""
    def func(t, y, s, k):
        last, branch = s
        x = y[..., 0]
        turn = xp.sign(x - last)
        branch = xp.where(turn == 0, branch, turn)
        dy = xp.stack([y[..., 1], -k * x + 0.3 * branch], -1)
        return dy, (x, branch)
    return func


@pytest.mark.parametrize("method,n_substeps,advance", [
    ("rk4", 1, True), ("rk4", 3, True), ("euler", 2, True),
    ("heun", 1, False)])
def test_odeint_fixed_stateful_matches_jax(method, n_substeps, advance):
    rng = np.random.default_rng(1)
    y0 = rng.standard_normal((3, 2))
    s0 = (np.zeros(3), np.ones(3))
    ts = np.linspace(0.0, 3.0, 16)
    k = 1.3
    jtraj, (jl, jb) = js.odeint_fixed_stateful(
        _hysteretic(jnp), jnp.asarray(y0), tuple(map(jnp.asarray, s0)),
        jnp.asarray(ts), jnp.asarray(k), method=method,
        n_substeps=n_substeps, advance_state=advance)
    ttraj, (tl, tb) = ts_.odeint_fixed_stateful(
        _hysteretic(torch), _t(y0), tuple(map(_t, s0)), _t(ts), _t(k),
        method=method, n_substeps=n_substeps, advance_state=advance)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-12)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if not advance:
        np.testing.assert_array_equal(tb.numpy(), s0[1])


@pytest.mark.parametrize("advance", [True, False])
def test_integrate_final_stateful_matches_jax(advance):
    rng = np.random.default_rng(2)
    y0 = rng.standard_normal((4, 2))
    s0 = (np.zeros(4), -np.ones(4))
    want, (jl, jb) = js.integrate_final_stateful(
        _hysteretic(jnp), jnp.asarray(y0), tuple(map(jnp.asarray, s0)), 0.0,
        2.5, jnp.asarray(0.8), method="rk4", n_steps=11,
        advance_state=advance)
    got, (tl, tb) = ts_.integrate_final_stateful(
        _hysteretic(torch), _t(y0), tuple(map(_t, s0)), 0.0, 2.5, _t(0.8),
        method="rk4", n_steps=11, advance_state=advance)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-12)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# ------------------------------------------------------------ adjoint


def _mlp_field(xp):
    def f(t, y, w1, b1, w2):
        return w2 @ xp.tanh(w1 @ y + b1) + 0.1 * xp.sin(t)
    return f


def test_adjoint_forward_matches_direct():
    ts = np.linspace(0.0, 2.0, 9)
    y0 = np.asarray([1.0, 0.5])
    f = lambda t, y, rate: rate * y  # noqa: E731
    got = ts_.odeint_adjoint(f, _t(y0), _t(ts), _t(-0.4), rtol=1e-9,
                             atol=1e-11)
    direct = ts_.odeint_dopri5(lambda t, y: f(t, y, _t(-0.4)), _t(y0), _t(ts),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-9)
    want = js.odeint_adjoint(f, jnp.asarray(y0), jnp.asarray(ts),
                             jnp.asarray(-0.4), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def test_adjoint_gradients_match_jax():
    """y0, the field's parameters and ``ts``, from cotangents at every
    output time, against ``jax.grad`` of the JAX adjoint."""
    rng = np.random.default_rng(3)
    w1, b1 = 0.5 * rng.standard_normal((8, 2)), 0.1 * rng.standard_normal(8)
    w2 = 0.5 * rng.standard_normal((2, 8))
    y0 = np.asarray([0.3, -0.7])
    ts = np.asarray([0.0, 0.4, 1.1, 1.5, 2.0])
    G = rng.standard_normal((5, 2))
    kw = dict(rtol=1e-8, atol=1e-10)

    def j_loss(*a):
        return jnp.sum(js.odeint_adjoint(_mlp_field(jnp), a[0], a[1], *a[2:],
                                         **kw) * G)

    jv, jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (y0, ts, w1, b1, w2)))
    args = [_t(a).requires_grad_() for a in (y0, ts, w1, b1, w2)]
    tv = torch.sum(ts_.odeint_adjoint(_mlp_field(torch), args[0], args[1],
                                      *args[2:], **kw) * _t(G))
    tg = torch.autograd.grad(tv, args)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-9)
    for name, a, b in zip(("y0", "ts", "w1", "b1", "w2"), tg, jg):
        b = np.asarray(b)
        rel = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
        assert rel < 1e-6, (name, rel)


def test_adjoint_analytic_gradients():
    """dL/drate of y(T) = e^{rate T} is T y(T); a sum over every output
    time, sum_i -2 t_i e^{-2 k t_i}; and y0's against the scan-mode
    gradient of the direct solve (the pendulum)."""
    T = 1.2
    rate = _t(-0.6).requires_grad_()
    ys = ts_.odeint_adjoint(lambda t, y, r: r * y, _t([1.0]), _t([0.0, T]),
                            rate, rtol=1e-10, atol=1e-12)
    (g,) = torch.autograd.grad(ys[-1, 0], rate)
    np.testing.assert_allclose(float(g), T * np.exp(-0.6 * T), rtol=1e-6)

    t = np.linspace(0.0, 2.0, 6)
    k = _t(0.9).requires_grad_()
    ys = ts_.odeint_adjoint(lambda tt, y, kk: -kk * y, _t([1.0]), _t(t), k,
                            rtol=1e-10, atol=1e-12)
    (g,) = torch.autograd.grad(torch.sum(ys ** 2), k)
    np.testing.assert_allclose(float(g), np.sum(-2 * t * np.exp(-1.8 * t)),
                               rtol=1e-5)

    def pend(tt, y):
        return torch.stack([y[1], -torch.sin(y[0])])

    y0 = _t([0.8, 0.1]).requires_grad_()
    tsp = _t(np.linspace(0.0, 1.5, 4))
    (g_adj,) = torch.autograd.grad(torch.sum(ts_.odeint_adjoint(
        pend, y0, tsp, rtol=1e-10, atol=1e-12)[-1] ** 2), y0)
    (g_scan,) = torch.autograd.grad(torch.sum(ts_.odeint_dopri5(
        pend, y0, tsp, rtol=1e-10, atol=1e-12, mode="scan")[-1] ** 2), y0)
    np.testing.assert_allclose(g_adj.numpy(), g_scan.numpy(), rtol=1e-5)


# ------------------------------------------------------------ predprey


@pytest.fixture(scope="module")
def predprey():
    jspec = jpp.PredPreyNODE.kanfet()
    jparams = jpp.predprey_init(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  jparams)
    task = jpp.PredPreyTask()
    _, ts_learn, truth = jpp.generate_data(task, dtype=jnp.float64)
    return dict(tree=tree, ts=np.asarray(ts_learn[:12]),
                target=np.asarray(truth[:12]), x0=np.asarray([1.0, 1.0]))


def _port_model(tree, dtype):
    spec = tpp.PredPreyNODE.kanfet()
    model = KAN(spec.kan, dtype=dtype)
    model.load_state_dict(params_from_numpy(tree))
    return model.to(dtype)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("method,n_substeps", [("rk4", 1), ("rk2", 2),
                                               ("euler", 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_predprey_fixed_predict_matches_jax(predprey, method, n_substeps,
                                            dtype):
    s = predprey
    ts = np.linspace(0.0, 14.0, 140)[:40]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jspec = jpp.PredPreyNODE.kanfet(method=method, n_substeps=n_substeps)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), s["tree"])
    x0s = np.random.default_rng(4).uniform(0.5, 2.0, (3, 2))
    want = np.asarray(jax.vmap(lambda x: jpp.predict(
        jtree, jspec, x, jnp.asarray(ts, jdt)))(jnp.asarray(x0s, jdt)))
    spec = tpp.PredPreyNODE.kanfet(method=method, n_substeps=n_substeps)
    model = _port_model(s["tree"], dtype)
    with torch.no_grad():
        one = tpp.predict(model, spec, _t(x0s[0], dtype), _t(ts, dtype))
        rows = tpp.predict_batch(model, spec, _t(x0s, dtype), _t(ts, dtype))
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert rows.shape == (3, 40, 2)
    np.testing.assert_allclose(one.numpy(), want[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(rows.numpy(), want, rtol=tol, atol=tol)
    # the solver_mode does not matter: a fixed method runs eager anywhere
    with torch.no_grad():
        pall = tpp.predict(model, spec._replace(solver_mode="pallas"),
                           _t(x0s[0], dtype), _t(ts, dtype))
    assert torch.equal(pall, one)


def test_predprey_fixed_training_step_matches_jax(predprey):
    """float64, rk4: the trajectory loss, its gradients and one Adam step
    with global-norm clipping."""
    s = predprey
    jspec = jpp.PredPreyNODE.kanfet(method="rk4", n_substeps=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, s["tree"])
    value, grads = jax.value_and_grad(lambda p: jpp.trajectory_loss(
        p, jspec, jnp.asarray(s["x0"]), jnp.asarray(s["ts"]),
        jnp.asarray(s["target"])))(jparams)
    for layer in grads:   # jax.grad differentiates the grid; it is a buffer
        layer["_buffers"]["grid"] = jnp.zeros_like(layer["_buffers"]["grid"])
    tx = j_make_optimizer(2e-3, kind="adam", grad_clip=1.0, params=jparams)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    stepped = optax.apply_updates(jparams, updates)

    spec = tpp.PredPreyNODE.kanfet(method="rk4", n_substeps=2)
    model = _port_model(s["tree"], torch.float64)
    opt = make_optimizer(2e-3, params=model.parameters(), kind="adam",
                         grad_clip=1.0)
    loss = tpp.trajectory_loss(model, spec, _t(s["x0"]), _t(s["ts"]),
                               _t(s["target"]))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(value), rtol=1e-10)
    g, want = _flat(grads_to_numpy(model, np.float64)), _flat(grads)
    assert np.linalg.norm(g - want) / np.linalg.norm(want) < 1e-10
    opt.step()
    np.testing.assert_allclose(_flat(params_to_numpy(model, np.float64)),
                               _flat(stepped), rtol=0, atol=1e-9)


def test_predprey_fixed_method_trains_and_refuses_full_output(predprey):
    _, hist = train_predprey(PredPreyRun(
        spec=tpp.PredPreyNODE.kanfet(method="rk4"), epochs=4,
        epochs_per_call=2, device="cpu"), log=None)
    assert np.isfinite(hist["train"] + hist["test"]).all()
    model = _port_model(predprey["tree"], torch.float64)
    ts = _t(predprey["ts"])
    with pytest.raises(ValueError, match="only meaningful for dopri5"):
        tpp.predict(model, tpp.PredPreyNODE.kanfet(method="rk4"),
                    _t(predprey["x0"]), ts, full_output=True)
    with pytest.raises(ValueError, match="not available in pallas mode"):
        tpp.predict(model, tpp.PredPreyNODE.kanfet(solver_mode="pallas"),
                    _t(predprey["x0"]), ts, full_output=True)


def test_predprey_full_output_matches_jax(predprey):
    """The eager dopri5 ``predict(full_output=True)`` in float64: states
    and ``Dopri5Stats`` equal to the JAX package's, the budget probe of
    the step-budget ladder."""
    s = predprey
    jspec = jpp.PredPreyNODE.kanfet(max_steps=64, rtol=1e-4, atol=1e-6,
                                    solver_mode="while")
    jys, jst = jpp.predict(jax.tree_util.tree_map(jnp.asarray, s["tree"]),
                           jspec, jnp.asarray(s["x0"]), jnp.asarray(s["ts"]),
                           full_output=True)
    spec = tpp.PredPreyNODE.kanfet(max_steps=64, rtol=1e-4, atol=1e-6)
    with torch.no_grad():
        tys, tst = tpp.predict(_port_model(s["tree"], torch.float64), spec,
                               _t(s["x0"]), _t(s["ts"]), full_output=True)
    for a, b in zip(tst, jst):
        assert int(a) == int(b)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=0,
                               atol=1e-10)
