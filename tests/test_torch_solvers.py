"""PyTorch port, adaptive dopri5 against the JAX package's
``odeint_dopri5`` on the Lotka-Volterra field, in the whole-state form
and in the per-row form (against ``jax.vmap(odeint_dopri5)``).

Tolerances:
* float64, 1e-8: at float64 the embedded error estimate sits far above
  rounding, so both solvers take the same steps and agree to rounding —
  this checks the algorithm (initial step, PI controller, dense output,
  attempt budget) step for step, including a budget of 8 attempts.
* float32, 1e-3 at rtol 1e-7: in float32 the first step's error estimate
  sits at its rounding floor (it differs by ~10% between the two
  frameworks), so the step sequences drift apart and each trajectory
  carries its own global error of ~1e-4 over 14 time units.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu.solvers import odeint_dopri5 as j_odeint
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.solvers import odeint_dopri5 as t_odeint

TASK = jpp.PredPreyTask()
J_FIELD = jpp.lotka_volterra_field(TASK)
T_FIELD = tpp.lotka_volterra_field(tpp.PredPreyTask())


def _inputs(dtype):
    ts = np.linspace(0.0, 14.0, 140).astype(dtype)
    x0s = np.random.default_rng(0).uniform(0.5, 2.0, (5, 2)).astype(dtype)
    return ts, x0s


def _jax(x0s, ts, max_steps, per_row, **kw):
    solve = lambda x0: j_odeint(J_FIELD, x0, jnp.asarray(ts),  # noqa: E731
                                max_steps=max_steps, mode="while", **kw)
    if per_row:
        return np.asarray(jax.vmap(solve)(jnp.asarray(x0s)))
    return np.asarray(solve(jnp.asarray(x0s)))


def _torch(x0s, ts, max_steps, per_row, **kw):
    return t_odeint(T_FIELD, torch.from_numpy(x0s), torch.from_numpy(ts),
                    max_steps=max_steps, mode="while", per_row=per_row,
                    **kw).numpy()


@pytest.mark.parametrize("per_row", [False, True], ids=["whole", "per_row"])
@pytest.mark.parametrize("max_steps", [4096, 8])
def test_dopri5_float64_step_for_step(per_row, max_steps):
    ts, x0s = _inputs(np.float64)
    ref = _jax(x0s, ts, max_steps, per_row)
    out = _torch(x0s, ts, max_steps, per_row)
    assert out.shape == ref.shape == ((5, 140, 2) if per_row else (140, 5, 2))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)
    if max_steps == 8:   # the budget ran out: tails hold the last state
        last = out[:, -1] if per_row else out[-1]
        tail = out[:, -10:] if per_row else out[-10:]
        axis = 1 if per_row else 0
        np.testing.assert_array_equal(tail, np.expand_dims(last, axis).repeat(
            10, axis=axis))


@pytest.mark.parametrize("per_row", [False, True], ids=["whole", "per_row"])
def test_dopri5_float32_serving_tolerance(per_row):
    ts, x0s = _inputs(np.float32)
    ref = _jax(x0s, ts, 4096, per_row, rtol=1e-7, atol=1e-9)
    out = _torch(x0s, ts, 4096, per_row, rtol=1e-7, atol=1e-9)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_per_row_is_independent_of_batch_mates():
    """Each row's step control is its own: a row solved in a batch equals
    the same row solved alone (float64 keeps the arithmetic exact enough
    that batching cannot move a step decision)."""
    ts, x0s = _inputs(np.float64)
    batch = _torch(x0s, ts, 64, True)
    for i in range(x0s.shape[0]):
        alone = _torch(x0s[i:i + 1], ts, 64, True)
        np.testing.assert_allclose(batch[i], alone[0], rtol=1e-12, atol=1e-12)


def test_generate_data_matches_jax():
    jts, jtl, jtraj = jpp.generate_data(TASK)
    tts, ttl, ttraj = tpp.generate_data(tpp.PredPreyTask())
    np.testing.assert_allclose(tts.numpy(), np.asarray(jts), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ttl.numpy(), np.asarray(jtl), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), rtol=1e-3,
                               atol=1e-3)


def test_modes():
    ts = torch.linspace(0.0, 1.0, 5)
    y0 = torch.tensor([1.0, 1.0])
    with pytest.raises(ValueError):
        t_odeint(T_FIELD, y0, ts, mode="bogus")
    while_ = t_odeint(T_FIELD, y0, ts, mode="while").numpy()
    np.testing.assert_array_equal(
        t_odeint(T_FIELD, y0, ts, mode="scan").numpy(), while_)
    # 'auto' picks the differentiable mode exactly under autograd
    w = torch.tensor(1.0, requires_grad=True)
    scan = t_odeint(lambda t, y: w * T_FIELD(t, y), y0, ts)
    assert scan.requires_grad
    np.testing.assert_array_equal(scan.detach().numpy(), while_)
    with torch.no_grad():
        auto = t_odeint(lambda t, y: w * T_FIELD(t, y), y0, ts)
    assert not auto.requires_grad
    np.testing.assert_array_equal(auto.numpy(), while_)
    with pytest.raises(ValueError):
        t_odeint(T_FIELD, y0, ts, per_row=True)      # per-row needs (B, D)


@pytest.mark.parametrize("per_row", [False, True], ids=["whole", "per_row"])
def test_dopri5_scan_gradient_matches_jax_float64(per_row):
    """The scan mode's gradient against ``jax.grad`` of the JAX scan mode,
    step for step in float64: d/dw of sum(y(ts)^2) for the field w * LV at
    w = 1.2, x0 from a seed.  The error norm and the initial step are cut
    from the graph in both."""
    ts, x0s = _inputs(np.float64)
    ts, x0s = ts[:40], x0s[:3]
    kw = dict(rtol=1e-6, atol=1e-8, max_steps=256)

    def j_loss(w):
        def solve(x0):
            return j_odeint(lambda t, y: w * J_FIELD(t, y), x0,
                            jnp.asarray(ts), mode="scan", **kw)
        ys = jax.vmap(solve)(jnp.asarray(x0s)) if per_row else \
            solve(jnp.asarray(x0s))
        return jnp.sum(ys ** 2)

    want_v, want_g = jax.value_and_grad(j_loss)(1.2)
    w = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    ys = t_odeint(lambda t, y: w * T_FIELD(t, y), torch.from_numpy(x0s),
                  torch.from_numpy(ts), mode="scan", per_row=per_row, **kw)
    loss = torch.sum(ys ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_v), rtol=1e-10)
    np.testing.assert_allclose(float(w.grad), float(want_g), rtol=1e-8)
