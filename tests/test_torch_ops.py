"""PyTorch port, basis ops and KAN layers against the JAX package.

Inputs are drawn with numpy from a seed; JAX initialises the parameters
and ``fetode_tpu_torch.convert`` carries them over, so the two RNG
streams never need to agree.  Both sides run in float32 on the CPU.
Tolerance 1e-5 (absolute and relative) unless stated: the two frameworks
evaluate sigmoid, tanh and exp with different float32 approximations
and sum in different orders, which moves results by a few ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.nn import kan as jkan
from fetode_tpu.ops import bsplines as jbs
from fetode_tpu.ops import ferro as jferro
from fetode_tpu.ops import logistic as jlog
from fetode_tpu_torch.convert import params_from_numpy, params_to_numpy
from fetode_tpu_torch.nn import kan as tkan
from fetode_tpu_torch.ops import bsplines as tbs
from fetode_tpu_torch.ops import ferro as tferro
from fetode_tpu_torch.ops import logistic as tlog
from fetode_tpu_torch.utils.init import kaiming_uniform

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_make_grid_matches_jax():
    j = jbs.make_grid(3, 5, 3, (-1.0, 1.0), jnp.float32)
    t = tbs.make_grid(3, 5, 3, (-1.0, 1.0))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-7)


@pytest.mark.parametrize("order", [1, 3])
def test_bspline_basis_matches_jax(order):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.6, 1.6, (7, 3)).astype(np.float32)   # in and out of grid
    grid = np.asarray(jbs.make_grid(3, 5, order, (-1.0, 1.0), jnp.float32))
    j = np.asarray(jbs.bspline_basis(jnp.asarray(x), jnp.asarray(grid), order))
    t = tbs.bspline_basis(_t(x), _t(grid), order).numpy()
    assert t.shape == (7, 3, 5 + order)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("n_samples", [6, 40])   # under- and over-determined
def test_curve2coeff_matches_jax(n_samples):
    """Minimum-norm least squares on both sides; 1e-4 because the solve
    amplifies float32 rounding by the basis matrix's condition number.
    The under-determined case is the init fit: samples at the 6 interior
    knots."""
    rng = np.random.default_rng(1)
    grid = np.asarray(jbs.make_grid(2, 5, 3, (-1.0, 1.0), jnp.float32))
    if n_samples == 6:
        x = np.ascontiguousarray(grid.T[3:-3])
    else:
        x = rng.uniform(-1, 1, (n_samples, 2)).astype(np.float32)
    y = rng.normal(size=(n_samples, 2, 3)).astype(np.float32)
    j = np.asarray(jbs.curve2coeff(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(grid), 3))
    t = tbs.curve2coeff(_t(x), _t(y), _t(grid), 3).numpy()
    assert t.shape == (3, 2, 8)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_logistic_basis_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 3, 4)).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    j = jlog.logistic_basis(jlog.LogisticParams(jnp.asarray(a), jnp.asarray(b)),
                            jnp.asarray(x))
    t = tlog.logistic_basis(tlog.LogisticParams(_t(a), _t(b)), _t(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _ferro_pair(cfg_kw):
    jcfg = jferro.FerroConfig(in_dim=3, out_dim=4, num_basis=5, **cfg_kw)
    tcfg = tferro.FerroConfig(in_dim=3, out_dim=4, num_basis=5, **cfg_kw)
    jp = _np(jferro.ferro_init(jax.random.PRNGKey(3), jcfg, jnp.float32,
                               coef_scale=0.5))
    tp = tferro.FerroParams(tcfg)
    tp.load_state_dict({k: _t(v) for k, v in jp._asdict().items()})
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("gate_impl", ["sigmoid", "tanh"])
def test_ferro_basis_fresh_and_advanced_state(gate_impl):
    """Two calls in a row: the second runs from the state the first left
    (prev_x moved, branch off +1), so the hysteresis update is covered."""
    jcfg, tcfg, jp, tp = _ferro_pair(dict(gate_impl=gate_impl))
    rng = np.random.default_rng(4)
    x1, x2 = rng.uniform(-3, 3, (2, 6, 3)).astype(np.float32)
    js = jferro.ferro_state_init((6,), jcfg, jnp.float32)
    ts = tferro.ferro_state_init((6,), tcfg)
    jparams = jferro.FerroParams(*(jnp.asarray(v) for v in jp))
    for x in (x1, x2):
        jb, js = jferro.ferro_basis(jparams, js, jnp.asarray(x), jcfg)
        with torch.no_grad():
            tb, ts = tferro.ferro_basis(tp, ts, _t(x), tcfg)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
        np.testing.assert_allclose(ts.branch.numpy(), np.asarray(js.branch),
                                   **TOL)
        np.testing.assert_array_equal(ts.prev_x.numpy(), np.asarray(js.prev_x))
    assert not np.allclose(ts.branch.numpy(), 1.0)   # the state did advance


def test_ferro_apply_matches_jax_and_noise_needs_generator():
    jcfg, tcfg, jp, tp = _ferro_pair({})
    x = np.random.default_rng(5).normal(size=(6, 3)).astype(np.float32)
    jparams = jferro.FerroParams(*(jnp.asarray(v) for v in jp))
    jy, _ = jferro.ferro_apply(jparams, jferro.ferro_state_init((6,), jcfg),
                               jnp.asarray(x), jcfg)
    with torch.no_grad():
        ty, _ = tferro.ferro_apply(tp, tferro.ferro_state_init((6,), tcfg),
                                   _t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)

    noisy = tcfg._replace(noise_std=0.1)
    state = tferro.ferro_state_init((6,), noisy)
    with pytest.raises(ValueError):
        tferro.ferro_basis(tp, state, _t(x), noisy)
    with torch.no_grad():
        a, _ = tferro.ferro_basis(tp, state, _t(x), noisy,
                                  generator=torch.Generator().manual_seed(0))
        b, _ = tferro.ferro_basis(tp, state, _t(x), noisy,
                                  generator=torch.Generator().manual_seed(0))
        clean, _ = tferro.ferro_basis(tp, state, _t(x), tcfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())    # seeded draws
    assert 0.05 < float((a - clean).std()) < 0.2


def _kan_pair(cfg_j, cfg_t, seed=0):
    jp = jkan.kan_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    model = tkan.KAN(cfg_t)
    model.load_state_dict(params_from_numpy(_np(jp)))
    return jp, model


@pytest.mark.parametrize("stack", ["kanfet", "kan_logistic"])
def test_kan_apply_matches_jax(stack):
    if stack == "kanfet":
        cfg_j = jkan.kanfet_config([2, 10, 2], grid_size=5)
        cfg_t = tkan.kanfet_config([2, 10, 2], grid_size=5)
    else:   # plain KAN with the logistic branch on (off in KANFET stacks)
        cfg_j = jkan.KANConfig.make([3, 4, 2], logistic_num_basis=3)
        cfg_t = tkan.KANConfig.make([3, 4, 2], logistic_num_basis=3)
    jp, model = _kan_pair(cfg_j, cfg_t)
    d = cfg_t.layers[0].in_features
    x = np.random.default_rng(6).uniform(-1.5, 1.5, (5, d)).astype(np.float32)
    js = jkan.kan_state_init((5,), cfg_j, jnp.float32)
    ts = tkan.kan_state_init((5,), cfg_t)
    jy, js1 = jkan.kan_apply(jp, cfg_j, jnp.asarray(x), js)
    with torch.no_grad():
        ty, ts1 = tkan.kan_apply(model, _t(x), ts)
        # one layer on its own, through the module's forward
        ty0, _ = model.layers[0](_t(x), ts[0])
    jy0, _ = jkan.kan_linear_apply(jp[0], cfg_j.layers[0], jnp.asarray(x),
                                   js[0])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **TOL)
    for a, b in zip(ts1, js1):
        if a is not None:
            np.testing.assert_allclose(a.branch.numpy(), np.asarray(b.branch),
                                       **TOL)


def test_kan_linear_apply_keeps_leading_dims():
    cfg_j = jkan.kanfet_config([2, 3])
    cfg_t = tkan.kanfet_config([2, 3])
    jp, model = _kan_pair(cfg_j, cfg_t, seed=1)
    x = np.random.default_rng(7).normal(size=(2, 3, 2)).astype(np.float32)
    jy, _ = jkan.kan_linear_apply(jp[0], cfg_j.layers[0], jnp.asarray(x),
                                  jkan.kan_linear_state((2, 3), cfg_j.layers[0]))
    with torch.no_grad():
        ty, st = tkan.kan_linear_apply(
            model.layers[0], _t(x),
            tkan.kan_linear_state((2, 3), cfg_t.layers[0]))
    assert ty.shape == (2, 3, 3) and st.branch.shape == (2, 3, 2, 3, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    with pytest.raises(ValueError):
        tkan.kan_linear_apply(model.layers[0], _t(x))     # ferro needs state


def test_kan_init_shapes_ranges_and_seed():
    cfg = tkan.kanfet_config([2, 10, 2])
    a = tkan.kan_init(torch.Generator().manual_seed(0), cfg)
    b = tkan.kan_init(torch.Generator().manual_seed(0), cfg)
    jp = jkan.kan_init(jax.random.PRNGKey(0), jkan.kanfet_config([2, 10, 2]))
    tree = params_to_numpy(a)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(_np(jp))
    for x, y in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(_np(jp))):
        assert x.shape == y.shape and x.dtype == np.float32
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    fe = a.layers[0].ferro.requires_grad_(False)
    assert 0.5 <= float(fe.k.min()) and float(fe.k.max()) <= 2.5
    assert 0.5 <= float(fe.ps.min()) and float(fe.ps.max()) <= 2.0
    # the init spline fit reproduces its noise targets at the interior knots
    assert float(a.layers[0].spline_weight.detach().abs().max()) < 0.1


def test_kaiming_uniform_bound():
    g = torch.Generator().manual_seed(0)
    w = kaiming_uniform(g, (64, 16))
    bound = np.sqrt(3.0) * np.sqrt(2.0 / 6.0) / np.sqrt(16)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


def test_params_round_trip():
    jp = _np(jkan.kan_init(jax.random.PRNGKey(2),
                           jkan.KANConfig.make([3, 4, 2], logistic_num_basis=2,
                                               ferro_num_basis=3)))
    back = params_to_numpy(params_from_numpy(jp))
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(x, y)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jp)
    sd = params_from_numpy(jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                                  jp))
    assert all(v.dtype == torch.float32 for v in sd.values())
