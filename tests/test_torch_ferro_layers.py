"""PyTorch port, the closed-form hysteresis layers against the JAX
package's: the hysteretic logistic basis (``ops/logistic.py``), the
per-feature ferro basis and the ferro convolution
(``nn/ferro_layers.py``), and the classes with the reference's names
(``nn/modules.py``), with ``nn/__init__.py``'s exports.

Parameters are drawn by the JAX package in float64 and loaded into the
port's; inputs are seeded numpy arrays; both sides run in float64.
Tolerance 1e-10 throughout (closed forms; the sums run in other
orders).  The convolution is held at stride 1 and 2, padding 0 and 1,
``out_chunk`` on and off, and through a stateful round trip; its patch
matrix (``torch.nn.functional.unfold``) is held to
``lax.conv_general_dilated_patches``'s bit for bit.  Device noise draws
from a ``torch.Generator`` (not JAX's keys), so noisy calls are held to
their clean value plus a detached draw of the stated std.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fetode_tpu.nn as jnn
import fetode_tpu_torch.nn as tnn
from fetode_tpu.nn import ferro_layers as JF
from fetode_tpu.nn import modules as JMOD
from fetode_tpu.ops import logistic as JL
from fetode_tpu_torch.convert import params_from_numpy
from fetode_tpu_torch.nn import ferro_layers as TF
from fetode_tpu_torch.nn import modules as TMOD
from fetode_tpu_torch.ops import ferro as TO
from fetode_tpu_torch.ops import logistic as TL

TOL = 1e-10
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _close(got, want):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def _states_close(got, want):
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------ hysteretic logistic


@pytest.mark.parametrize("hard_gate", [False, True], ids=["smooth", "hard"])
def test_hysteretic_logistic_matches_jax(hard_gate):
    p = JL.hysteretic_logistic_init(jax.random.PRNGKey(0), 3, 5, jnp.float64)
    tp = TL.HystereticLogisticParams(*map(_t, p))
    xs = np.random.default_rng(0).normal(size=(6, 4, 3))
    xs[3] = xs[2]                                   # a stationary step
    js = JL.hysteretic_logistic_state((4,), 3, 5, jnp.float64)
    ts = TL.hysteretic_logistic_state((4,), 3, 5, dtype=F64)
    for x in xs:
        wphi, js = JL.hysteretic_logistic_basis(p, js, jnp.asarray(x),
                                                hard_gate=hard_gate)
        gphi, ts = TL.hysteretic_logistic_basis(tp, ts, _t(x),
                                                hard_gate=hard_gate)
        assert gphi.shape == (4, 3, 5)
        _close(gphi, wphi)
        _states_close(ts, js)


def test_hysteretic_logistic_state_carries_no_gradient():
    g = torch.Generator().manual_seed(0)
    p = TL.hysteretic_logistic_init(g, 2, 3, dtype=F64)
    p = TL.HystereticLogisticParams(*(a.requires_grad_() for a in p))
    x = _t([[0.3, -0.2]]).requires_grad_()
    phi, s = TL.hysteretic_logistic_basis(
        p, TL.hysteretic_logistic_state((1,), 2, 3, dtype=F64), x)
    assert phi.requires_grad and not s.prev_x.requires_grad
    assert not s.branch.requires_grad


# ------------------------------------------------ per-feature (2D) basis


def _feature(seed=1):
    p = JF.ferro_feature_init(jax.random.PRNGKey(seed), 3, 4, jnp.float64)
    return p, TF.Ferro2DParams(*map(_t, p))


def test_ferro_feature_basis_matches_jax():
    p, tp = _feature()
    js = JF.ferro_feature_state((5,), 3, 4, jnp.float64)
    ts = TF.ferro_feature_state((5,), 3, 4, dtype=F64)
    for x in np.random.default_rng(1).normal(size=(4, 5, 3)) * 2.0:
        w, js = JF.ferro_feature_basis(p, js, jnp.asarray(x), gate_slope=7.0,
                                       alpha=0.6)
        g, ts = TF.ferro_feature_basis(tp, ts, _t(x), gate_slope=7.0,
                                       alpha=0.6)
        assert g.shape == (5, 3, 4)
        _close(g, w)
        _states_close(ts, js)


def test_ferro_feature_noise_is_a_detached_draw():
    _, tp = _feature()
    tp = TF.Ferro2DParams(*(a.requires_grad_() for a in tp))
    s = TF.ferro_feature_state((2,), 3, 4, dtype=F64)
    x = _t(np.random.default_rng(2).normal(size=(2, 3)))
    clean, _ = TF.ferro_feature_basis(tp, s, x)
    noisy, _ = TF.ferro_feature_basis(
        tp, s, x, noise_std=0.3, generator=torch.Generator().manual_seed(5))
    draw = torch.randn((2, 3, 4), generator=torch.Generator().manual_seed(5),
                       dtype=F64) * 0.3
    torch.testing.assert_close(noisy, (clean / tp.coef + draw) * tp.coef,
                               rtol=TOL, atol=TOL)
    g_clean = torch.autograd.grad(clean.sum(), tp.k)[0]
    g_noisy = torch.autograd.grad(noisy.sum(), tp.k)[0]
    assert torch.equal(g_clean, g_noisy)
    with pytest.raises(ValueError, match="generator"):
        TF.ferro_feature_basis(tp, s, x, noise_std=0.3)


# ------------------------------------------------------------ conv2d


def _conv(cfg, seed=2):
    p = JF.ferro_conv2d_init(jax.random.PRNGKey(seed), cfg, jnp.float64)
    return p, TF.FerroConv2DParams(*map(_t, p))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
def test_patches_are_lax_patches(stride, padding):
    cfg = TF.FerroConv2DConfig(3, 2, (3, 2), stride=stride, padding=padding)
    x = np.random.default_rng(3).normal(size=(2, 3, 7, 6))
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=(3, 2), window_strides=(stride, stride),
        padding=[(padding, padding)] * 2)
    got, out_hw = TF._patches(_t(x), cfg)
    assert out_hw == tuple(want.shape[2:])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).reshape(2, 3 * 3 * 2, -1)
        .transpose(0, 2, 1))


@pytest.mark.parametrize("out_chunk", [0, 2], ids=["whole", "chunked"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
def test_ferro_conv2d_matches_jax(stride, padding, out_chunk):
    cfg = JF.FerroConv2DConfig(2, 5, (3, 3), num_basis=2, stride=stride,
                               padding=padding, out_chunk=out_chunk)
    p, tp = _conv(cfg)
    x = np.random.default_rng(4).normal(size=(2, 2, 7, 7)) * 1.5
    want, ws = JF.ferro_conv2d_apply(p, cfg, jnp.asarray(x))
    got, gs = TF.ferro_conv2d_apply(tp, TF.FerroConv2DConfig(*cfg), _t(x))
    assert got.shape == want.shape and ws is None and gs is None
    _close(got, want)


def test_ferro_conv2d_chunks_equal_the_whole():
    cfg = TF.FerroConv2DConfig(2, 7, (3, 3), num_basis=2, padding=1)
    _, tp = _conv(JF.FerroConv2DConfig(*cfg))
    x = _t(np.random.default_rng(5).normal(size=(1, 2, 6, 6)))
    whole, _ = TF.ferro_conv2d_apply(tp, cfg, x)
    for chunk in (1, 3, 4, 6):
        part, _ = TF.ferro_conv2d_apply(tp, cfg._replace(out_chunk=chunk), x)
        _close(part, whole.numpy())


@pytest.mark.parametrize("stride", [1, 2])
def test_ferro_conv2d_stateful_round_trip_matches_jax(stride):
    cfg = JF.FerroConv2DConfig(2, 3, (2, 2), num_basis=2, stride=stride,
                               padding=1, stateful=True)
    tcfg = TF.FerroConv2DConfig(*cfg)
    p, tp = _conv(cfg, seed=3)
    rng = np.random.default_rng(6)
    js = ts = None
    ys = []
    for x in rng.normal(size=(3, 2, 2, 5, 5)):
        want, js = JF.ferro_conv2d_apply(p, cfg, jnp.asarray(x), js)
        got, ts = TF.ferro_conv2d_apply(tp, tcfg, _t(x), ts)
        _close(got, want)
        _states_close(ts, js)
        ys.append(got)
    # a fresh state of the layer's shape is the stateless first call's
    fresh = TF.ferro_conv2d_state((2,), tcfg, ys[0].shape[2:], dtype=F64)
    assert fresh.prev_x.shape == ts.prev_x.shape
    assert fresh.branch.shape == ts.branch.shape


def test_ferro_conv2d_noise_is_outside_the_gradient():
    cfg = TF.FerroConv2DConfig(1, 3, (3, 3), num_basis=2, noise_std=0.2)
    _, tp = _conv(JF.FerroConv2DConfig(*cfg))
    tp = TF.FerroConv2DParams(*(a.requires_grad_() for a in tp))
    x = _t(np.random.default_rng(7).normal(size=(2, 1, 5, 5)))
    clean, _ = TF.ferro_conv2d_apply(tp, cfg._replace(noise_std=0.0), x)
    noisy, _ = TF.ferro_conv2d_apply(
        tp, cfg, x, generator=torch.Generator().manual_seed(3))
    draw = torch.randn((2, 3, 9), generator=torch.Generator().manual_seed(3),
                       dtype=F64) * 0.2
    torch.testing.assert_close(noisy, clean + draw.reshape(2, 3, 3, 3),
                               rtol=TOL, atol=TOL)
    assert torch.equal(torch.autograd.grad(clean.sum(), tp.coef)[0],
                       torch.autograd.grad(noisy.sum(), tp.coef)[0])


# ------------------------------------------------------------ classes


def test_nn_exports_cover_the_jax_package():
    names = [n for n in dir(jnn) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(tnn, n)]
    assert missing == []


def _load_kan(module, jparams):
    module.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), dtype=F64))
    return module


def test_kan_class_matches_jax():
    jm = JMOD.KAN([2, 6, 3], grid_size=5)
    jp = jm.init(jax.random.PRNGKey(4), jnp.float64)
    tm = _load_kan(TMOD.KAN([2, 6, 3], grid_size=5, dtype=F64), jp)
    assert isinstance(tm, tnn.kan.KAN) and not tm.stateful
    x = np.random.default_rng(8).normal(size=(4, 2))
    _close(tm(_t(x)), jm(jp, jnp.asarray(x)))
    _close(tm.regularization_loss(), jm.regularization_loss(jp))


def test_kanfet_class_matches_jax():
    jm = JMOD.KANFET(layers_hidden=[2, 10, 2], grid_size=5)
    jp = jm.init(jax.random.PRNGKey(5), jnp.float64)
    tm = _load_kan(TMOD.KANFET(layers_hidden=[2, 10, 2], grid_size=5,
                               dtype=F64), jp)
    assert tm.cfg == tnn.kanfet_config([2, 10, 2], grid_size=5)
    x = np.random.default_rng(9).normal(size=(4, 2))
    js, ts = jm.init_state((4,), jnp.float64), tm.init_state((4,))
    for _ in range(2):
        wy, js = jm(jp, jnp.asarray(x), js)
        gy, ts = tm(_t(x), ts)
        _close(gy, wy)
        for g, w in zip(ts, js):
            _states_close(g, w)


def test_class_generator_draws_the_init():
    a = TMOD.KANFET([2, 4, 2], generator=torch.Generator().manual_seed(1))
    b = TMOD.KANFET([2, 4, 2], generator=torch.Generator().manual_seed(1))
    c = TMOD.FerroelectricBasis(3, 2, 4,
                                generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert sorted(c.state_dict()) == ["bias", "coef", "ec", "k", "ps"]


def _ferro_class(cls, *args, seed=6, **kw):
    jm = getattr(JMOD, cls)(*args, **kw)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.float64)
    tm = getattr(TMOD, cls)(*args, **kw, dtype=F64)
    tm.load_state_dict({k: _t(getattr(jp, k)) for k in tm.state_dict()})
    return jm, jp, tm


def test_ferroelectric_basis_class_matches_jax():
    jm, jp, tm = _ferro_class("FerroelectricBasis", 3, 5, 4)
    x = np.random.default_rng(10).normal(size=(2, 3))
    js, ts = jm.init_state((2,), jnp.float64), tm.init_state((2,))
    wy, js1 = jm(jp, js, jnp.asarray(x))
    gy, ts1 = tm(ts, _t(x))
    _close(gy, wy)
    _states_close(ts1, js1)
    wy, _, wb = jm(jp, js1, -jnp.asarray(x), return_activations=True)
    gy, _, gb = tm(ts1, -_t(x), return_activations=True)
    _close(gy, wy)
    _close(gb, wb)


def test_ferroelectric_basis_honours_update_branch():
    """The class goes through ``nn/rnn.py: ferro_layer`` and keeps the old
    branch when ``update_branch`` is off, as ``ferro_apply`` does (the JAX
    fused kernel ignores the flag)."""
    tm = TMOD.FerroelectricBasis(3, 2, 4,
                                 generator=torch.Generator().manual_seed(2))
    tm.cfg = tm.cfg._replace(update_branch=False)
    s = tm.init_state((2,))
    x = torch.randn((2, 3), generator=torch.Generator().manual_seed(3))
    y, s1 = tm(s, x)
    want, ws = TO.ferro_apply(tm, s, x, tm.cfg)
    assert torch.equal(y, want) and torch.equal(s1.branch, s.branch)


def test_noisy_ferroelectric_basis_draws_from_the_generator():
    tm = TMOD.NoisyFerroelectricBasis(3, 5, 4, dtype=F64,
                                      generator=torch.Generator().manual_seed(0))
    assert tm.cfg.noise_std == 0.2
    s = tm.init_state((2,))
    x = torch.zeros((2, 3), dtype=F64)
    clean = TO.ferro_apply(tm, s, x, tm.cfg._replace(noise_std=0.0))[0]
    y1, _ = tm(s, x, generator=torch.Generator().manual_seed(9))
    y2, _ = tm(s, x, generator=torch.Generator().manual_seed(9))
    assert torch.equal(y1, y2) and not torch.allclose(y1, clean)
    with pytest.raises(ValueError, match="generator"):
        tm(s, x)


def test_two_dimension_class_matches_jax():
    jm, jp, tm = _ferro_class("TwoDimensionFerroelectricBasis", 3, 4, seed=7)
    x = np.random.default_rng(11).normal(size=(2, 3))
    js, ts = jm.init_state((2,), jnp.float64), tm.init_state((2,))
    for sign in (1.0, -1.0):
        w, js = jm(jp, js, sign * jnp.asarray(x))
        g, ts = tm(ts, sign * _t(x))
        _close(g, w)
        _states_close(ts, js)


@pytest.mark.parametrize("out_chunk", [0, 2])
def test_conv2d_class_matches_jax(out_chunk):
    kw = dict(kernel_size=3, padding=1, stride=2, out_chunk=out_chunk,
              stateful=True)
    jm, jp, tm = _ferro_class("FerroelectricBasisConv2d", 1, 4, seed=8, **kw)
    assert tm.cfg == TF.FerroConv2DConfig(*jm.cfg)
    x = np.random.default_rng(12).normal(size=(2, 1, 6, 6))
    wy, ws = jm(jp, jnp.asarray(x))
    gy, gs = tm(_t(x))
    assert gy.shape == (2, 4, 3, 3)
    _close(gy, wy)
    wy, _ = jm(jp, -jnp.asarray(x), ws)
    gy, _ = tm(-_t(x), gs)
    _close(gy, wy)
    assert tm.init_state((2,), (3, 3)).branch.shape == gs.branch.shape
