"""PyTorch port, the KAN layer's spline term (``ops/spline.py``, B.12)
against the JAX package's ``fetode_tpu/ops/pallas_spline.py``.

On the CPU ``spline_matmul_fused`` is its plain version
(``spline_matmul_reference``: the basis, then the product); it is held
against the JAX kernel run in interpret mode
(``spline_matmul_fused_interpret``) and against the JAX module's ``_ref``
on seeded numpy inputs: the dims of ``tests/test_pallas_spline.py``, one
56 -> 16 case (the cond-diffusion first layer's y dims), and inputs
outside the grid and on its last knot.  Tolerance rtol = atol = 2e-5,
``tests/test_pallas_spline.py``'s: float32 sums in another order.
Gradients (``spline_matmul_vjp``, the backward the CUDA path takes)
against ``jax.vjp`` of ``_ref`` at 1e-5.  ``kan_linear_apply``, whose
spline term now goes through the dispatch, is held against the JAX
layer for a KAN and a KANFET layer with converted parameters, and
``_kan_partial`` (the cond-diffusion chain's first layer) summed over a
partition of the inputs against the whole layer.  The property the
kernel's windowed bases rest on, that plain's bases off x's knot window
are +0, is held bit for bit, and so is the NaN row of a NaN or infinite
input.  The kernel itself runs only on the card
(the ``cuda`` test here, and ``chip_smoke.py`` phase 40).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.nn import kan as JK
from fetode_tpu.ops.bsplines import make_grid as j_make_grid
from fetode_tpu.ops.pallas_spline import _ref as j_ref
from fetode_tpu.ops.pallas_spline import spline_matmul_fused_interpret
from fetode_tpu_torch.convert import params_from_numpy
from fetode_tpu_torch.models.cond_diffusion import _kan_partial
from fetode_tpu_torch.nn import kan as TK
from fetode_tpu_torch.ops import spline as SP
from fetode_tpu_torch.ops.bsplines import bspline_basis

DIMS = [(2, 10, 5, 3), (7, 16, 8, 3), (1, 1, 4, 2), (56, 16, 5, 3)]
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(dims, seed=0, B=13, lo=-0.95, hi=0.95):
    n_in, n_out, G, order = dims
    grid = np.asarray(j_make_grid(n_in, G, order), np.float32)
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (B, n_in)).astype(np.float32)
    w = rng.standard_normal((n_out, n_in, G + order)).astype(np.float32)
    return x, grid, w, order


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_jax_kernel_and_ref(dims):
    x, grid, w, order = _case(dims)
    y_k = np.asarray(spline_matmul_fused_interpret(
        jnp.asarray(x), jnp.asarray(grid), jnp.asarray(w), order))
    y_r = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(grid),
                           jnp.asarray(w), order))
    y_t = SP.spline_matmul_fused(*_t(x, grid, w), order).numpy()
    assert y_t.shape == (x.shape[0], w.shape[0])
    np.testing.assert_allclose(y_t, y_k, **TOL)
    np.testing.assert_allclose(y_t, y_r, **TOL)


def test_out_of_range_and_last_knot():
    """Outside the grid, and exactly on its last knot (half-open
    intervals), every basis is zero: the JAX kernel and the port agree."""
    x, grid, w, order = _case((3, 4, 5, 3))
    last, first = float(grid[0, -1]), float(grid[0, 0])
    x = np.array([[-5.0, 0.2, 5.0], [0.0, -2.0, 2.0],
                  [last, first, last], [first, last, 0.999]], np.float32)
    y_k = np.asarray(spline_matmul_fused_interpret(
        jnp.asarray(x), jnp.asarray(grid), jnp.asarray(w), order))
    y_t = SP.spline_matmul_fused(*_t(x, grid, w), order).numpy()
    np.testing.assert_allclose(y_t, y_k, **TOL)
    assert np.all(np.isfinite(y_t))
    # a row whose every input is off the grid or on the last knot is zero
    off = SP.spline_matmul_fused(*_t(np.array([[-5.0, last, 5.0]],
                                               np.float32), grid, w), order)
    assert torch.equal(off, torch.zeros_like(off))


@pytest.mark.parametrize("dims", DIMS[:2] + DIMS[3:])
def test_vjp_matches_jax(dims):
    """The backward of the CUDA path (the plain version recomputed, its
    VJP) against ``jax.vjp`` of ``_ref``; the autograd of the CPU path
    gives the same."""
    x, grid, w, order = _case(dims, seed=3)
    rng = np.random.default_rng(4)
    ybar = rng.standard_normal((x.shape[0], w.shape[0])).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: j_ref(a, jnp.asarray(grid), b, order),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = (np.asarray(g) for g in vjp(jnp.asarray(ybar)))
    xt, gt, wt, yb = _t(x, grid, w, ybar)
    dx, dw = SP.spline_matmul_vjp(yb, xt, gt, wt, order)
    np.testing.assert_allclose(dx.numpy(), dx_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), dw_j, rtol=1e-5, atol=1e-5)
    xa, wa = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    ga = torch.autograd.grad(SP.spline_matmul_fused(xa, gt, wa, order),
                             [xa, wa], yb)
    assert torch.equal(ga[0], dx) and torch.equal(ga[1], dw)
    # only what is asked for
    assert SP.spline_matmul_vjp(yb, xt, gt, wt, order, need_x=False)[0] is None
    assert torch.equal(SP.spline_matmul_vjp(yb, xt, gt, wt, order,
                                            need_x=False)[1], dw)


def test_refusals():
    x, grid, w, order = _t(*_case((3, 4, 5, 3))[:3]) + [3]
    with pytest.raises(ValueError, match="B.12"):
        SP.spline_matmul_fused(x, grid, w[:, :2], order)
    with pytest.raises(ValueError, match="B.12"):
        SP.spline_matmul_fused(x, grid, w, 2)
    with pytest.raises(ValueError, match="B.12"):
        SP.spline_matmul_fused(x[0], grid, w, order)
    # the kernel takes float32 only, and says so before it builds anything
    with pytest.raises(TypeError, match="float32"):
        SP._launch(x.double(), grid, w, order)


@pytest.mark.parametrize("G,order", [(5, 3), (8, 3), (4, 2), (6, 5)])
def test_plain_bases_are_plus_zero_off_the_knot_window(G, order):
    """What the kernel relies on to skip terms: in plain's recursion every
    basis outside the order + 1 on x's knot interval, and every basis of a
    finite x off the knots, is +0 (the bits of +0), so the kernel's
    window of nonzero terms and its zeros are plain's bases bit for
    bit."""
    grid = torch.from_numpy(np.asarray(j_make_grid(1, G, order), np.float32))
    g = grid[0].numpy()
    rng = np.random.default_rng(G + order)
    x = np.concatenate([rng.uniform(-3 * g[-1], 3 * g[-1], 4000), g,
                        np.nextafter(g, np.float32(np.inf)),
                        np.nextafter(g, np.float32(-np.inf))]).astype(
                            np.float32)
    bases = bspline_basis(torch.from_numpy(x)[:, None], grid,
                          order)[:, 0].numpy()
    bits = bases.view(np.int32)
    m = np.searchsorted(g, x, side="right") - 1        # g[m] <= x < g[m+1]
    inside = (x >= g[0]) & (x < g[-1])
    c = np.arange(bases.shape[1])[None, :]
    window = (c >= m[:, None] - order) & (c <= m[:, None]) & inside[:, None]
    assert np.all(bits[~window] == 0)
    # and the window is live: a partition of unity between the end knots
    core = (x >= g[order]) & (x < g[-order - 1])
    np.testing.assert_allclose(bases[core].sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("order", [0, 1, 3, 5])
def test_plain_bases_of_nan_and_infinite_x(order):
    """What the kernel writes for a NaN or infinite x, which lies in no
    knot interval: plain's bases are NaN at every index from order 1 on
    (its first level multiplies a NaN or infinite quotient by zero), and
    zero at order 0; so is the spline term's row, and the kernel's."""
    grid = torch.from_numpy(np.asarray(j_make_grid(2, 5, order), np.float32))
    x = torch.tensor([[np.nan, 0.25], [np.inf, 0.25], [-np.inf, 0.25]],
                     dtype=torch.float32)
    bases = bspline_basis(x, grid, order)
    if order >= 1:
        assert torch.isnan(bases[:, 0]).all()
    else:
        assert torch.equal(bases[:, 0], torch.zeros_like(bases[:, 0]))
    assert torch.isfinite(bases[:, 1]).all()
    w = torch.ones((3, 2, bases.shape[-1]))
    y = SP.spline_matmul_fused(x, grid, w, order)
    assert torch.isnan(y).all() if order >= 1 else torch.isfinite(y).all()


def _layers(seed, **kw):
    jcfg = JK.KANLinearConfig(**kw)
    jp = JK.kan_linear_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    kan = TK.KAN(TK.KANConfig(layers=(TK.KANLinearConfig(**kw),)))
    kan.load_state_dict(params_from_numpy([tree]))
    return jcfg, jp, kan.layers[0]


@pytest.mark.parametrize("kw", [
    dict(in_features=6, out_features=5),
    dict(in_features=3, out_features=4, ferro_num_basis=4),
    dict(in_features=5, out_features=3, logistic_num_basis=2)],
    ids=["kan", "kanfet", "logistic"])
def test_kan_linear_apply_matches_jax(kw):
    jcfg, jp, layer = _layers(1, **kw)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.2, 1.2, (9, kw["in_features"])).astype(np.float32)
    js = JK.kan_linear_state((9,), jcfg, jnp.float32)
    ts = TK.kan_linear_state((9,), layer.cfg)
    y_j, s_j = JK.kan_linear_apply(jp, jcfg, jnp.asarray(x), js)
    with torch.no_grad():
        y_t, s_t = TK.kan_linear_apply(layer, torch.from_numpy(x), ts)
        y_p, _ = TK.kan_linear_apply(layer, torch.from_numpy(x), ts,
                                     plain=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    # on the CPU the dispatch is the plain version itself
    assert torch.equal(y_t, y_p)
    if s_j is not None:
        for a, b in zip(s_t, s_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_kan_partial_sums_to_the_layer():
    """The cond-diffusion chain's first layer, applied to a partition of
    its inputs (y dims, cond dims, t-embedding dims), sums to the layer."""
    _, _, layer = _layers(2, in_features=12, out_features=7)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(-1.1, 1.1, (5, 12)).astype(np.float32))
    with torch.no_grad():
        full, _ = TK.kan_linear_apply(layer, x)
        parts = sum(_kan_partial(layer, x[:, sl], sl)
                    for sl in (slice(0, 4), slice(4, 9), slice(9, 12)))
    np.testing.assert_allclose(parts.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    x, grid, w, order = _t(*_case((56, 256, 5, 3), B=80, lo=-1.2,
                                  hi=1.2)[:3]) + [3]
    x, grid, w = x.to(dev), grid.to(dev), w.to(dev)
    n = SP.spline_matmul_fused.launches
    y = SP.spline_matmul_fused(x, grid, w, order)
    torch.cuda.synchronize()
    assert SP.spline_matmul_fused.launches == n + 1
    y_r = SP.spline_matmul_reference(x, grid, w, order)
    torch.testing.assert_close(y, y_r, **TOL)
    # a row alone gives the same bits as inside the batch
    assert torch.equal(SP.spline_matmul_fused(x[7:8], grid, w, order), y[7:8])
    # a column slice of a wider weight, read as it lies
    wide = torch.randn((256, 80, 8), device=dev)
    sl = slice(10, 66)
    torch.testing.assert_close(
        SP.spline_matmul_fused(x, grid, wide[:, sl, :], order),
        SP.spline_matmul_reference(x, grid, wide[:, sl, :], order), **TOL)
    with pytest.raises(TypeError, match="float32"):
        SP.spline_matmul_fused(x.double(), grid.double(), w.double(), order)
