"""PyTorch port, the live grid refit against the JAX package:
``ops/bsplines.py: refine_grid`` and its quantile ranks, and
``nn/kan.py: kan_linear_update_grid`` / ``kan_update_grid`` on
parameters initialised by the JAX package and converted, with inputs from
a numpy seed.  Also: the refit writes into the layers' own tensors, so a
PyTorch optimiser keeps the same ``Parameter`` objects and their Adam
moments, as the JAX package's optimiser state stays valid across its
pure refit.

Tolerances:
* quantile ranks: equal, at the sample counts the predprey driver
  refits on (the 35 fit points; 13 and 12, a window cut by val_points)
  and over a range of counts and grid sizes, in JAX's production float32
  mode (x64 off) and in the tests' x64 mode at the predprey driver's
  counts;
* ``refine_grid``: 1e-6 relative (float32 rounding; the same operation
  order);
* the refit spline weights: 1e-4 relative to their largest entry (two
  LAPACK minimum-norm least-squares solvers, JAX's and ``gelsd``), the
  grids 1e-6, the refit stack's output 1e-4 of JAX's; the refit keeps
  the stack's function to 1e-2 (a least-squares fit on 35 samples, in
  either package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.nn import kan as jkan
from fetode_tpu.ops import bsplines as jbs
from fetode_tpu_torch.convert import params_from_numpy, params_to_numpy
from fetode_tpu_torch.nn import kan as tkan
from fetode_tpu_torch.ops import bsplines as tbs
from fetode_tpu_torch.train.optim import make_optimizer


def _x(seed, shape, scale=1.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("grid_size", [3, 5, 7, 12])
def test_quantile_indices_match_jax(grid_size):
    with jax.enable_x64(False):
        for batch in list(range(1, 400)) + [35, 70, 105, 140, 1000, 2049]:
            want = np.asarray(jnp.linspace(0, batch - 1, grid_size + 1)
                              .astype(jnp.int32))
            np.testing.assert_array_equal(
                tbs.quantile_indices(batch, grid_size), want,
                err_msg=f"batch {batch}")
    for batch in (35, 13, 12):       # x64 on, as the tests run JAX
        np.testing.assert_array_equal(
            tbs.quantile_indices(batch, grid_size),
            np.asarray(jnp.linspace(0, batch - 1, grid_size + 1)
                       .astype(jnp.int32)))


@pytest.mark.parametrize("shape,grid_size,order", [
    ((35, 2), 5, 3), ((13, 10), 5, 3), ((12, 3), 7, 2), ((200, 4), 5, 3)])
def test_refine_grid_matches_jax(shape, grid_size, order):
    x = _x(shape[0], shape)
    got = tbs.refine_grid(torch.from_numpy(x), grid_size, order)
    want = jbs.refine_grid(jnp.asarray(x), grid_size, order)
    assert got.shape == want.shape == (shape[1], grid_size + 2 * order + 1)
    _close(got.numpy(), want, 1e-6)


def _layer_pair(seed, cfg_kw):
    jcfg = jkan.KANLinearConfig(**cfg_kw)
    jp = jkan.kan_linear_init(jax.random.PRNGKey(seed), jcfg)
    tcfg = tkan.KANLinearConfig(**cfg_kw)
    layer = tkan.KANLinear(tcfg)
    sd = params_from_numpy([jax.tree_util.tree_map(np.asarray, jp)])
    layer.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    return jcfg, jp, layer


@pytest.mark.parametrize("cfg_kw", [
    dict(in_features=2, out_features=10, ferro_num_basis=8),
    dict(in_features=3, out_features=4, standalone_spline_scaler=False),
    dict(in_features=4, out_features=3, grid_size=7, spline_order=2)],
    ids=["kanfet", "no_scaler", "grid7_order2"])
def test_kan_linear_update_grid_matches_jax(cfg_kw):
    jcfg, jp, layer = _layer_pair(1, cfg_kw)
    x = _x(2, (35, cfg_kw["in_features"]))
    want = jkan.kan_linear_update_grid(jp, jcfg, jnp.asarray(x))
    got = tkan.kan_linear_update_grid(layer, torch.from_numpy(x))
    assert got is layer
    _close(layer.grid.numpy(), want["_buffers"]["grid"], 1e-6)
    _close(layer.spline_weight.detach().numpy(), want["spline_weight"], 1e-4)


def test_kan_update_grid_matches_jax():
    """A KANFET stack [2, 6, 2] refit on 35 samples: each layer on its own
    input, propagated through the layers already refit."""
    jcfg = jkan.KANConfig.make([2, 6, 2], grid_size=5, ferro_num_basis=4)
    jp = jkan.kan_init(jax.random.PRNGKey(3), jcfg)
    tcfg = tkan.kanfet_config([2, 6, 2], grid_size=5, ferro_num_basis=4)
    kan = tkan.KAN(tcfg)
    kan.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp)))
    x = _x(4, (35, 2))
    xt = torch.from_numpy(x)
    state = tkan.kan_state_init((35,), tcfg)
    with torch.no_grad():
        before = tkan.kan_apply(kan, xt, state)[0].numpy()
    want = jkan.kan_update_grid(jp, jcfg, jnp.asarray(x))
    tkan.kan_update_grid(kan, xt)
    got = params_to_numpy(kan)
    for g, w in zip(got, want):
        _close(g["_buffers"]["grid"], w["_buffers"]["grid"], 1e-6)
        _close(g["spline_weight"], w["spline_weight"], 1e-4)
        np.testing.assert_array_equal(g["base_weight"], w["base_weight"])
    with torch.no_grad():
        after = tkan.kan_apply(kan, xt, tkan.kan_state_init((35,), tcfg))[0]
    j_after = jkan.kan_apply(want, jcfg, jnp.asarray(x),
                             jkan.kan_state_init((35,), jcfg))[0]
    _close(after.numpy(), j_after, 1e-4)
    # 35 samples of 8 coefficients keep the function only approximately
    # (the JAX refit alike): the output moves by well under 1%.
    _close(after.numpy(), before, 1e-2)


def test_refit_keeps_optimizer_state():
    """After Adam steps, the refit leaves the optimiser holding the same
    Parameter objects with their moments, and the next step still runs."""
    cfg = tkan.kanfet_config([2, 5, 2], grid_size=5, ferro_num_basis=3)
    kan = tkan.kan_init(torch.Generator().manual_seed(0), cfg)
    opt = make_optimizer(1e-2, params=kan.parameters(), kind="adam",
                         grad_clip=1.0)
    x = torch.from_numpy(_x(5, (35, 2)))

    def step():
        opt.zero_grad()
        y = tkan.kan_apply(kan, x, tkan.kan_state_init((35,), cfg))[0]
        (y ** 2).mean().backward()
        opt.step()

    for _ in range(2):
        step()
    held = list(opt.inner.param_groups[0]["params"])
    moments = {id(p): {k: v.clone() for k, v in opt.inner.state[p].items()}
               for p in held}
    grids = [layer.grid.clone() for layer in kan.layers]
    weights = [layer.spline_weight for layer in kan.layers]
    tkan.kan_update_grid(kan, x)
    assert [id(p) for p in opt.inner.param_groups[0]["params"]] == \
        [id(p) for p in held]
    assert all(layer.spline_weight is w for layer, w in zip(kan.layers,
                                                             weights))
    assert all(not torch.equal(layer.grid, g)
               for layer, g in zip(kan.layers, grids))
    for p in held:
        for k, v in moments[id(p)].items():
            assert torch.equal(opt.inner.state[p][k], v)
    step()
    assert opt.count == 3 and all(torch.isfinite(p).all() for p in held)
