"""PyTorch port, the whole-solve KANFET NODE (``ops/kanfet_node.py``)
against the JAX package: its plain twin ``kanfet_solve_reference`` against
``pallas_kanfet_solve(..., interpret=True)`` and ``vmap(predict)`` in
while mode, the CPU dispatch of the ``kanfet_solve`` wrapper, its
validation, the parameter packing the CUDA kernel reads, and ``predict``'s
solver dispatch.  The CUDA kernel itself is held against the reference by
the ``cuda``-marked test, which skips without a card.

As in ``tests/test_pallas_node.py``: flagship KANFET [2,10,2], params
from ``PRNGKey(0)``, the first 40 of the 140 serving times, B=4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu.ops.pallas_node import pallas_kanfet_solve
from fetode_tpu_torch.convert import params_from_numpy
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn.kan import KAN, KANConfig, KANLinearConfig, kanfet_config
from fetode_tpu_torch.ops import kanfet_node as kn


@pytest.fixture(scope="module")
def setup():
    jspec = jpp.PredPreyNODE.kanfet(max_steps=256, solver_mode="while")
    jparams = jpp.predprey_init(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    spec = tpp.PredPreyNODE.kanfet(max_steps=256, solver_mode="while")
    model = KAN(spec.kan)
    model.load_state_dict(params_from_numpy(tree))
    ts = np.linspace(0.0, 14.0, 140).astype(np.float32)[:40]
    x0s = np.random.default_rng(1).uniform(0.5, 2.0, (4, 2)).astype(np.float32)
    # The interpret-mode Pallas solve is the slow part: run it once.
    pallas = np.asarray(pallas_kanfet_solve(
        jparams, jspec.kan, jnp.asarray(x0s), jnp.asarray(ts), rtol=jspec.rtol,
        atol=jspec.atol, max_steps=256, interpret=True))
    return dict(jspec=jspec, jparams=jparams, tree=tree, spec=spec,
                model=model, ts=ts, x0s=x0s, pallas=pallas)


def _vmap_predict(jparams, jspec, x0s, ts):
    return np.asarray(jax.vmap(lambda x0: jpp.predict(jparams, jspec, x0, ts))(
        jnp.asarray(x0s)))


def _reference(s, x0s, ts, **kw):
    with torch.no_grad():
        return kn.kanfet_solve_reference(
            s["model"], s["spec"].kan, torch.from_numpy(x0s),
            torch.from_numpy(ts), rtol=1e-7, atol=1e-9, **kw).numpy()


def test_reference_matches_pallas_interpret(setup):
    """1e-3: the JAX package's own kernel tolerance
    (tests/test_pallas_node.py)."""
    out = _reference(setup, setup["x0s"], setup["ts"], max_steps=256)
    assert out.shape == setup["pallas"].shape == (4, 40, 2)
    np.testing.assert_allclose(out, setup["pallas"], rtol=1e-3, atol=1e-3)


def test_reference_matches_vmap_predict_float32(setup):
    """1e-4 at rtol 1e-7 with the full budget: the step sequences differ at
    the float32 rounding floor of the error estimate, and each solution
    is accurate to ~1e-6 on this horizon."""
    ref = _vmap_predict(setup["jparams"], setup["jspec"], setup["x0s"],
                        jnp.asarray(setup["ts"]))
    out = _reference(setup, setup["x0s"], setup["ts"], max_steps=256)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_steps", [256, 8])
def test_reference_matches_vmap_predict_float64(setup, max_steps):
    """Step for step in float64 (1e-8), where the error estimate is far
    above rounding, so a budget of 8 attempts stops both solvers at the
    same step.  The budget counts attempts, accepted and rejected; the
    unreached tail holds the last state."""
    jparams64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       setup["jparams"])
    jspec = setup["jspec"]._replace(max_steps=max_steps)
    ts, x0s = setup["ts"].astype(np.float64), setup["x0s"].astype(np.float64)
    ref = _vmap_predict(jparams64, jspec, x0s, jnp.asarray(ts))
    model64 = KAN(setup["spec"].kan, dtype=torch.float64)
    model64.load_state_dict(params_from_numpy(setup["tree"]))
    with torch.no_grad():
        out = kn.kanfet_solve_reference(
            model64, setup["spec"].kan, torch.from_numpy(x0s),
            torch.from_numpy(ts), max_steps=max_steps).numpy()
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)
    if max_steps == 8:
        assert np.all(out[:, -1] == out[:, -2])       # stopped before ts[-1]


def test_wrapper_on_cpu_is_the_reference(setup):
    s = setup
    before = kn.kanfet_solve.launches
    with torch.no_grad():
        out = kn.kanfet_solve(s["model"], s["spec"].kan,
                              torch.from_numpy(s["x0s"]),
                              torch.from_numpy(s["ts"]), max_steps=256)
    np.testing.assert_array_equal(
        out.numpy(), _reference(s, s["x0s"], s["ts"], max_steps=256))
    assert kn.kanfet_solve.launches == before      # no kernel on the CPU


def test_wrapper_validation(setup):
    s = setup
    x0s, ts = torch.from_numpy(s["x0s"]), torch.from_numpy(s["ts"])
    plain = KANConfig(layers=tuple(
        KANLinearConfig(in_features=i, out_features=o, ferro_num_basis=0)
        for i, o in ((2, 10), (10, 2))))
    with pytest.raises(ValueError, match="KANFET"):
        kn.kanfet_solve(s["model"], plain, x0s, ts)
    with pytest.raises(ValueError, match="D -> D"):
        kn.kanfet_solve(s["model"], kanfet_config([2, 10, 3]), x0s, ts)
    with pytest.raises(TypeError):
        kn.kanfet_solve(s["model"], s["spec"].kan, x0s.double(), ts)
    with pytest.raises(ValueError):
        kn.kanfet_solve(s["model"], s["spec"].kan, x0s[0], ts)
    with pytest.raises(ValueError):
        kn.kanfet_solve(s["model"], s["spec"].kan, x0s, ts[:0])


def test_kernel_geometry_bounds():
    """The kernels take every pure-KANFET stack with D <= 32: any depth,
    widths, grid, order and K, parameters past the old 48 KB included
    (they go to global memory past the block's shared memory).  They
    refuse only the JAX kernels' refusals, per-layer order, grid, gate or
    alpha that differ from layer 0's, and D > 32."""
    flagship = kanfet_config([2, 10, 2])
    geo = kn.stack_geometry(flagship)
    assert (geo["D"], geo["L"], geo["n_knots"], geo["C"]) == (2, 2, 12, 8)
    assert geo["table"] == [(2, 10, 8, 0, 0, 0), (10, 2, 8, 1004, 980, 2)]
    for cfg, L in ((kanfet_config([2, 4, 4, 2]), 3),
                   (kanfet_config([3, 10, 3]), 2),
                   (kanfet_config([2, 10, 2], grid_size=8), 2),
                   (kanfet_config([2, 128, 2], ferro_num_basis=8), 2),
                   (kanfet_config([1, 3, 5, 1], spline_order=0), 3),
                   (kanfet_config([32, 4, 32]), 2)):
        assert kn.stack_geometry(cfg)["L"] == L
    plain = KANConfig(layers=tuple(
        KANLinearConfig(in_features=i, out_features=o, ferro_num_basis=0)
        for i, o in ((2, 10), (10, 2))))
    with pytest.raises(ValueError, match="KANFET"):
        kn.stack_geometry(plain)
    with pytest.raises(ValueError, match="D -> D"):
        kn.stack_geometry(kanfet_config([2, 10, 3]))
    for field, value in (("grid_size", 7), ("spline_order", 2),
                         ("ferro_gate_slope", 3.0), ("ferro_alpha", 0.5)):
        layers = list(kanfet_config([2, 10, 2]).layers)
        layers[1] = layers[1]._replace(**{field: value})
        with pytest.raises(ValueError, match="across layers"):
            kn.stack_geometry(KANConfig(layers=tuple(layers)))
    with pytest.raises(ValueError, match="D <= 32"):
        kn.stack_geometry(kanfet_config([33, 4, 33]))


def test_pack_params_layout(setup):
    """The packed vector holds what ``pallas_node.py:302-318`` hands its
    kernel, in the same layouts, layer after layer."""
    s = setup
    packed = kn.pack_params(s["model"], s["spec"].kan).numpy()
    expect = []
    for p, c in zip(s["tree"], s["spec"].kan.layers):
        sw = p["spline_weight"] * p["spline_scaler"][..., None]
        fe = p["ferro"]
        expect += [p["base_weight"], sw.reshape(c.out_features, -1),
                   p["_buffers"]["grid"]]
        expect += [fe[k].reshape(-1) for k in ("k", "ec", "ps", "bias", "coef")]
    expect = np.concatenate([e.reshape(-1) for e in expect])
    assert packed.dtype == np.float32
    assert packed.size == kn.stack_geometry(s["spec"].kan)["n_params"]
    np.testing.assert_allclose(packed, expect, rtol=1e-7, atol=0)


def test_predict_dispatch(setup):
    s = setup
    x0 = torch.from_numpy(s["x0s"][0])
    ts = torch.from_numpy(s["ts"])
    pallas = s["spec"]._replace(solver_mode="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tpp.predict(s["model"], pallas, x0, ts)        # kernel needs CUDA
    with pytest.raises(ValueError, match="CUDA"):
        tpp.predict_batch(s["model"], pallas, x0[None], ts)
    auto = s["spec"]._replace(solver_mode="auto")
    with torch.no_grad():
        one = tpp.predict(s["model"], auto, x0, ts)     # eager on the CPU
        rows = tpp.predict_batch(s["model"], auto,
                                 torch.from_numpy(s["x0s"]), ts)
    ref = np.asarray(jpp.predict(s["jparams"], s["jspec"], jnp.asarray(
        s["x0s"][0]), jnp.asarray(s["ts"])))
    np.testing.assert_allclose(one.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(rows.numpy(), _reference(
        s, s["x0s"], s["ts"], max_steps=256))
    # the eager 'auto' solve under autograd is the differentiable mode:
    # the same values, with a gradient
    grad_one = tpp.predict(s["model"], auto, x0, ts)
    assert grad_one.requires_grad
    np.testing.assert_array_equal(grad_one.detach().numpy(), one.numpy())
    # a fixed-step method runs eager in every mode, as the JAX package's
    with torch.no_grad():
        rk4 = tpp.predict(s["model"], s["spec"]._replace(method="rk4"), x0,
                          ts)
    want = np.asarray(jpp.predict(s["jparams"], s["jspec"]._replace(
        method="rk4"), jnp.asarray(s["x0s"][0]), jnp.asarray(s["ts"])))
    np.testing.assert_allclose(rk4.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_kernel_matches_reference_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    model = KAN(s["spec"].kan, device=dev)
    model.load_state_dict(params_from_numpy(s["tree"], dev))
    x0s = torch.from_numpy(s["x0s"]).to(dev)
    ts = torch.from_numpy(s["ts"]).to(dev)
    before = kn.kanfet_solve.launches
    with torch.no_grad():
        out = kn.kanfet_solve(model, s["spec"].kan, x0s, ts, max_steps=256)
        ref = kn.kanfet_solve_reference(model, s["spec"].kan, x0s, ts,
                                        max_steps=256)
    torch.cuda.synchronize()
    assert kn.kanfet_solve.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.cpu().numpy(), s["pallas"], rtol=1e-3,
                               atol=1e-3)
