"""PyTorch port, the custom-field whole-solve example
(``fetode_tpu_torch/examples/custom_field_kernel.py``, B.14) against the
JAX package's ``examples/02_custom_field_kernel.py``.

The JAX example is loaded from its file (``importlib``; it is not a
package module) and its solver run in Pallas interpret mode
(``make_my_solver(4, 8, interpret=True)``) on seeded numpy inputs at the
example's shapes (D = 4, H = 8, B = 3, rtol 1e-4 / atol 1e-6, 32
attempts).  On the CPU the port's wrappers are their plain versions
(``ops/node_common.py``'s recording solve and the autograd of its
replay): the final state within 1e-5 (float32 sums in another order),
the gradients of w1, w2 and h0 within 1e-4 relative (the JAX kernel's
hand-written adjoint against autograd of the replay), and the same
attempt count and end time in the records.  The CUDA kernels run only on
the card (the ``cuda`` test here, and ``chip_smoke.py`` phase 41).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu_torch.examples import custom_field_kernel as CF
from fetode_tpu_torch.ops import node_common as NC

ROOT = Path(__file__).resolve().parent.parent
D, H, B, M = 4, 8, 3, 32
OPTS = dict(rtol=1e-4, atol=1e-6, max_steps=M)


@pytest.fixture(scope="module")
def jex():
    spec = importlib.util.spec_from_file_location(
        "custom_field_example", ROOT / "examples" / "02_custom_field_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((H, D))).astype(np.float32), \
        (scale * rng.standard_normal((D, H))).astype(np.float32), \
        rng.standard_normal((B, D)).astype(np.float32)


def _jax_misc(jex, w1, w2, h0):
    """The JAX example's forward kernel called as its solver calls it
    (``_fwd_call``), for its records' [attempts, t_end]."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    f32 = jnp.float32
    vm = pl.BlockSpec(memory_space=pltpu.VMEM)
    outs = [jax.ShapeDtypeStruct((B, D), f32),
            jax.ShapeDtypeStruct((M, 4), f32),
            jax.ShapeDtypeStruct((M, B, D), f32),
            jax.ShapeDtypeStruct((M, 7, B, D), f32),
            jax.ShapeDtypeStruct((1, 4), f32)]
    res = pl.pallas_call(
        jex._fwd_kernel(B, D, H, M, OPTS["rtol"], OPTS["atol"]),
        out_shape=outs, in_specs=[vm] * 4, out_specs=[vm] * 5,
        scratch_shapes=[pltpu.VMEM((7 * B, D), f32)], interpret=True,
    )(jnp.asarray(h0), jex.tableau_table(), jnp.asarray(w1), jnp.asarray(w2))
    return np.asarray(res[4])[0]


@pytest.mark.parametrize("seed,scale", [(0, 0.5), (1, 1.5)])
def test_solve_and_gradients_match_jax(jex, seed, scale):
    w1, w2, h0 = _inputs(seed, scale)
    jsolve = jex.make_my_solver(D, H, interpret=True)
    args = [jnp.asarray(a) for a in (w1, w2, h0)]
    hT_j = np.asarray(jsolve(*args))
    g_j = jax.grad(lambda *a: jnp.sum(jsolve(*a) ** 2),
                   argnums=(0, 1, 2))(*args)

    solve = CF.make_my_solver(D, H, device="cpu")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (w1, w2, h0)]
    hT = solve(*leaves)
    g_t = torch.autograd.grad(torch.sum(hT ** 2), leaves)
    np.testing.assert_allclose(hT.detach().numpy(), hT_j, atol=1e-5)
    for a, b in zip(g_t, g_j):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 1e-4 * np.linalg.norm(b)

    _, recs = CF.custom_field_fwd(*(torch.from_numpy(a) for a in
                                    (w1, w2, h0)), **OPTS)
    misc_j = _jax_misc(jex, w1, w2, h0)
    assert int(recs.misc[0]) == int(misc_j[0]) >= 1
    assert abs(float(recs.misc[1]) - float(misc_j[1])) <= 1e-6


def test_wrappers_are_the_plain_versions_on_cpu():
    w1, w2, h0 = (torch.from_numpy(a) for a in _inputs(2))
    field = CF.tanh_mlp_field(w1, w2)
    n = CF.custom_field_fwd.launches, CF.custom_field_bwd.launches
    hT, recs = CF.custom_field_fwd(w1, w2, h0, **OPTS)
    hT_r, recs_r = NC.record_solve_reference(field, h0, **OPTS)
    assert torch.equal(hT, hT_r) and torch.equal(recs.tda, recs_r.tda)
    hn, none = CF.custom_field_fwd(w1, w2, h0, record=False, **OPTS)
    assert none is None and torch.equal(hn, hT)
    hbar = torch.ones_like(hT)
    (gw1, gw2), h0bar = CF.custom_field_bwd(w1, w2, h0, recs, hbar)
    leaves = [t.clone().requires_grad_(True) for t in (w1, w2)]
    (rw1, rw2), rh0 = NC.replay_vjp_reference(CF.tanh_mlp_field(*leaves),
                                              leaves, h0, recs, hbar)
    assert torch.equal(gw1, rw1) and torch.equal(gw2, rw2)
    assert torch.equal(h0bar, rh0)
    # no kernel launched on the CPU
    assert (CF.custom_field_fwd.launches, CF.custom_field_bwd.launches) == n
    # the solve without autograd is the forward without records
    with torch.no_grad():
        assert torch.equal(CF.make_my_solver(D, H, device="cpu")(w1, w2, h0),
                           hT)


def test_refusals():
    w1, w2, h0 = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="made for"):
        CF.make_my_solver(D, H, device="cuda")(w1, w2, h0)
    with pytest.raises(ValueError, match=r"w1 must be"):
        CF.make_my_solver(D, H + 1, device="cpu")(w1, w2, h0)
    with pytest.raises(ValueError, match="w2"):
        CF.custom_field_fwd(w1, w2.T, h0)


def test_example_module_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "fetode_tpu_torch.examples.custom_field_kernel",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        "custom-field whole-solve kernel: forward + adjoint verified"


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    w1, w2, h0 = (torch.from_numpy(a).to(dev) for a in _inputs())
    hT, recs = CF.custom_field_fwd(w1, w2, h0, **OPTS)
    torch.cuda.synchronize()
    hT_r, recs_r = NC.record_solve_reference(CF.tanh_mlp_field(w1, w2), h0,
                                             **OPTS)
    assert int(recs.misc[0]) == int(recs_r.misc[0])
    torch.testing.assert_close(hT, hT_r, rtol=1e-5, atol=1e-5)
    hbar = torch.ones_like(hT)
    g, h0bar = CF.custom_field_bwd(w1, w2, h0, recs, hbar)
    leaves = [t.clone().requires_grad_(True) for t in (w1, w2)]
    g_r, h0bar_r = NC.replay_vjp_reference(CF.tanh_mlp_field(*leaves),
                                           leaves, h0, recs, hbar)
    for a, b in zip(list(g) + [h0bar], list(g_r) + [h0bar_r]):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())


# ------------------------------------------------ the row plan (CPU)


@pytest.mark.parametrize("B", [1, 3, 8, 63, 64, 65, 256, 257])
@pytest.mark.parametrize("D,H", [(4, 8), (64, 128)], ids=["example", "wide"])
def test_row_plan_covers_every_row_once(D, H, B):
    """``row_plan``: every row is owned by exactly one CTA, in order; up to
    64 rows one cluster of at most 16 CTAs of ceil(B / 16) rows, past them
    a cooperative grid of 4-row CTAs; the weights and rows in shared
    memory at these widths, a CTA within 227 KB, forward and backward."""
    for bwd in (False, True):
        p = CF.row_plan(B, D, H, bwd)
        assert [b for rg in p["rows"] for b in rg] == list(range(B))
        assert len(p["rows"]) == p["C"] and all(len(rg) for rg in p["rows"])
        if B <= 64:
            assert not p["grid"] and p["C"] <= 16
            assert p["R"] == -(-B // 16)
        else:
            assert p["grid"] and p["R"] == 4
            assert max(len(rg) for rg in p["rows"]) == 4
        assert p["smem"] and p["smem_bytes"] <= 232448 - 2048
        assert p["tiles"] == 2 * (-(-D // 4)) * (-(-H // 4))
        # backward: every CTA's gradient tiles in device scratch
        assert p["work_floats"] >= (16 * p["tiles"] * p["C"] if bwd else 0)


def test_row_plan_places_wide_fields_in_device_memory():
    """Weights that do not fit a CTA go to device memory the CTA owns, with
    its rows, and the scratch grows by a copy a CTA (phase 41's wide case,
    D = 64, H = 512); a batch of 0 rows is refused."""
    for bwd in (False, True):
        p = CF.row_plan(8, 64, 512, bwd)            # w1, w2: 271 KB
        assert not p["smem"] and p["smem_bytes"] <= 4 * 4096
        assert p["work_floats"] >= 8 * (512 * 68 + 64 * 516)
    assert CF.row_plan(8, 4, 8, bwd=True)["smem"]
    with pytest.raises(ValueError, match="B must be"):
        CF.row_plan(0, 4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 64, 67, 256])
def test_row_plan_matches_library_on_card(B):
    """The library's ``custom_field_plan`` is ``row_plan``'s (the wrapper
    checks it before a launch; here at the phase-41 shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the library is built there")
    for D, H in ((4, 8), (64, 128)):
        CF._check_plan.cache_clear()
        CF._check_plan(B, D, H)
