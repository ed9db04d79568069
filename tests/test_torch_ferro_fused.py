"""PyTorch port, the fused ferro layer op (``ops/ferro_fused.py``, B.13)
against the JAX package's ``fetode_tpu/ops/pallas_ferro.py``.

On the CPU ``ferro_apply_fused`` is its plain version, ``ferro_apply``;
it is held against the JAX kernel run in interpret mode
(``ferro_apply_fused_interpret``) at the JAX test's dims, with a state
that has a history, in float32 and with a bfloat16 state, and its
gradients against the JAX custom-VJP entry run as
``tests/test_pallas_ferro.py`` runs it (the forward forced to interpret
mode).  The backward the CUDA path takes (``ferro_fused_vjp``: the plain
op recomputed, its VJP) is held against autograd of the plain op.
Tolerance 1e-5, ``tests/test_pallas_ferro.py``'s: float32 arithmetic in a
different order (the TPU kernel sums over inputs, then folds K).  A
bfloat16 branch may differ by one bfloat16 unit where the float32 target
sits at a rounding boundary.  The kernel itself runs only on the card
(the ``cuda`` test here, and ``chip_smoke.py`` phase 36).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fetode_tpu.ops.pallas_ferro as jpf
from fetode_tpu.ops import ferro as jferro
from fetode_tpu_torch.ops import ferro as tferro
from fetode_tpu_torch.ops import ferro_fused as FF

B = 9
BF16_ULP = 2.0 ** -7     # one bfloat16 unit in [0.5, 1); the branch is in [-1, 1]


def _case(dims, seed=0, dtype=np.float32):
    """JAX params from PRNGKey(seed), a state after one call on a random
    field, and the next input, all of ``dtype``."""
    in_d, out_d, K = dims
    cfg = jferro.FerroConfig(in_d, out_d, K)
    params = jferro.ferro_init(jax.random.PRNGKey(seed), cfg, dtype)
    rng = np.random.default_rng(seed + 7)
    x_prev = rng.standard_normal((B, in_d)).astype(dtype)
    x = rng.standard_normal((B, in_d)).astype(dtype)
    return cfg, params, x_prev, x


def _torch_params(cfg, params):
    p = tferro.FerroParams(tferro.FerroConfig(*cfg[:3]),
                           dtype=getattr(torch, str(params.k.dtype)))
    with torch.no_grad():
        for name in FF._NAMES:
            getattr(p, name).copy_(torch.from_numpy(
                np.array(getattr(params, name))))
    return p


def _states(cfg, params, x_prev, dtype):
    """The JAX and port states of ``dtype`` after one plain call on
    ``x_prev``."""
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    js0 = jferro.ferro_state_init((B,), cfg, jd)
    _, js = jferro.ferro_apply(params, js0, jnp.asarray(x_prev), cfg)
    tcfg = tferro.FerroConfig(*cfg[:3])
    ts0 = tferro.ferro_state_init((B,), tcfg, dtype=td)
    _, ts = tferro.ferro_apply(_torch_params(cfg, params), ts0,
                               torch.from_numpy(x_prev), tcfg)
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 10, 8), (3, 5, 12), (1, 1, 1)])
def test_fused_matches_jax_kernel(dims, dtype):
    cfg, params, x_prev, x = _case(dims)
    js, ts = _states(cfg, params, x_prev, dtype)
    y_j, s_j = jpf.ferro_apply_fused_interpret(params, js, jnp.asarray(x),
                                               cfg)
    tcfg = tferro.FerroConfig(*cfg[:3])
    with torch.no_grad():
        y_t, s_t = FF.ferro_apply_fused(_torch_params(cfg, params), ts,
                                        torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    assert s_t.branch.dtype == getattr(torch, dtype)
    assert s_t.prev_x.dtype == getattr(torch, dtype)
    tol = BF16_ULP if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(s_t.branch.float().numpy(),
                               np.asarray(s_j.branch, np.float32), atol=tol)
    np.testing.assert_array_equal(s_t.prev_x.float().numpy(),
                                  np.asarray(s_j.prev_x, np.float32))


def test_fused_gradients_match_jax_custom_vjp(monkeypatch):
    """Gradients of sum(y**2) through the JAX package's public fused entry
    (its custom VJP, the forward forced to interpret mode) and through the
    port's, parameters and input, at a state with a history; float64, so
    1e-5 compares the two functions and not float32 rounding (the loss
    sums squares of order 30)."""
    cfg, params, x_prev, x = _case((2, 4, 8), seed=3, dtype=np.float64)
    js, ts = _states(cfg, params, x_prev, "float64")
    orig = jpf._fused_fwd_impl
    monkeypatch.setitem(jpf.__dict__, "_fused_fwd_impl",
                        lambda p, s, xx, c, interpret=True: orig(
                            p, s, xx, c, interpret=True))

    def loss(p, xx):
        y, _ = jpf.ferro_apply_fused(p, js, xx, cfg)
        return jnp.sum(y ** 2)

    g_p, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = _torch_params(cfg, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = FF.ferro_apply_fused(tp, ts, xt, tferro.FerroConfig(*cfg[:3]))
    torch.sum(y ** 2).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-5,
                               atol=1e-5)
    for name in FF._NAMES:
        np.testing.assert_allclose(getattr(tp, name).grad.numpy(),
                                   np.asarray(getattr(g_p, name)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gate_impl", ["sigmoid", "tanh"])
def test_backward_recompute_matches_autograd(gate_impl):
    """``ferro_fused_vjp`` (the CUDA path's backward) against autograd of
    the plain op, float64, a bfloat16-free state with a history."""
    cfg = tferro.FerroConfig(3, 5, 4, gate_impl=gate_impl)
    g = torch.Generator().manual_seed(0)
    p = tferro.ferro_init(g, cfg, dtype=torch.float64)
    rng = np.random.default_rng(1)
    s0 = tferro.ferro_state_init((4,), cfg, dtype=torch.float64)
    _, s = tferro.ferro_apply(p, s0, torch.from_numpy(
        rng.standard_normal((4, 3))), cfg)
    x = torch.from_numpy(rng.standard_normal((4, 3))).requires_grad_(True)
    ybar = torch.from_numpy(rng.standard_normal((4, 5)))
    y, _ = tferro.ferro_apply(p, s, x, cfg)
    want = torch.autograd.grad(y, [x] + [getattr(p, n) for n in FF._NAMES],
                               ybar)
    xbar, wbars = FF.ferro_fused_vjp(ybar, x, [getattr(p, n)
                                               for n in FF._NAMES],
                                     s.prev_x, s.branch, cfg)
    for a, b in zip([xbar] + wbars, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_update_branch_false_keeps_the_old_branch():
    cfg, params, x_prev, x = _case((3, 5, 12), seed=5)
    _, ts = _states(cfg, params, x_prev, "float32")
    tp = _torch_params(cfg, params)
    xt = torch.from_numpy(x)
    frozen = tferro.FerroConfig(*cfg[:3], update_branch=False)
    with torch.no_grad():
        y0, s0 = FF.ferro_apply_fused(tp, ts, xt, frozen)
        y1, s1 = FF.ferro_apply_fused(tp, ts, xt,
                                      tferro.FerroConfig(*cfg[:3]))
    assert s0.branch is ts.branch
    np.testing.assert_array_equal(y0.numpy(), y1.numpy())
    assert not torch.equal(s1.branch, ts.branch)
    np.testing.assert_array_equal(s0.prev_x.numpy(), x)


def test_refusals():
    cfg = tferro.FerroConfig(2, 3, 4)
    p = tferro.ferro_init(torch.Generator().manual_seed(0), cfg)
    s = tferro.ferro_state_init((5,), cfg)
    x = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="noise"):
        FF.ferro_apply_fused(p, s, x, cfg._replace(noise_std=0.1))
    with pytest.raises(ValueError, match="do not match"):
        FF.ferro_apply_fused(p, s, torch.zeros((4, 2)), cfg)
    with pytest.raises(ValueError, match="must be"):
        FF.ferro_apply_fused(p, s, x, cfg._replace(out_dim=2))
    with pytest.raises(ValueError, match="CUDA"):   # the kernel: CUDA only
        FF._launch(x, [getattr(p, n) for n in FF._NAMES], s.prev_x,
                   s.branch, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg = tferro.FerroConfig(64, 64, 12)
    p = tferro.ferro_init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(2)
    s = tferro.ferro_state_init((8,), cfg, device=dev,
                                dtype=getattr(torch, dtype))
    _, s = tferro.ferro_apply(p, s, torch.from_numpy(rng.standard_normal(
        (8, 64)).astype(np.float32)).to(dev), cfg)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)
                         ).to(dev)
    n = FF.ferro_apply_fused.launches
    y, s1 = FF.ferro_apply_fused(p, s, x, cfg)
    torch.cuda.synchronize()
    assert FF.ferro_apply_fused.launches == n + 1
    y_r, s_r = tferro.ferro_apply(p, s, x, cfg)
    scale = float(y_r.abs().max())
    assert float((y - y_r).abs().max()) <= 1e-4 * scale + 1e-4
    tol = BF16_ULP if dtype == "bfloat16" else 1e-5
    assert float((s1.branch.float() - s_r.branch.float()).abs().max()) <= tol
