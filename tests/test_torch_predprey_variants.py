"""PyTorch port, the predprey variants of ``models/predprey.py`` (the
Euler rollout, the residual-MLP head after and inside the solve, the
logistic KAN-RNN delta model) and ``nn/mlp.py``'s residual head, against
the JAX package's, at the reference's widths: KAN [2, 10, 2], grid 5,
K = 8, head bottleneck 32; the RNN at seq_len 16, hidden 64, 10 bases.

Parameters are initialised by the JAX package in float64 and converted
(``convert.predprey_head_params_from_numpy``,
``convert.predprey_rnn_params_from_numpy``); both sides run in float64
on the same numpy inputs.  Tolerances:
* the residual head, a closed form: 1e-10;
* the Euler rollout (34 steps, dt = 1/34), the head variants (dopri5 at
  the flagship rtol 1e-7 / atol 1e-9 over the 35 fit times, and rk4) and
  the RNN delta and rollout (36 times): 1e-6, as are the gradients of
  the Euler rollout's and the RNN delta's losses (relative to the
  largest entry).  The dopri5 solves take the same steps; XLA's jitted
  float64 ``pow`` moves the JAX step sizes by ~1e-10 relative, far
  below 1e-6.

The CPU tensors take the eager paths; the cases marked ``cuda`` (skipped
without a card) hold the dispatch on the card: the head after the solve
launches B.1 (B.2 under autograd), the head inside the field B.12 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as JP
from fetode_tpu.nn import mlp as JM
from fetode_tpu_torch.convert import (
    grads_to_numpy,
    params_from_numpy,
    predprey_head_params_from_numpy,
    predprey_rnn_params_from_numpy,
)
from fetode_tpu_torch.models import predprey as TP
from fetode_tpu_torch.nn import mlp as TM

TOL = 1e-6
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _ts():
    return np.linspace(0.0, 3.5, 35)


def test_residual_head_matches_jax():
    cfg = JM.ResidualHeadConfig(dim=2, bottleneck=32)
    p = _np(JM.residual_head_init(jax.random.PRNGKey(3), cfg, jnp.float64))
    y = np.random.default_rng(0).normal(size=(7, 2))
    want = JM.residual_head_apply(p, cfg, jnp.asarray(y))
    head = TM.residual_head_init(torch.Generator().manual_seed(0),
                                 TM.ResidualHeadConfig(2, 32), dtype=F64)
    head.load_state_dict({f"{i}.{k}": _t(v) for i, layer in enumerate(p)
                          for k, v in layer.items()})
    got = TM.residual_head_apply(head, TM.ResidualHeadConfig(2, 32), _t(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-10, atol=1e-10)


def _kan(seed=0):
    spec = JP.PredPreyNODE.kanfet()
    tree = _np(JP.predprey_init(jax.random.PRNGKey(seed), spec, jnp.float64))
    tspec = TP.PredPreyNODE.kanfet()
    kan = TP.predprey_init(torch.Generator().manual_seed(0), tspec, dtype=F64)
    kan.load_state_dict(params_from_numpy(tree, dtype=F64))
    return spec, tree, tspec, kan


def test_euler_rollout_matches_jax():
    spec, tree, tspec, kan = _kan(1)
    x0 = np.random.default_rng(1).uniform(0.5, 2.0, (3, 2))
    want = JP.euler_rollout_predict(jax.tree_util.tree_map(jnp.asarray, tree),
                                    spec, jnp.asarray(x0), 34)
    got = TP.euler_rollout_predict(kan, tspec, _t(x0), 34)
    assert got.shape == (35, 3, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)

    def jloss(p):
        return jnp.sum(JP.euler_rollout_predict(p, spec, jnp.asarray(x0),
                                                34) ** 2)
    gj = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, tree))
    (got ** 2).sum().backward()
    gt = grads_to_numpy(kan, np.float64)
    flat_j, flat_t = [], []
    for lj, lt in zip(gj, gt):
        lj = dict(lj, _buffers={"grid": np.zeros_like(lt["_buffers"]["grid"])})
        flat_j += jax.tree_util.tree_leaves(_np(lj))
        flat_t += jax.tree_util.tree_leaves(lt)
    scale = max(np.abs(a).max() for a in flat_j)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale)


def _head_case(inside, method, seed=2):
    kw = dict(method=method)
    jspec = JP.PredPreyNODEWithHead.make(head_inside=inside, **kw,
                                         solver_mode="while")
    tspec = TP.PredPreyNODEWithHead.make(head_inside=inside, **kw)
    tree = _np(JP.predprey_head_init(jax.random.PRNGKey(seed), jspec,
                                     jnp.float64))
    params = TP.predprey_head_init(torch.Generator().manual_seed(0), tspec,
                                   dtype=F64)
    params.load_state_dict(predprey_head_params_from_numpy(tree, dtype=F64))
    return jspec, tspec, jax.tree_util.tree_map(jnp.asarray, tree), params


@pytest.mark.parametrize("inside", [False, True], ids=["after", "inside"])
@pytest.mark.parametrize("method", ["dopri5", "rk4"])
def test_predict_with_head_matches_jax(inside, method):
    jspec, tspec, jtree, params = _head_case(inside, method)
    assert tspec.head == TM.ResidualHeadConfig(2, 32)
    ts = _ts()
    rng = np.random.default_rng(3)
    for x0 in (np.array([1.0, 1.0]), rng.uniform(0.5, 2.0, (3, 2))):
        want = JP.predict_with_head(jtree, jspec, jnp.asarray(x0),
                                    jnp.asarray(ts))
        with torch.no_grad():
            got = TP.predict_with_head(params, tspec, _t(x0), _t(ts))
        assert got.shape == (35,) + x0.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_head_after_is_head_on_predict():
    """The head after the solve is the head on ``predict``'s trajectory,
    under autograd too (the eager scan solve on the CPU)."""
    _, tspec, _, params = _head_case(False, "dopri5", seed=4)
    x0, ts = _t([1.0, 1.0]), _t(_ts())
    got = TP.predict_with_head(params, tspec, x0, ts)
    traj = TP.predict(params["kan"], tspec.node, x0, ts)
    want = TM.residual_head_apply(params["head"], tspec.head, traj)
    assert torch.equal(got, want) and got.requires_grad


def test_head_variants_refuse_pallas_on_the_cpu():
    """``solver_mode="pallas"`` is the CUDA kernel: a CPU tensor is refused
    where the head is after the solve; inside the field no kernel
    computes the field, and the solve runs eager as under ``"auto"``."""
    _, tspec, _, params = _head_case(False, "dopri5")
    spec = tspec._replace(node=tspec.node._replace(solver_mode="pallas"))
    with pytest.raises(ValueError, match="CUDA"):
        TP.predict_with_head(params, spec, _t([1.0, 1.0]), _t(_ts()))
    spec = spec._replace(head_inside=True)
    auto = spec._replace(node=spec.node._replace(solver_mode="auto"))
    with torch.no_grad():
        assert torch.equal(
            TP.predict_with_head(params, spec, _t([1.0, 1.0]), _t(_ts())),
            TP.predict_with_head(params, auto, _t([1.0, 1.0]), _t(_ts())))


def _rnn_case(seed=5):
    jspec = JP.PredPreyRNN()
    tspec = TP.PredPreyRNN()
    assert (tspec.seq_len, tspec.hidden_size, tspec.num_basis) == (16, 64, 10)
    tree = _np(JP.predprey_rnn_init(jax.random.PRNGKey(seed), jspec,
                                    jnp.float64))
    params = TP.predprey_rnn_init(torch.Generator().manual_seed(0), tspec,
                                  dtype=F64)
    params.load_state_dict(predprey_rnn_params_from_numpy(tree,
                                                          dtype=np.float64))
    return jspec, tspec, jax.tree_util.tree_map(jnp.asarray, tree), params


def test_rnn_delta_and_gradient_match_jax():
    jspec, tspec, jtree, params = _rnn_case()
    rng = np.random.default_rng(6)
    t, xy = rng.uniform(0.0, 3.5, 8), rng.uniform(0.5, 2.0, (8, 2))
    seq = TP.make_txy_seq(_t(t), _t(xy), 16)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(JP.make_txy_seq(
        jnp.asarray(t), jnp.asarray(xy), 16)))

    def jloss(p):
        return jnp.sum(JP.predprey_rnn_delta(p, jspec, jnp.asarray(t),
                                             jnp.asarray(xy)) ** 2)
    want = JP.predprey_rnn_delta(jtree, jspec, jnp.asarray(t),
                                 jnp.asarray(xy))
    got = TP.predprey_rnn_delta(params, tspec, _t(t), _t(xy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    (got ** 2).sum().backward()
    gj = jax.grad(jloss)(jtree)
    grads = dict(params.named_parameters())
    scale = max(float(jnp.abs(g).max())
                for g in jax.tree_util.tree_leaves(gj))
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(grads[name].grad.numpy(), np.asarray(g),
                                   rtol=0, atol=TOL * scale, err_msg=name)


def test_rnn_rollout_matches_jax():
    jspec, tspec, jtree, params = _rnn_case(7)
    t_grid = np.linspace(0.0, 3.5, 36)
    x0 = np.array([1.0, 1.0])
    want = JP.predprey_rnn_rollout(jtree, jspec, jnp.asarray(x0),
                                   jnp.asarray(t_grid))
    with torch.no_grad():
        got = TP.predprey_rnn_rollout(params, tspec, _t(x0), _t(t_grid))
    assert got.shape == (36, 2)
    np.testing.assert_array_equal(got[0].numpy(), x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_head_after_launches_b1_and_b2_on_the_card():
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.ops import kanfet_node as KN

    dev = _cuda()
    spec = TP.PredPreyNODEWithHead.make()
    params = TP.predprey_head_init(torch.Generator().manual_seed(0), spec,
                                   device=dev)
    ts = torch.linspace(0.0, 3.5, 35, device=dev)
    x0 = torch.rand((8, 2), generator=torch.Generator().manual_seed(1)
                    ).to(dev) + 0.5
    KN.kanfet_solve.launches = KA.kanfet_adjoint_fwd.launches = 0
    with torch.no_grad():
        y = TP.predict_with_head(params, spec, x0, ts)
    assert KN.kanfet_solve.launches == 1 and y.shape == (35, 8, 2)
    TP.predict_with_head(params, spec, x0[0], ts).sum().backward()
    assert KA.kanfet_adjoint_fwd.launches == 1


@pytest.mark.cuda
def test_head_inside_launches_only_b12_on_the_card():
    from fetode_tpu_torch.ops import kanfet_node as KN
    from fetode_tpu_torch.ops import spline as SP

    dev = _cuda()
    spec = TP.PredPreyNODEWithHead.make(head_inside=True)
    params = TP.predprey_head_init(torch.Generator().manual_seed(0), spec,
                                   device=dev)
    ts = torch.linspace(0.0, 3.5, 35, device=dev)
    KN.kanfet_solve.launches = SP.spline_matmul_fused.launches = 0
    with torch.no_grad():
        TP.predict_with_head(params, spec, torch.ones(2, device=dev), ts)
    assert KN.kanfet_solve.launches == 0
    assert SP.spline_matmul_fused.launches > 0
