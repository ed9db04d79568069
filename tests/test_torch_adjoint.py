"""PyTorch port, the discrete-adjoint training solve
(``ops/kanfet_adjoint.py``) against the JAX package's
``ops/pallas_adjoint.py: make_train_solver`` run in interpret mode.

As in ``tests/test_pallas_adjoint.py``: flagship KANFET [2,10,2], params
from ``PRNGKey(0)``, rtol 1e-4 / atol 1e-6 (the error estimate sits far
above float32 rounding, so both frameworks take the same steps),
max_steps 64, the first 12 fit times; B = 1 (the task's x0) and B = 3
(U[0.5, 2.0] from a numpy seed).  The interpret-mode JAX kernels are the
slow part and run once per batch for the whole module.

Tolerances:
* records and forward output, 1e-5: one step mesh, float32 rounding.
* gradients of the port's plain replay on JAX's recorded mesh against
  ``jax.grad`` through the JAX kernels, relative norm 1e-4 in float32
  (the JAX kernel's own bound against its oracle) and 1e-9 in float64
  against a float64 jnp replay of the same mesh.
The CUDA kernels are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu.ops import pallas_adjoint as PA
from fetode_tpu.solvers.tableaux import DOPRI5, DOPRI5_DENSE_D
from fetode_tpu_torch.convert import grads_to_numpy, params_from_numpy
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn.kan import KAN
from fetode_tpu_torch.ops import kanfet_adjoint as KA

RTOL, ATOL, MAX_STEPS = 1e-4, 1e-6, 64
BATCHES = (1, 3)


def _x0s(B):
    if B == 1:
        return np.asarray([[1.0, 1.0]], np.float32)
    return np.random.default_rng(1).uniform(0.5, 2.0, (B, 2)).astype(
        np.float32)


@pytest.fixture(scope="module")
def setup():
    task = jpp.PredPreyTask()
    _, ts_learn, truth = jpp.generate_data(task)
    ts = np.asarray(ts_learn[:12], np.float32)
    target = np.asarray(truth[:12], np.float32)
    jspec = jpp.PredPreyNODE.kanfet(max_steps=MAX_STEPS)
    jparams = jpp.predprey_init(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    solver = PA.make_train_solver(jspec.kan, rtol=RTOL, atol=ATOL,
                                  max_steps=MAX_STEPS, interpret=True)

    def loss(p, x):
        return jnp.mean((solver(p, x, jnp.asarray(ts)) - target) ** 2)

    # One program per batch: the records and the gradient (whose forward
    # XLA shares with fwd_with_records).
    @jax.jit
    def run(p, x):
        return (solver.fwd_with_records(p, x, jnp.asarray(ts)),
                jax.grad(loss, argnums=(0, 1))(p, x))

    jax_runs = {}
    for B in BATCHES:
        (out, recs), (g_p, g_x) = run(jparams, jnp.asarray(_x0s(B)))
        jax_runs[B] = dict(out=np.asarray(out),
                           recs=[np.asarray(r) for r in recs],
                           g_params=jax.tree_util.tree_map(np.asarray, g_p),
                           g_x0=np.asarray(g_x))
    spec = tpp.PredPreyNODE.kanfet(max_steps=MAX_STEPS)
    return dict(jspec=jspec, jparams=jparams, tree=tree, spec=spec, ts=ts,
                target=target, jax=jax_runs)


def _model(s, dtype=torch.float32):
    model = KAN(s["spec"].kan, dtype=dtype)
    model.load_state_dict(params_from_numpy(s["tree"]))
    return model


def _port_records(jrecs, dtype):
    """JAX's (tda, yrec, krec, misc) -> the port's AttemptRecords."""
    tda, yrec, krec, _ = jrecs
    rec = np.concatenate([tda, yrec, krec], axis=0).transpose(1, 0, 2)
    # JAX records an attempt of a finished lane with dt = 0: a lane's own
    # attempts are those with dt > 0 (the block runs until all finish).
    n_att = (tda[1] != 0.0).sum(axis=0).astype(np.int32)
    t_end = jrecs[3][0, 0]
    return KA.AttemptRecords(torch.from_numpy(rec.astype(dtype)),
                             torch.from_numpy(n_att),
                             torch.from_numpy(t_end.astype(dtype)))


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(
        tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _replay_grads(s, B, dtype):
    """Port: loss of the plain replay on JAX's mesh, backward -> (JAX-tree
    gradient vector, x0 gradient)."""
    model = _model(s, torch.float64 if dtype == np.float64 else torch.float32)
    x0 = torch.from_numpy(_x0s(B).astype(dtype)).requires_grad_(True)
    recs = _port_records(s["jax"][B]["recs"], dtype)
    out = KA.replay_reference(model, s["spec"].kan, x0,
                              torch.from_numpy(s["ts"].astype(dtype)), recs)
    loss = torch.mean((out - torch.from_numpy(s["target"].astype(dtype)))
                      ** 2)
    loss.backward()
    tree = grads_to_numpy(model, dtype)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(s["tree"]))
    return _flat(tree), x0.grad.numpy()


@pytest.mark.parametrize("B", BATCHES)
def test_records_match_jax(setup, B):
    """The plain recording solve against the JAX kernel's records: the same
    attempt counts and accept flags, the first attempt to 1e-5.  Later
    attempts are not compared: the first attempt's error estimate is about
    5e-6 of the tolerance, at float32 rounding, so the two frameworks'
    second step sizes differ (by 14% at B = 1) and the meshes part.  The
    two outputs then agree to the solution tolerance; on one mesh they
    agree to 1e-5 (``test_replay_on_jax_mesh_reproduces_output``)."""
    s = setup
    out, recs = KA.record_attempts_reference(
        _model(s), s["spec"].kan, torch.from_numpy(_x0s(B)),
        torch.from_numpy(s["ts"]), rtol=RTOL, atol=ATOL, max_steps=MAX_STEPS)
    j = s["jax"][B]
    want = _port_records(j["recs"], np.float32)
    n = want.rec.shape[0]
    assert int(j["recs"][3][1, 0, 0]) == int(recs.n_att.max())
    np.testing.assert_array_equal(recs.n_att.numpy(), want.n_att.numpy())
    for b in range(B):
        m = int(recs.n_att[b])
        np.testing.assert_array_equal(recs.rec[:m, 2, b].numpy(),
                                      want.rec[:m, 2, b].numpy())   # accept
        assert not want.rec[m:n, 2, b].any()      # nothing accepted past
        assert not recs.rec[m:, :, b].any()       # the plain records: zeros
    np.testing.assert_allclose(recs.rec[0].numpy(), want.rec[0].numpy(),
                               rtol=1e-5, atol=1e-5)       # t dt accept y k
    np.testing.assert_allclose(out.numpy(), j["out"], rtol=2 * RTOL,
                               atol=2 * RTOL)


@pytest.mark.parametrize("B", BATCHES)
def test_replay_on_jax_mesh_reproduces_output(setup, B):
    """On JAX's recorded mesh the plain replay reproduces the JAX kernel's
    output to 1e-5, and the final times agree."""
    s = setup
    j = s["jax"][B]
    recs = _port_records(j["recs"], np.float32)
    with torch.no_grad():
        out = KA.replay_reference(_model(s), s["spec"].kan,
                                  torch.from_numpy(_x0s(B)),
                                  torch.from_numpy(s["ts"]), recs)
    np.testing.assert_allclose(out.numpy(), j["out"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", BATCHES)
def test_replay_gradients_on_jax_mesh(setup, B):
    """float32: the plain replay's autograd on JAX's recorded mesh against
    ``jax.grad`` through the JAX kernels (hand-written VJP)."""
    g, gx = _replay_grads(setup, B, np.float32)
    j = setup["jax"][B]
    want = _flat(j["g_params"])
    assert g.shape == want.shape
    assert _rel(g, want) < 1e-4
    assert _rel(gx, j["g_x0"]) < 1e-4


def _dot64(a, b, ca, cb):
    """``PA._dot`` without its float32 result type."""
    return jax.lax.dot_general(a, b, (((ca,), (cb,)), ((), ())),
                               precision=jax.lax.Precision.HIGHEST)


def _flatten64(params, cfgs):
    """``PA._flatten_params`` (the kernel's layout) without its casts to
    float32."""
    flat = []
    for pp, c in zip(params, cfgs):
        N = c.in_features * c.out_features * c.ferro_num_basis
        sw = pp["spline_weight"] * pp["spline_scaler"][..., None]
        fe = pp["ferro"]
        flat += [pp["base_weight"], sw.reshape(c.out_features, -1),
                 pp["_buffers"]["grid"]]
        flat += [fe[k].reshape(N, 1) for k in ("k", "ec", "ps", "bias",
                                               "coef")]
    return flat


def _jnp_replay_loss(params, cfg, x0, ts, target, tda, misc):
    """A float64 jnp replay of the recorded attempts with the JAX kernel's
    own field (``PA._layer_forward``; the caller swaps in a float64
    ``_dot``), t, dt and accept held constant, in the (D, B) layout of the
    kernel (``tests/test_pallas_adjoint.py: _replay_loss``, for any B)."""
    cfgs = cfg.layers
    p_ord = cfgs[0].spline_order
    n_knots = cfgs[0].grid_size + 2 * p_ord + 1
    dims = tuple((c.in_features, c.out_features, c.ferro_num_basis)
                 for c in cfgs)
    flat = _flatten64(params, cfgs)
    layers = [flat[i * PA._N_PER_LAYER:(i + 1) * PA._N_PER_LAYER]
              for i in range(len(cfgs))]

    def field(x):
        for d, refs in zip(dims, layers):
            x = PA._layer_forward(x, refs, d, p_ord, n_knots,
                                  cfgs[0].ferro_gate_slope,
                                  cfgs[0].ferro_alpha)
        return x

    tiny = 1e-12
    ts_col = ts[:, None]
    y = x0.T
    out = jnp.broadcast_to(y[:, None, :], (y.shape[0],) + ts_col.shape[:1]
                           + y.shape[1:])
    A, Bw = DOPRI5.a, DOPRI5.b
    for m in range(int(misc[1, 0, 0])):
        t, dt = tda[0, m:m + 1, :], tda[1, m:m + 1, :]
        adv = tda[2, m:m + 1, :] > 0.5
        dt_safe = jnp.where(dt == 0.0, 1.0, dt)
        ks = [field(y)]
        for i in range(1, 7):
            incr = sum(a * k for a, k in zip(A[i][:i], ks) if a != 0.0)
            ks.append(field(y + dt * incr))
        y1 = y + dt * sum(b * k for b, k in zip(Bw, ks) if b != 0.0)
        dy = y1 - y
        r3 = dt * ks[0] - dy
        r4 = dy - dt * ks[6] - r3
        r5 = dt * sum(d * k for d, k in zip(DOPRI5_DENSE_D, ks) if d != 0.0)
        theta = jnp.clip((ts_col - t) / dt_safe, 0.0, 1.0)
        th1 = 1.0 - theta
        write = adv & (ts_col > t) & (ts_col <= t + dt + tiny)
        dense = (y[:, None, :] + theta[None] * (
            dy[:, None, :] + th1[None] * (r3[:, None, :] + theta[None] * (
                r4[:, None, :] + th1[None] * r5[:, None, :]))))
        out = jnp.where(write[None], dense, out)
        y = jnp.where(adv, y1, y)
    unreached = ts_col > misc[0] + tiny
    out = jnp.where(unreached[None], y[:, None, :], out)
    return jnp.mean((jnp.transpose(out, (2, 1, 0)) - target) ** 2)


@pytest.mark.parametrize("B", BATCHES)
def test_replay_gradients_float64(setup, B, monkeypatch):
    """float64, one mesh (JAX's records): the port's replay against
    ``jax.grad`` of a jnp replay built from the JAX kernel's field."""
    monkeypatch.setattr(PA, "_dot", _dot64)
    s = setup
    tda, _, _, misc = [r.astype(np.float64) for r in s["jax"][B]["recs"]]
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 s["jparams"])
    x0 = jnp.asarray(_x0s(B), jnp.float64)
    g_p, g_x = jax.grad(lambda p, x: _jnp_replay_loss(
        p, s["jspec"].kan, x, jnp.asarray(s["ts"], jnp.float64),
        jnp.asarray(s["target"], jnp.float64), tda, misc),
        argnums=(0, 1))(p64, x0)
    for layer in g_p:          # the grid is a buffer: no gradient
        layer["_buffers"]["grid"] = jnp.zeros_like(layer["_buffers"]["grid"])
    g, gx = _replay_grads(s, B, np.float64)
    assert _rel(g, _flat(g_p)) < 1e-9
    assert _rel(gx, np.asarray(g_x)) < 1e-9


def _packed_grad_vector(model, cfg):
    """The parameters the kernels differentiate, in the kernel's gradient
    layout (``pack_params`` without the grid), built with autograd on."""
    parts = []
    for layer, c in zip(model.layers, cfg.layers):
        sw = layer.spline_weight * layer.spline_scaler[..., None]
        fe = layer.ferro
        parts += [layer.base_weight, sw.reshape(c.out_features, -1), fe.k,
                  fe.ec, fe.ps, fe.bias, fe.coef]
    return torch.cat([p.reshape(-1) for p in parts])


def test_unflatten_grads_is_the_chain_rule(setup):
    """The map from the kernel's gradient vector to the module's
    parameters (the spline_scaler chain included) is the transpose of the
    packing: for any v, unflatten_grads(v) = d <packed, v> / d params."""
    s = setup
    model = _model(s)
    cfg = s["spec"].kan
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(
        KA.n_grad(cfg)).astype(np.float32))
    packed = _packed_grad_vector(model, cfg)
    assert packed.numel() == KA.n_grad(cfg)
    weights = KA.train_weights(model)
    want = torch.autograd.grad(torch.dot(packed, v), weights)
    got = KA.unflatten_grads(model, v)
    assert len(got) == len(weights) == 16
    for g, w, p in zip(got, want, weights):
        assert g.shape == p.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_wrappers_on_cpu_are_the_plain_version(setup):
    s = setup
    model = _model(s)
    cfg = s["spec"].kan
    x0s, ts = torch.from_numpy(_x0s(3)), torch.from_numpy(s["ts"])
    kw = dict(rtol=RTOL, atol=ATOL, max_steps=MAX_STEPS)
    before = (KA.kanfet_adjoint_fwd.launches, KA.kanfet_adjoint_bwd.launches)
    out = KA.kanfet_solve_train(model, cfg, x0s, ts, **kw)
    ref = KA.kanfet_solve_train_reference(model, cfg, x0s, ts, **kw)
    assert out.requires_grad
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    out_f, recs = KA.kanfet_adjoint_fwd(model, cfg, x0s, ts, **kw)
    np.testing.assert_array_equal(out_f.numpy(), ref.detach().numpy())
    ybar = torch.ones_like(out_f)
    grads, x0bar = KA.kanfet_adjoint_bwd(model, cfg, x0s, ts, recs, ybar)
    want, want_x = KA.replay_vjp_reference(model, cfg, x0s, ts, recs, ybar)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_array_equal(x0bar.numpy(), want_x.numpy())
    assert (KA.kanfet_adjoint_fwd.launches,
            KA.kanfet_adjoint_bwd.launches) == before   # no kernel on the CPU


def test_wrapper_validation(setup):
    s = setup
    model = _model(s)
    cfg = s["spec"].kan
    x0s, ts = torch.from_numpy(_x0s(3)), torch.from_numpy(s["ts"])
    with pytest.raises(TypeError):
        KA.kanfet_solve_train(model, cfg, x0s.double(), ts.double())
    with pytest.raises(ValueError):
        KA.kanfet_solve_train(model, cfg, x0s[0], ts)
    with pytest.raises(ValueError, match="D -> D"):
        from fetode_tpu_torch.nn.kan import kanfet_config
        KA.kanfet_solve_train(model, kanfet_config([2, 10, 3]), x0s, ts)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    model = KAN(s["spec"].kan, device=dev)
    model.load_state_dict(params_from_numpy(s["tree"], dev))
    cfg = s["spec"].kan
    x0s = torch.from_numpy(_x0s(3)).to(dev)
    ts = torch.from_numpy(s["ts"]).to(dev)
    kw = dict(rtol=RTOL, atol=ATOL, max_steps=MAX_STEPS)
    out, recs = KA.kanfet_adjoint_fwd(model, cfg, x0s, ts, **kw)
    ref, _ = KA.record_attempts_reference(model, cfg, x0s, ts, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    ybar = torch.ones_like(out)
    g, gx = KA.kanfet_adjoint_bwd(model, cfg, x0s, ts, recs, ybar)
    w, wx = KA.replay_vjp_reference(model, cfg, x0s, ts, recs, ybar)
    def flat(gs):
        return torch.cat([v.reshape(-1) for v in gs]).cpu().numpy()

    assert _rel(flat(g), flat(w)) < 1e-4
    assert _rel(gx.cpu().numpy(), wx.cpu().numpy()) < 1e-4
