"""PyTorch port, B.1 and B.2 (``ops/kanfet_node.py``,
``ops/kanfet_adjoint.py``) on pure-KANFET stacks other than the flagship,
against the JAX package's ``pallas_kanfet_solve`` and
``make_train_solver`` run in interpret mode, with the stack walk and
placement the CUDA kernels read (``stack_geometry``, ``smem_placement``).

Two stacks that the kernels once refused: [2, 4, 4, 2] at grid 7 (three
layers, 15 knots) and [3, 6, 3] (D = 3), both with K = 4 ferro bases;
parameters from ``PRNGKey(0)``, initial conditions from U[0.5, 2.0] with a
numpy seed.  As in ``tests/test_torch_kanfet_node.py`` the serving solve
runs at rtol 1e-7 / atol 1e-9 on the first 40 of the 140 serving times,
B = 4, and as in ``tests/test_torch_adjoint.py`` the training solve at
rtol 1e-4 / atol 1e-6, 64 attempts, the first 12 fit times, B = 3, the
loss an MSE against a target (the Lotka-Volterra truth for D = 2, a
seeded one for D = 3).  The interpret-mode JAX kernels run once per stack
for the whole module.

Tolerances:
* the plain solve against the JAX serving kernel: 1e-3, the JAX
  package's own kernel tolerance (``tests/test_pallas_node.py``);
* the plain replay of JAX's recorded mesh against JAX's trajectory: 1e-5
  (one mesh, float32 rounding);
* gradients of the port's plain replay on JAX's recorded mesh against
  ``jax.grad`` through the JAX kernels: relative norm 1e-4 (the JAX
  kernel's own bound against its oracle).
The CUDA kernels are held against the plain versions on these stacks by
the ``cuda``-marked test, which skips without a card, and on the card by
``chip_smoke.py`` phase 44.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu.ops import pallas_adjoint as PA
from fetode_tpu.ops.pallas_node import pallas_kanfet_solve
from fetode_tpu_torch.convert import grads_to_numpy, params_from_numpy
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn.kan import KAN, kanfet_config
from fetode_tpu_torch.ops import kanfet_adjoint as KA
from fetode_tpu_torch.ops import kanfet_node as kn

STACKS = {"2-4-4-2-grid7": ((2, 4, 4, 2), 7), "3-6-3": ((3, 6, 3), 5)}
K = 4
RTOL, ATOL, MAX_STEPS, T_FIT, B_FIT = 1e-4, 1e-6, 64, 12, 3
B_SERVE, T_SERVE = 4, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager solves here are many small ops: one torch thread for this
    module (see tests/test_torch_mlp_node.py), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(STACKS))
def stack(request):
    layers, grid = STACKS[request.param]
    D = layers[0]
    jspec = jpp.PredPreyNODE.kanfet(layers_hidden=layers, grid_size=grid,
                                    ferro_num_basis=K, max_steps=MAX_STEPS)
    jparams = jpp.predprey_init(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    spec = tpp.PredPreyNODE.kanfet(layers_hidden=layers, grid_size=grid,
                                   ferro_num_basis=K, max_steps=MAX_STEPS)
    rng = np.random.default_rng(7)
    x_serve = rng.uniform(0.5, 2.0, (B_SERVE, D)).astype(np.float32)
    x_fit = rng.uniform(0.5, 2.0, (B_FIT, D)).astype(np.float32)
    ts_serve = np.linspace(0.0, 14.0, 140).astype(np.float32)[:T_SERVE]
    _, ts_learn, truth = jpp.generate_data(jpp.PredPreyTask())
    ts_fit = np.array(ts_learn[:T_FIT], np.float32)
    target = (np.asarray(truth[:T_FIT], np.float32) if D == 2 else
              rng.uniform(0.5, 2.0, (T_FIT, D)).astype(np.float32))

    pallas = np.asarray(pallas_kanfet_solve(
        jparams, jspec.kan, jnp.asarray(x_serve), jnp.asarray(ts_serve),
        rtol=1e-7, atol=1e-9, max_steps=256, interpret=True))
    solver = PA.make_train_solver(jspec.kan, rtol=RTOL, atol=ATOL,
                                  max_steps=MAX_STEPS, interpret=True)

    def loss(p, x):
        return jnp.mean((solver(p, x, jnp.asarray(ts_fit)) - target) ** 2)

    @jax.jit
    def run(p, x):
        return (solver.fwd_with_records(p, x, jnp.asarray(ts_fit)),
                jax.grad(loss, argnums=(0, 1))(p, x))

    (out, recs), (g_p, g_x) = run(jparams, jnp.asarray(x_fit))
    return dict(layers=layers, grid=grid, jspec=jspec, jparams=jparams,
                tree=tree, spec=spec, x_serve=x_serve, x_fit=x_fit,
                ts_serve=ts_serve, ts_fit=ts_fit, target=target,
                pallas=pallas, out=np.asarray(out),
                recs=[np.asarray(r) for r in recs],
                g_params=jax.tree_util.tree_map(np.asarray, g_p),
                g_x0=np.asarray(g_x))


def _model(s, device=None):
    model = KAN(s["spec"].kan, device=device)
    model.load_state_dict(params_from_numpy(s["tree"], device))
    return model


def _port_records(jrecs):
    """JAX's (tda, yrec, krec, misc) -> the port's AttemptRecords."""
    tda, yrec, krec, misc = jrecs
    rec = np.concatenate([tda, yrec, krec], axis=0).transpose(1, 0, 2)
    # JAX records an attempt of a finished lane with dt = 0: a lane's own
    # attempts are those with dt > 0 (the block runs until all finish).
    n_att = (tda[1] != 0.0).sum(axis=0).astype(np.int32)
    return KA.AttemptRecords(torch.from_numpy(rec), torch.from_numpy(n_att),
                             torch.from_numpy(misc[0, 0].copy()))


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(
        tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_reference_matches_pallas_interpret(stack):
    s = stack
    with torch.no_grad():
        out = kn.kanfet_solve_reference(
            _model(s), s["spec"].kan, torch.from_numpy(s["x_serve"]),
            torch.from_numpy(s["ts_serve"]), rtol=1e-7, atol=1e-9,
            max_steps=256).numpy()
    D = s["layers"][0]
    assert out.shape == s["pallas"].shape == (B_SERVE, T_SERVE, D)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, s["pallas"], rtol=1e-3, atol=1e-3)


def test_replay_on_jax_mesh_reproduces_output(stack):
    s = stack
    recs = _port_records(s["recs"])
    assert int(recs.n_att.max()) >= 2
    with torch.no_grad():
        out = KA.replay_reference(_model(s), s["spec"].kan,
                                  torch.from_numpy(s["x_fit"]),
                                  torch.from_numpy(s["ts_fit"]), recs)
    np.testing.assert_allclose(out.numpy(), s["out"], rtol=1e-5, atol=1e-5)


def test_replay_gradients_on_jax_mesh(stack):
    """The plain replay's autograd on JAX's recorded mesh against
    ``jax.grad`` through the JAX kernels (hand-written VJP)."""
    s = stack
    model = _model(s)
    x0 = torch.from_numpy(s["x_fit"]).requires_grad_(True)
    out = KA.replay_reference(model, s["spec"].kan, x0,
                              torch.from_numpy(s["ts_fit"]),
                              _port_records(s["recs"]))
    loss = torch.mean((out - torch.from_numpy(s["target"])) ** 2)
    loss.backward()
    g = _flat(grads_to_numpy(model, np.float32))
    want = _flat(s["g_params"])
    assert g.shape == want.shape
    assert _rel(g, want) < 1e-4
    assert _rel(x0.grad.numpy(), s["g_x0"]) < 1e-4


def test_pack_params_matches_jax_inputs(stack):
    """The packed vector is what the JAX kernels are handed
    (``pallas_adjoint.py: _flatten_params``, the layout of
    ``pallas_node.py:302-318``), layer after layer, and its length and
    the gradient vector's are the stack walk's."""
    s = stack
    packed = kn.pack_params(_model(s), s["spec"].kan).numpy()
    flat = PA._flatten_params(s["jparams"], s["jspec"].kan.layers)
    want = np.concatenate([np.ravel(np.asarray(a)) for a in flat])
    geo = kn.stack_geometry(s["spec"].kan)
    assert geo["L"] == len(s["layers"]) - 1
    assert packed.size == want.size == geo["n_params"]
    assert KA.n_grad(s["spec"].kan) == geo["n_grad"]
    np.testing.assert_allclose(packed, want, rtol=1e-7, atol=0)


# The placement of the kernels' data on four stacks (K = 8, grid 5): the
# packed parameters in floats, whether they sit in shared memory, and the
# largest in*out*K (predict's dispatch to B.3 from 512 on).
PLACEMENT = {
    (2, 10, 2): (2104, True, 160),
    (2, 128, 2): (26648, True, 2048),
    (2, 24, 24, 2): (33528, True, 4608),
    (2, 64, 64, 2): (214808, False, 32768),
}


@pytest.mark.parametrize("layers", list(PLACEMENT))
def test_smem_placement(layers):
    n_params, in_smem, ferro_n = PLACEMENT[layers]
    geo = kn.stack_geometry(kanfet_config(list(layers)))
    assert (geo["n_params"], geo["ferro_n"]) == (n_params, ferro_n)
    assert geo["fwd"]["params"] == geo["bwd"]["params"] == in_smem
    for kind in ("fwd", "bwd"):
        p = geo[kind]
        assert p["scratch"]               # every warp's scratch fits
        assert p["bytes"] <= kn.SMEM_MAX_BYTES
        assert p["bytes"] == 4 * (
            kn.WARPS * geo["ws_" + kind] + n_params * p["params"]
            + kn.WARPS * geo["n_grad"] * p.get("grads", False))
    # The backward keeps the warps' gradients in shared memory at the
    # flagship, so it holds no per-trajectory gradient scratch; the wider
    # stacks sum them in one global slice a warp.
    assert geo["bwd"]["grads"] == (layers == (2, 10, 2))
    assert KA.grad_rows(geo, 256) == (64 if layers == (2, 10, 2) else 256)
    assert n_params * 4 > 48 * 1024 or layers == (2, 10, 2)


@pytest.mark.parametrize("agree", [True, False])
def test_check_layout(monkeypatch, agree):
    """The wrappers launch only when the library's kWarps and warp-scratch
    sizes (``kanfet_layout``) are the ones ``stack_geometry`` allocated
    by; the library's answer is stubbed here (no card, no nvcc)."""
    geo = kn.stack_geometry(kanfet_config([2, 24, 24, 2]))
    seen = []

    def layout(name, maxw, maxin, sum_in, order):
        seen.append((name, maxw, maxin, sum_in, order))
        ws_bwd = geo["ws_bwd"] if agree else geo["ws_bwd"] + 1
        return (kn.WARPS, geo["ws_fwd"], ws_bwd)

    monkeypatch.setattr(kn, "_library_layout", layout)
    if agree:
        kn.check_layout("kanfet_adjoint", geo)
    else:
        with pytest.raises(RuntimeError, match="ws_bwd"):
            kn.check_layout("kanfet_adjoint", geo)
    assert seen == [("kanfet_adjoint", 24, 24, 50, 3)]


def test_predict_batch_under_pallas(stack):
    """``predict_batch`` under 'pallas' takes the kernels on every stack:
    on a CPU tensor it raises the kernels' ValueError (they need CUDA),
    never a refusal of the stack; under 'auto' it is the eager per-row
    solve, the plain version."""
    s = stack
    model = _model(s)
    x0s = torch.from_numpy(s["x_serve"])
    ts = torch.from_numpy(s["ts_serve"][:8])
    with pytest.raises(ValueError, match="CUDA"):
        tpp.predict_batch(model, s["spec"]._replace(solver_mode="pallas"),
                          x0s, ts)
    with torch.no_grad():
        rows = tpp.predict_batch(model, s["spec"]._replace(solver_mode="auto",
                                                           max_steps=256),
                                 x0s, ts)
        ref = kn.kanfet_solve_reference(model, s["spec"].kan, x0s, ts,
                                        max_steps=256)
    np.testing.assert_array_equal(rows.numpy(), ref.numpy())


@pytest.mark.cuda
def test_kernels_match_plain_on_card(stack):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = stack
    model = _model(s, dev)
    cfg = s["spec"].kan
    xs = torch.from_numpy(s["x_serve"]).to(dev)
    ts = torch.from_numpy(s["ts_serve"]).to(dev)
    with torch.no_grad():
        out = kn.kanfet_solve(model, cfg, xs, ts, max_steps=256)
        ref = kn.kanfet_solve_reference(model, cfg, xs, ts, max_steps=256)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)
    x0s = torch.from_numpy(s["x_fit"]).to(dev)
    tf = torch.from_numpy(s["ts_fit"]).to(dev)
    kw = dict(rtol=RTOL, atol=ATOL, max_steps=MAX_STEPS)
    out, recs = KA.kanfet_adjoint_fwd(model, cfg, x0s, tf, **kw)
    ref, _ = KA.record_attempts_reference(model, cfg, x0s, tf, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    ybar = torch.ones_like(out)
    g, gx = KA.kanfet_adjoint_bwd(model, cfg, x0s, tf, recs, ybar)
    g2, gx2 = KA.kanfet_adjoint_bwd(model, cfg, x0s, tf, recs, ybar)
    w, wx = KA.replay_vjp_reference(model, cfg, x0s, tf, recs, ybar)

    def flat(gs):
        return torch.cat([v.reshape(-1) for v in gs]).cpu().numpy()

    np.testing.assert_array_equal(flat(g), flat(g2))      # no atomics
    assert _rel(flat(g), flat(w)) < 1e-4
    assert _rel(gx.cpu().numpy(), wx.cpu().numpy()) < 1e-4
