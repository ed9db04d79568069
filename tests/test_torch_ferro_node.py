"""PyTorch port, the ECG ferro MLP-NODE whole-solve (``ops/ferro_node.py``
on ``ops/node_common.py``) against the JAX package's
``ops/pallas_ferro_node.py: make_ferro_node_solver`` run in interpret
mode, clean and with frozen device noise, and the port's eager model
field against the JAX package's XLA dopri5 solve.

As in ``tests/test_pallas_ferro_node.py``: ``KanFetMLPNODESpec(T=24,
latent_dim=8, ode_hidden=12, num_basis=3, max_steps=16)``, parameters
from ``PRNGKey(0)``, B = 4; the states and the final-state cotangent come
from a numpy seed, the noise (std 0.15) from the JAX package's own
``frozen_solve_noise``, handed to the port as numpy.  Each interpret-mode
JAX kernel (clean, noisy) runs once for the module.

Tolerances:
* float64 eager solves against the XLA solve, step for step: 1e-10.
* records and forward output against the JAX kernel, float32: 1e-5 (the
  error estimates at rtol 1e-2 lie far above float32 rounding: one mesh).
* the port's plain replay gradients on JAX's recorded mesh against
  ``jax.grad`` through the JAX kernel: relative norm 1e-4 (float32; the
  JAX kernel's own bound against its oracle), the coef gradient of the
  noisy form on its own as well.
The kernel's field differs from the eager model field as in the JAX
package: no ``nan_to_num``, and a clip whose gradient passes strictly
inside (-clip, clip); ``test_kernel_field_and_model_field_differ_as_in_jax``
holds both.  The CUDA kernels are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import ecg as JM
from fetode_tpu.ops.ferro import ferro_state_init as j_state_init
from fetode_tpu.ops.pallas_ferro_node import (
    frozen_solve_noise as j_frozen_solve_noise,
    make_ferro_node_solver,
)
from fetode_tpu.solvers.dopri5 import odeint_dopri5 as j_odeint
from fetode_tpu_torch.convert import ecg_params_from_numpy
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.ops import ferro_node as FN
from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.ferro import ferro_state_init
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5

SPEC = dict(T=24, latent_dim=8, ode_hidden=12, num_basis=3, max_steps=16)
B = 4
NOISE_STD = 0.15
NAMES = ("k", "ec", "ps", "bias", "coef")


def _jax_run(jspec, jparams, h0, hbar, noisy):
    c1, c2 = jspec.fc1_cfg, jspec.fc2_cfg
    solver = make_ferro_node_solver(
        (c1.in_dim, c1.out_dim, c1.num_basis),
        (c2.in_dim, c2.out_dim, c2.num_basis), gate_slope=c1.gate_slope,
        alpha=c1.alpha, h_bound=jspec.h_bound, dh_clip=jspec.dh_clip,
        rtol=jspec.rtol, atol=jspec.atol, max_steps=jspec.max_steps,
        interpret=True, noisy=noisy)
    nz = (j_frozen_solve_noise(jax.random.PRNGKey(7), B, c1, c2)
          if noisy else ())

    def loss(f1, f2, h):
        return jnp.sum(solver(f1, f2, h, *nz) * hbar)

    @jax.jit
    def run(f1, f2, h):
        return (solver.fwd_with_records(f1, f2, h, *nz),
                jax.grad(loss, argnums=(0, 1, 2))(f1, f2, h))

    (out, recs), (g1, g2, gh) = run(jparams["fc1"], jparams["fc2"],
                                    jnp.asarray(h0))
    return dict(out=np.asarray(out), recs=[np.asarray(r) for r in recs],
                g_params=[np.asarray(g[n]) for g in (g1, g2) for n in NAMES],
                g_h0=np.asarray(gh), noise=[np.array(n) for n in nz])


@pytest.fixture(scope="module")
def setup():
    jspec = JM.KanFetMLPNODESpec(**SPEC)
    jparams = JM.kanfet_mlp_node_init(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    rng = np.random.default_rng(1)
    h0 = rng.standard_normal((B, SPEC["latent_dim"])).astype(np.float32)
    hbar = rng.standard_normal(h0.shape).astype(np.float32)
    runs = {"clean": _jax_run(jspec, jparams, h0, hbar, False),
            "noisy": _jax_run(jspec._replace(noise_std=NOISE_STD), jparams,
                              h0, hbar, True)}
    return dict(jspec=jspec, jparams=jparams, tree=tree, h0=h0, hbar=hbar,
                jax=runs, spec=TM.KanFetMLPNODESpec(**SPEC))


def _module(s, dtype=torch.float32):
    m = TM.kanfet_mlp_node_init(torch.Generator().manual_seed(0), s["spec"],
                                dtype=dtype)
    m.load_state_dict(ecg_params_from_numpy(s["tree"], dtype=np.float64))
    return m


def _noise(run):
    return tuple(torch.from_numpy(n) for n in run["noise"]) or None


def _records(jrecs, dtype=np.float32):
    tda, yrec, krec, misc = jrecs
    return NC.SolveRecords(*(torch.from_numpy(np.array(r, dtype))
                             for r in (tda, yrec, krec, misc[0])))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(grads):
    return np.concatenate([np.asarray(g).ravel() for g in grads])


CFG = FN.ferro_node_config(TM.KanFetMLPNODESpec(**SPEC))


@pytest.mark.parametrize("noisy", [False, True])
def test_eager_solve_matches_xla_float64(setup, noisy):
    """float64, step for step: the port's eager model field (with the frozen
    draws of the XLA path, in float64) under the port's dopri5 against the
    JAX package's XLA solve with ``per_eval_noise=False``."""
    s = setup
    jspec = s["jspec"]._replace(noise_std=NOISE_STD if noisy else 0.0)
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 s["jparams"])
    h0 = s["h0"].astype(np.float64)
    states = tuple(j_state_init((B,), c, jnp.float64)
                   for c in (jspec.fc1_cfg, jspec.fc2_cfg))
    key = jax.random.PRNGKey(3)
    nkeys = jax.random.split(key) if noisy else None
    ref = j_odeint(lambda t, h: JM.kanfet_mlp_node_field(
        p64, jspec, t, h, states, nkeys, per_eval_noise=False),
        jnp.asarray(h0), jnp.asarray([0.0, 1.0]), rtol=jspec.rtol,
        atol=jspec.atol, max_steps=jspec.max_steps, mode="while")[-1]
    noise = None
    if noisy:      # ops/ferro.py: ferro_basis's draw, in the basis shape
        noise = tuple(torch.from_numpy(np.array(
            jax.random.normal(k, (B, c.in_dim, c.out_dim, c.num_basis),
                              jnp.float64) * NOISE_STD))
            for k, c in zip(nkeys, (jspec.fc1_cfg, jspec.fc2_cfg)))
    spec = s["spec"]._replace(noise_std=jspec.noise_std)
    m = _module(s, torch.float64)
    tstates = tuple(ferro_state_init((B,), c, dtype=torch.float64)
                    for c in (spec.fc1_cfg, spec.fc2_cfg))
    with torch.no_grad():
        out = odeint_dopri5(
            lambda t, h: TM.kanfet_mlp_node_field(m, spec, t, h, tstates,
                                                  noise),
            torch.from_numpy(h0), torch.tensor([0.0, 1.0],
                                               dtype=torch.float64),
            rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps,
            mode="while")[-1]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)


def test_kernel_field_equals_model_field_float64(setup):
    """The plain kernel field (kernel layout) and the eager model field are
    one function where both are finite and inside the clip: the float64
    solves agree step for step."""
    s = setup
    m = _module(s, torch.float64)
    spec = s["spec"]
    h0 = torch.from_numpy(s["h0"].astype(np.float64))
    out_k, _ = NC.record_solve_reference(FN.ferro_field(m.fc1, m.fc2, CFG),
                                         h0, rtol=spec.rtol, atol=spec.atol,
                                         max_steps=spec.max_steps)
    states = tuple(ferro_state_init((B,), c, dtype=torch.float64)
                   for c in (spec.fc1_cfg, spec.fc2_cfg))
    with torch.no_grad():
        out_m = odeint_dopri5(
            lambda t, h: TM.kanfet_mlp_node_field(m, spec, t, h, states), h0,
            torch.tensor([0.0, 1.0], dtype=torch.float64), rtol=spec.rtol,
            atol=spec.atol, max_steps=spec.max_steps, mode="while")[-1]
    np.testing.assert_allclose(out_k.numpy(), out_m.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("run", ["clean", "noisy"])
def test_records_match_jax(setup, run):
    """The plain recording solve against the JAX kernel's records (the noisy
    form fed the JAX package's own frozen draws)."""
    s = setup
    j = s["jax"][run]
    m = _module(s)
    with torch.no_grad():
        out, recs = FN.ferro_node_fwd(m.fc1, m.fc2, torch.from_numpy(s["h0"]),
                                      CFG, noise=_noise(j))
    want = _records(j["recs"])
    n = int(want.misc[0])
    assert int(recs.misc[0]) == n
    np.testing.assert_array_equal(recs.tda[:n, 1].numpy(),
                                  want.tda[:n, 1].numpy())
    for got, ref in zip(recs, want):
        np.testing.assert_allclose(got[:n].numpy(), ref[:n].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), j["out"], rtol=1e-5, atol=1e-5)
    if run == "noisy":     # the noise moved the solution
        assert not np.allclose(j["out"], s["jax"]["clean"]["out"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("run", ["clean", "noisy"])
def test_replay_gradients_on_jax_mesh(setup, run):
    """float32: the plain replay's autograd on JAX's recorded mesh against
    ``jax.grad`` through the JAX kernel; with noise, only the coef
    gradient sees the draws, and it is checked on its own too."""
    s = setup
    j = s["jax"][run]
    m = _module(s)
    h0 = torch.from_numpy(s["h0"])
    with torch.no_grad():
        out = NC.replay_reference(FN.ferro_field(m.fc1, m.fc2, CFG,
                                                 _noise(j)), h0,
                                  _records(j["recs"]))
    np.testing.assert_allclose(out.numpy(), j["out"], rtol=1e-5, atol=1e-5)
    grads, h0bar = FN.ferro_node_bwd(m.fc1, m.fc2, h0, _records(j["recs"]),
                                     torch.from_numpy(s["hbar"]), CFG,
                                     noise=_noise(j))
    got = [g.numpy() for g in grads]
    assert _rel(_flat(got), _flat(j["g_params"])) < 1e-4
    assert _rel(h0bar.numpy(), j["g_h0"]) < 1e-4
    for i in (4, 9):         # g_coef of each layer
        assert _rel(got[i], j["g_params"][i]) < 1e-4
    if run == "noisy":
        clean = s["jax"]["clean"]["g_params"]
        assert not np.allclose(got[4], clean[4], rtol=1e-3, atol=1e-5)


def test_kernel_field_and_model_field_differ_as_in_jax(setup):
    """The model field scrubs non-finite values (``nan_to_num``) before its
    clip, as the JAX model field does; the kernel field does not, as the
    JAX kernel does not.  At dh = clip the kernel's clip passes no
    gradient, the model field's ``clamp`` passes it."""
    s = setup
    spec = s["spec"]
    x = np.random.default_rng(2).standard_normal((B, spec.latent_dim))
    tree = jax.tree_util.tree_map(np.array, s["tree"])
    tree["fc2"]["coef"][0, 0, 0] = np.nan          # dh[:, 0] is nan
    jstates = tuple(j_state_init((B,), c) for c in (s["jspec"].fc1_cfg,
                                                    s["jspec"].fc2_cfg))
    want = np.asarray(JM.kanfet_mlp_node_field(
        jax.tree_util.tree_map(jnp.asarray, tree), s["jspec"], 0.0,
        jnp.asarray(x, jnp.float32), jstates))
    m = TM.kanfet_mlp_node_init(torch.Generator().manual_seed(0), spec)
    m.load_state_dict(ecg_params_from_numpy(tree))
    xt = torch.from_numpy(x.astype(np.float32))
    states = tuple(ferro_state_init((B,), c) for c in (spec.fc1_cfg,
                                                       spec.fc2_cfg))
    with torch.no_grad():
        got = TM.kanfet_mlp_node_field(m, spec, 0.0, xt, states).numpy()
        raw = FN.ferro_field(m.fc1, m.fc2, CFG)(xt).numpy()
    assert np.isfinite(want).all() and not np.isfinite(raw[:, 0]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(raw[:, 1:], want[:, 1:], rtol=1e-5, atol=1e-5)

    # dh = clip exactly: fc2's coef at 0 makes dh = 0, and the clip is 0.
    m0 = _module(s)
    with torch.no_grad():
        m0.fc2.coef.zero_()
    cfg0 = CFG._replace(dh_clip=0.0)
    spec0 = spec._replace(dh_clip=0.0)
    states = tuple(ferro_state_init((B,), c) for c in (spec.fc1_cfg,
                                                       spec.fc2_cfg))
    w = torch.ones((B, spec.latent_dim))
    strict = torch.autograd.grad(
        torch.sum(FN.ferro_field(m0.fc1, m0.fc2, cfg0)(xt) * w),
        m0.fc2.coef)[0]
    passes = torch.autograd.grad(
        torch.sum(TM.kanfet_mlp_node_field(m0, spec0, 0.0, xt, states) * w),
        m0.fc2.coef)[0]
    assert not strict.any() and passes.abs().sum() > 0


def test_eager_and_kernel_paths_draw_the_same_noise(setup):
    """One generator seed: the model's eager solve and its kernel path (the
    plain version on the CPU) add the same frozen draws, so they compute
    one function."""
    s = setup
    spec = s["spec"]._replace(noise_std=NOISE_STD)
    m = _module(s)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, spec.T)).astype(np.float32))
    with torch.no_grad():
        eager = TM.kanfet_mlp_node_apply(
            m, spec, x, generator=torch.Generator().manual_seed(5))
        h0 = x @ m.encoder_w.T + m.encoder_b
        hT = FN.ferro_node_solve(m.fc1, m.fc2, h0, spec,
                                 generator=torch.Generator().manual_seed(5))
        kernel = hT @ m.cls_w.T + m.cls_b
        clean = TM.kanfet_mlp_node_apply(m, s["spec"], x)
    np.testing.assert_allclose(kernel.numpy(), eager.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(eager.numpy(), clean.numpy(), rtol=1e-4,
                           atol=1e-4)


def test_frozen_solve_noise_layout():
    """The draws are standard normals in the basis shape (B, in, out, K),
    scaled, in the kernel layout (B, out, in*K); ``basis_layout`` inverts
    the layout."""
    spec = TM.KanFetMLPNODESpec(**SPEC)
    c1, c2 = spec.fc1_cfg, spec.fc2_cfg
    nz1, nz2 = FN.frozen_solve_noise(torch.Generator().manual_seed(0), B, c1,
                                     c2, noise_std=0.5)
    g = torch.Generator().manual_seed(0)
    n1 = torch.randn((B, c1.in_dim, c1.out_dim, c1.num_basis), generator=g)
    n2 = torch.randn((B, c2.in_dim, c2.out_dim, c2.num_basis), generator=g)
    assert nz1.shape == (B, c1.out_dim, c1.in_dim * c1.num_basis)
    assert nz2.shape == (B, c2.out_dim, c2.in_dim * c2.num_basis)
    torch.testing.assert_close(FN.basis_layout(nz1, c1.in_dim), 0.5 * n1)
    torch.testing.assert_close(FN.basis_layout(nz2, c2.in_dim), 0.5 * n2)


def test_wrappers_on_cpu_are_the_plain_version(setup):
    s = setup
    m = _module(s)
    h0 = torch.from_numpy(s["h0"])
    hbar = torch.from_numpy(s["hbar"])
    noise = _noise(s["jax"]["noisy"])
    before = (FN.ferro_node_fwd.launches, FN.ferro_node_bwd.launches)
    field = FN.ferro_field(m.fc1, m.fc2, CFG, noise)
    out = FN.ferro_node_solve(m.fc1, m.fc2, h0, s["spec"], noise=noise)
    ref = NC.solve_reference(field, h0)
    assert out.requires_grad
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    with torch.no_grad():
        out_f, recs = FN.ferro_node_fwd(m.fc1, m.fc2, h0, CFG, noise=noise)
    np.testing.assert_array_equal(out_f.numpy(), ref.detach().numpy())
    grads, h0bar = FN.ferro_node_bwd(m.fc1, m.fc2, h0, recs, hbar, CFG,
                                     noise=noise)
    w = [getattr(p, n) for p in (m.fc1, m.fc2) for n in NAMES]
    want, want_h = NC.replay_vjp_reference(field, w, h0, recs, hbar)
    for g, r in zip(list(grads) + [h0bar], list(want) + [want_h]):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert (FN.ferro_node_fwd.launches,
            FN.ferro_node_bwd.launches) == before  # no kernel on the CPU


def test_refusals(setup):
    s = setup
    m = _module(s)
    x = torch.zeros((2, SPEC["T"]))
    spec = s["spec"]
    with pytest.raises(ValueError, match="CUDA"):
        TM.kanfet_mlp_node_apply(m, spec._replace(solver_mode="pallas"), x)
    with pytest.raises(ValueError, match="gate_impl"):
        TM.kanfet_mlp_node_apply(m, spec._replace(solver_mode="pallas",
                                                  gate_impl="tanh"), x)
    with pytest.raises(ValueError, match="generator"):
        TM.kanfet_mlp_node_apply(m, spec._replace(solver_mode="pallas"), x,
                                 noise_std=0.1)
    with pytest.raises(ValueError, match="generator"):
        TM.kanfet_mlp_node_apply(m, spec._replace(noise_std=0.1), x)
    with pytest.raises(ValueError, match="noise_std with a mesh"):
        TM.kanfet_mlp_node_apply(m, spec, x, mesh=object(), noise_std=0.1,
                                 generator=torch.Generator())
    with pytest.raises(ValueError, match="rk4"):      # fixed-step: ported
        TM.kanfet_mlp_node_apply(m, spec._replace(solver="rk9"), x)
    with pytest.raises(ValueError, match="D -> hidden -> D"):
        FN.ferro_node_fwd(m.fc1, m.fc1, torch.zeros((2, SPEC["latent_dim"])),
                          CFG)
    with pytest.raises(ValueError, match="noise must be"):
        FN.ferro_node_fwd(m.fc1, m.fc2, torch.zeros((2, SPEC["latent_dim"])),
                          CFG, noise=(torch.zeros(1), torch.zeros(1)))


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["clean", "noisy"])
def test_kernels_match_plain_on_card(setup, run):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    m = _module(s).to(dev)
    noise = _noise(s["jax"][run])
    noise = tuple(n.to(dev) for n in noise) if noise else None
    h0 = torch.from_numpy(s["h0"]).to(dev)
    hbar = torch.from_numpy(s["hbar"]).to(dev)
    field = FN.ferro_field(m.fc1, m.fc2, CFG, noise)
    with torch.no_grad():
        out, recs = FN.ferro_node_fwd(m.fc1, m.fc2, h0, CFG, noise=noise)
        ref, _ = NC.record_solve_reference(field, h0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    grads, h0bar = FN.ferro_node_bwd(m.fc1, m.fc2, h0, recs, hbar, CFG,
                                     noise=noise)
    w = [getattr(p, n) for p in (m.fc1, m.fc2) for n in NAMES]
    want, want_h = NC.replay_vjp_reference(field, w, h0, recs, hbar)
    flat = [torch.cat([g.reshape(-1) for g in gs]).cpu().numpy()
            for gs in (grads, want)]
    assert _rel(*flat) < 1e-4
    assert _rel(h0bar.cpu().numpy(), want_h.cpu().numpy()) < 1e-4


# --------------------------------------------- the tile plan (B.4)
# The grids the kernels take (the H100's 132 SMs at two blocks and at one,
# and small grids), for the ECG layers (D = 64, H = 128, K = 12), this
# file's narrow ones and an uneven one.
PLAN_GRIDS = (264, 132, 7, 1)
PLAN_LAYERS = ((128, 64, 12), (64, 128, 12), (12, 8, 3), (8, 12, 3),
               (5, 37, 4))


@pytest.mark.parametrize("layer", PLAN_LAYERS)
@pytest.mark.parametrize("G", PLAN_GRIDS)
def test_slice_plan_covers_every_element_once(G, layer):
    O, I, K = layer
    p = FN.slice_plan(G, O, I, K)
    assert p.RG * p.CG == FN.TILE_LANES
    assert p.tiles == p.NR * p.NC
    seen = np.zeros((O, I * K), int)
    per_block = np.zeros(G, int)
    for q in range(p.tiles):
        rows, cols = p.tile(q, O, I)
        assert len(rows) >= 1 and len(cols) >= 1
        for o in rows:
            for i in cols:
                seen[o, i * K:(i + 1) * K] += 1
        per_block[q % G] += 1
    assert (seen == 1).all()
    assert per_block.max() == p.per_block
    # A row's sum: its NC tiles in tile order, their columns in order; an
    # input column's cotangent: its NR tiles in order, their rows in order.
    for o in range(O):
        tiles = [q for q in range(p.tiles) if o in p.tile(q, O, I)[0]]
        assert len(tiles) == p.NC
        assert [i for q in tiles for i in p.tile(q, O, I)[1]] == list(range(I))
    for i in range(I):
        tiles = [q for q in range(p.tiles) if i in p.tile(q, O, I)[1]]
        assert len(tiles) == p.NR
        assert [o for q in tiles for o in p.tile(q, O, I)[0]] == list(range(O))
    if (O, I) == (128, 64) or (O, I) == (64, 128):
        assert (p.NR, p.NC) == (16, 16) and p.tiles == 256
        assert p.per_block == (1 if G >= 256 else -(-256 // G))


def _shfl_tree(v, offsets, width=32):
    """``v += __shfl_down_sync(v, d, width)`` for each d in ``offsets``,
    float32, over one warp's 32 lanes."""
    v = v.astype(np.float32).copy()
    for d in offsets:
        shifted = np.zeros_like(v)
        for lane in range(32):
            src = lane + d
            if src // width == lane // width and src < 32:
                shifted[lane] = v[src]
        v = v + shifted
    return v


def test_slice_order_sums_the_plain_layer(setup):
    """The kernel's order of a forward row sum (each (row, column) lane's K
    terms in order, a tile's columns in the shuffle tree, a row's tiles in
    order), in float32, is the plain layer's sum to float32 rounding; the
    input cotangent's column sums likewise over rows."""
    m = _module(setup)
    D, H, K = SPEC["latent_dim"], SPEC["ode_hidden"], SPEC["num_basis"]
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0, 1.0, (3, D))
    fc = m.fc1
    w = [FN.kernel_layout(getattr(fc, n)).detach().double().numpy()
         for n in NAMES]
    fk, fec, fps, fbias, fcoef = w
    g, a = CFG.gate_slope, 0.8
    xf = np.repeat(x, K, axis=1)[:, None, :]
    mu = 1 / (1 + np.exp(-g * xf))
    cn = 1 / (1 + np.exp(-g * (-xf - fec)))
    beta = a + (1 - a) * (1 - 2 * ((1 - mu) * cn))
    terms = ((fps * np.tanh(fk * (xf + fec * beta)) + fbias) * fcoef)
    t32 = terms.astype(np.float32)                         # (3, H, D*K)
    p = FN.slice_plan(264, H, D, K)
    rows_got = np.zeros((3, H), np.float32)
    cols_got = np.zeros((3, D), np.float32)
    for b in range(3):
        for q in range(p.tiles):
            rows, cols = p.tile(q, H, D)
            lanes = np.zeros(32, np.float32)
            for r, o in enumerate(rows):
                for c, i in enumerate(cols):
                    s = np.float32(0.0)
                    for k in range(K):
                        s = np.float32(s + t32[b, o, i * K + k])
                    lanes[r * p.CG + c] = s
            by_row = _shfl_tree(lanes, [d for d in (16, 8, 4, 2, 1)
                                        if d < p.CG], p.CG)
            by_col = _shfl_tree(lanes, [d for d in (16, 8, 4, 2, 1)
                                        if d >= p.CG])
            for r, o in enumerate(rows):
                rows_got[b, o] = np.float32(rows_got[b, o]
                                            + by_row[r * p.CG])
            for c, i in enumerate(cols):
                cols_got[b, i] = np.float32(cols_got[b, i] + by_col[c])
    np.testing.assert_allclose(rows_got, terms.sum(-1), rtol=1e-5, atol=1e-6)
    want_cols = terms.reshape(3, H, D, K).sum((1, 3))
    np.testing.assert_allclose(cols_got, want_cols, rtol=1e-5, atol=1e-6)
