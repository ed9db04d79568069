"""PyTorch port, the ECG KanFetNODE 'mlp' whole-solve (``ops/mlp_node.py``
on ``ops/node_common.py``) against the JAX package's
``ops/pallas_mlp_node.py: make_mlp_node_solver`` run in interpret mode,
and against its model field.

As in ``tests/test_pallas_mlp_node.py``: ``KanFetNODESpec(T=24,
latent_dim=8, num_basis=4, ode_hidden=16, field="mlp", max_steps=16)``,
parameters from ``PRNGKey(0)``, rtol 1e-2 / atol 1e-3, B = 5 initial
states and a final-state cotangent from a numpy seed.  At init the field
is tiny (``out_w`` has std 1e-3, ``log_alpha`` -3) and the solve takes one
step, so besides that init ("init") the fixture draws ``out_w`` with std
4 and ``out_b`` with std 0.1, sets ``log_alpha`` 0.5 and triples both KAN
layers' base and spline weights ("scaled"), in the numpy tree that both
packages load: the field is then of order ten and the solve takes four
attempts.  The interpret-mode JAX kernel is compiled once for the module
(records and gradients in one program) and runs on both trees.

Tolerances:
* the field: float32 within 1e-6 relative to its largest value (sums in
  another order), float64 within 1e-12;
* records and forward output against the JAX kernel, float32: 1e-5 at
  init; on the scaled field the first step is small and its error
  estimate lies near float32 rounding, so later step sizes part by up to
  a percent: there the attempts, the first attempt's records (1e-5) and
  the replay of JAX's mesh (1e-5) are held;
* gradients of the port's plain replay on JAX's recorded mesh, through
  the module's parameters (the scaler and ``eff`` chain rules included),
  against ``jax.grad`` through the JAX kernel (its hand-written VJP with
  the analytic B-spline derivative): relative norm < 2e-4 leaf by leaf,
  the knot grids skipped (the JAX kernel reports zeros for them, the port
  keeps them as buffers), and h0bar rtol 1e-4 / atol 1e-6 (the JAX
  package's own bounds for its kernel against scan autodiff).
The CUDA kernels are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import ecg as JM
from fetode_tpu.ops.pallas_mlp_node import _FIELD_KEYS, make_mlp_node_solver
from fetode_tpu_torch.convert import ecg_grads_to_numpy, ecg_params_from_numpy
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.nn.kan import KANConfig, kan_init
from fetode_tpu_torch.ops import mlp_node as MN
from fetode_tpu_torch.ops import node_common as NC

SPEC = dict(T=24, latent_dim=8, num_basis=4, ode_hidden=16, field="mlp",
            max_steps=16)
B = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager solves here are many small ops: with the suite's workers
    sharing the cores, torch's intra-op thread pool oversubscribes them
    (see tests/test_torch_cond_diffusion.py).  One thread for this
    module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(jparams, rng):
    """The JAX init, its field scaled up to order ten (module docstring)."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    tree["out_w"] = (4.0 * rng.standard_normal(tree["out_w"].shape)
                     ).astype(np.float32)
    tree["out_b"] = (0.1 * rng.standard_normal(tree["out_b"].shape)
                     ).astype(np.float32)
    tree["log_alpha"] = np.float32(0.5)
    for layer in tree["kan"]:
        layer["base_weight"] = 3.0 * layer["base_weight"]
        layer["spline_weight"] = 3.0 * layer["spline_weight"]
    return tree


@pytest.fixture(scope="module")
def setup():
    jspec = JM.KanFetNODESpec(**SPEC)
    D, K, H = jspec.latent_dim, jspec.num_basis, jspec.ode_hidden
    rng = np.random.default_rng(1)
    init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        JM.kanfet_node_init(jax.random.PRNGKey(0), jspec))
    tree = _tree(init, rng)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    hbar = rng.standard_normal((B, D)).astype(np.float32)
    solver = make_mlp_node_solver(D, K, H, rtol=jspec.rtol, atol=jspec.atol,
                                  max_steps=jspec.max_steps,
                                  h_bound=jspec.h_bound, interpret=True)

    def loss(fp, h):
        return jnp.sum(solver(fp, h) * hbar)

    @jax.jit
    def run(fp, h):
        return (solver.fwd_with_records(fp, h),
                jax.grad(loss, argnums=(0, 1))(fp, h))

    res = {}
    for name, t in (("init", init), ("scaled", tree)):
        jt = jax.tree_util.tree_map(jnp.asarray, t)
        (out, recs), (g_fp, g_h) = run({k: jt[k] for k in _FIELD_KEYS},
                                       jnp.asarray(h0))
        res[name] = dict(tree=t, out=np.asarray(out),
                         recs=[np.asarray(r) for r in recs],
                         g_fp=jax.tree_util.tree_map(np.asarray, g_fp),
                         g_h0=np.asarray(g_h))
    return dict(jspec=jspec, h0=h0, hbar=hbar, spec=TM.KanFetNODESpec(**SPEC),
                **res)


def _module(s, dtype=torch.float32, regime="scaled"):
    m = TM.kanfet_node_init(torch.Generator().manual_seed(0), s["spec"],
                            dtype=dtype)
    m.load_state_dict(ecg_params_from_numpy(s[regime]["tree"],
                                            dtype=np.float64))
    return m.to(dtype)


def _records(jrecs, dtype=np.float32):
    tda, yrec, krec, misc = jrecs
    return NC.SolveRecords(*(torch.from_numpy(np.array(r, dtype))
                             for r in (tda, yrec, krec, misc[0])))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_field_matches_jax(setup, dtype):
    """The plain field on the kernel operands and the model's field
    against the JAX model's ``kanfet_node_field``."""
    s = setup
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, np_dt),
                                   s["scaled"]["tree"])
    y = np.random.default_rng(2).standard_normal((B, 8)).astype(np_dt) * 3
    want = np.asarray(JM.kanfet_node_field(jtree, s["jspec"], 0.0,
                                           jnp.asarray(y)))
    m = _module(s, dtype)
    yt = torch.from_numpy(y)
    with torch.no_grad():
        plain = MN.mlp_field(MN.mlp_weights(m), s["spec"].h_bound)(yt)
        model = TM.kanfet_node_field(m, s["spec"], 0.0, yt)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    scale = np.abs(want).max()
    assert scale > 1.0                        # the field is not trivial
    for got in (plain, model):
        assert np.abs(got.numpy() - want).max() <= tol * scale


def test_records_match_jax(setup):
    """At init (the field tiny: one step reaches t = 1): the plain
    recording solve against the JAX kernel's records, the same attempts,
    accept flags and times, states and stages to 1e-5."""
    s = setup
    m = _module(s, regime="init")
    with torch.no_grad():
        out, recs = MN.mlp_node_fwd(MN.mlp_weights(m),
                                    torch.from_numpy(s["h0"]),
                                    max_steps=s["spec"].max_steps)
    want = _records(s["init"]["recs"])
    n = int(want.misc[0])
    assert int(recs.misc[0]) == n
    np.testing.assert_array_equal(recs.tda[:n, 1].numpy(),
                                  want.tda[:n, 1].numpy())
    for got, ref in zip(recs, want):
        np.testing.assert_allclose(got[:n].numpy(), ref[:n].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(recs.misc.numpy(), want.misc.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), s["init"]["out"], rtol=1e-5,
                               atol=1e-5)


def test_scaled_solve_matches_jax(setup):
    """The scaled field (four attempts): the first attempt's small step
    leaves its error estimate near float32 rounding, so the next step
    sizes of two float32 implementations part by up to a percent (as
    they do between the port's own float32 and float64 solves).  Held:
    the attempt count and accept flags, the first attempt's records to
    1e-5, every step size to 2%, and the replay of JAX's recorded mesh,
    which reproduces JAX's final state to 1e-5."""
    s = setup
    m = _module(s)
    w = MN.mlp_weights(m)
    h0 = torch.from_numpy(s["h0"])
    want = _records(s["scaled"]["recs"])
    with torch.no_grad():
        _, recs = MN.mlp_node_fwd(w, h0, max_steps=s["spec"].max_steps)
        out = NC.replay_reference(MN.mlp_field(w), h0, want)
    n = int(want.misc[0])
    assert n >= 4 and int(recs.misc[0]) == n
    np.testing.assert_array_equal(recs.tda[:n, 1].numpy(),
                                  want.tda[:n, 1].numpy())
    for got, ref in zip(recs, want[:3]):
        np.testing.assert_allclose(got[:1].numpy(), ref[:1].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(recs.tda[:n, 0].numpy(),
                               want.tda[:n, 0].numpy(), rtol=2e-2)
    np.testing.assert_allclose(out.numpy(), s["scaled"]["out"], rtol=1e-5,
                               atol=1e-5)


def test_replay_gradients_on_jax_mesh(setup):
    """float32: autograd of the plain replay on JAX's recorded mesh, through
    the module's parameters, against ``jax.grad`` through the JAX kernel,
    leaf by leaf."""
    s = setup
    m = _module(s)
    h = torch.from_numpy(s["h0"]).requires_grad_(True)
    out = NC.replay_reference(MN.mlp_field(MN.mlp_weights(m)), h,
                              _records(s["scaled"]["recs"]))
    torch.sum(out * torch.from_numpy(s["hbar"])).backward()
    got = ecg_grads_to_numpy(m)
    want = s["scaled"]["g_fp"]
    paths = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(
        {k: got[k] for k in _FIELD_KEYS}))
    assert len(paths) == len(got_leaves)
    for path, ref in paths:
        if any(getattr(p, "key", None) == "_buffers" for p in path):
            continue
        assert _rel(np.ravel(got_leaves[path]), np.ravel(ref)) < 2e-4, path
    np.testing.assert_allclose(h.grad.numpy(), s["scaled"]["g_h0"],
                               rtol=1e-4, atol=1e-6)


def test_wrappers_on_cpu_are_the_plain_version(setup):
    s = setup
    m = _module(s)
    w = MN.mlp_weights(m)
    h0 = torch.from_numpy(s["h0"])
    hbar = torch.from_numpy(s["hbar"])
    before = (MN.mlp_node_fwd.launches, MN.mlp_node_bwd.launches)
    out = MN.mlp_node_solve(m, h0, s["spec"])
    assert out.requires_grad
    ref = NC.solve_reference(MN.mlp_field(w), h0)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    with torch.no_grad():
        out_ng = MN.mlp_node_solve(m, h0, s["spec"])
        out_f, recs = MN.mlp_node_fwd(w, h0)
    np.testing.assert_array_equal(out_ng.numpy(), ref.detach().numpy())
    np.testing.assert_array_equal(out_f.numpy(), ref.detach().numpy())
    grads, h0bar = MN.mlp_node_bwd(w, h0, recs, hbar)
    gw = MN.grad_weights(w)
    want, want_h = NC.replay_vjp_reference(MN.mlp_field(w), gw, h0, recs,
                                           hbar)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in gw]
    for g, r in zip(list(grads) + [h0bar], list(want) + [want_h]):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    # Autograd through the solve reaches the parameters through the
    # scaled spline weights and eff.
    h = h0.clone().requires_grad_(True)
    params = [m.kan.layers[0].spline_scaler, m.log_alpha, m.scale, h]
    got = torch.autograd.grad(torch.sum(MN.mlp_node_solve(
        m, h, s["spec"]) * hbar), params)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in got)
    np.testing.assert_allclose(got[-1].numpy(), want_h.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert (MN.mlp_node_fwd.launches,
            MN.mlp_node_bwd.launches) == before  # no kernel on the CPU


def test_refusals(setup):
    s = setup
    m = _module(s)
    h0 = torch.from_numpy(s["h0"])
    w = MN.mlp_weights(m)
    with pytest.raises(ValueError, match="CUDA"):
        TM.kanfet_node_apply(m, s["spec"]._replace(solver_mode="pallas"),
                             torch.zeros((2, SPEC["T"])))
    with pytest.raises(ValueError, match="h0 must be"):
        MN.mlp_node_solve(m, h0[0], s["spec"])
    with pytest.raises(ValueError, match="operand shapes"):
        MN.mlp_node_fwd(w[:6] + [w[6][:, :, :-1]] + w[7:], h0)
    with pytest.raises(ValueError, match="13 operands"):
        MN.mlp_node_fwd(w[:-1], h0)
    # Another grid size is not the kernels' KAN (a grid refit keeps the
    # size and moves only the knots).
    m.kan = kan_init(torch.Generator().manual_seed(0), KANConfig.make(
        [32, 16, 16], grid_size=7))
    with pytest.raises(NotImplementedError, match="grid refit"):
        MN.mlp_node_solve(m, h0, s["spec"])


@pytest.mark.cuda
def test_kernels_match_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    m = _module(s).to(dev)
    w = MN.mlp_weights(m)
    h0 = torch.from_numpy(s["h0"]).to(dev)
    hbar = torch.from_numpy(s["hbar"]).to(dev)
    with torch.no_grad():
        out, recs = MN.mlp_node_fwd(w, h0)
        ref, rrec = NC.record_solve_reference(MN.mlp_field(w), h0)
    torch.cuda.synchronize()
    assert int(recs.misc[0]) == int(rrec.misc[0])
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)
    grads, h0bar = MN.mlp_node_bwd(w, h0, recs, hbar)
    want, want_h = NC.replay_vjp_reference(MN.mlp_field(w),
                                           MN.grad_weights(w), h0, recs,
                                           hbar)
    flat = [torch.cat([g.reshape(-1) for g in gs]).cpu().numpy()
            for gs in (grads, want)]
    assert _rel(*flat) < 1e-4
    assert _rel(h0bar.cpu().numpy(), want_h.cpu().numpy()) < 1e-4


# --------------------------------------------- the tile plan (B.6)
# The grids the kernels take (the H100's 132 SMs at two blocks and at
# one, and small grids), at the ECG widths (D = 64, K = 12, H = 128) and
# this file's narrow field.
PLAN_GRIDS = (264, 132, 7, 1)
PLAN_FIELDS = ((64, 12, 128), (SPEC["latent_dim"], SPEC["num_basis"],
                               SPEC["ode_hidden"]))
CARD_GRIDS = (264, 132)


def _layers(D, K, H):
    """(O, I, F) of layer 1, layer 2 and the output layer."""
    return ((H, D * K, MN.N_COEFF + 1), (H, H, MN.N_COEFF + 1), (D, H, 1))


@pytest.mark.parametrize("field", PLAN_FIELDS)
@pytest.mark.parametrize("G", PLAN_GRIDS)
def test_slice_plan_covers_every_element_once(G, field):
    D, K, H = field
    for p, (O, I, F) in zip(MN.layer_plans(G, D, K, H), _layers(D, K, H)):
        assert p.RG == MN.TILE_ROWS and p.tiles == p.NR * p.NC
        assert p.KP >= p.CG * F and p.KP % 4 == 0
        assert p.SW >= p.KP and p.SW % 32 == 4     # conflict-free rows
        seen = np.zeros((O, I, F), int)
        per_block = np.zeros(G, int)
        assert p.rep == max(1, G // p.tiles)
        for v in range(p.tiles * p.rep):       # replica v // tiles
            per_block[v % G] += 1
        for q in range(p.tiles):
            rows, cols = p.tile(q, O, I)
            assert 1 <= len(rows) <= p.RG and 1 <= len(cols) <= p.CG
            for r, o in enumerate(rows):
                for c, i in enumerate(cols):
                    for k in range(F):
                        # element (r, c, k) of the tile's (16, SW) rows
                        assert c * F + k < p.KP
                        seen[o, i, k] += 1
        assert (seen == 1).all()          # every (o, i, coefficient) once
        assert per_block.max() == p.per_block
    # Layer 1's tiles hold whole features: two of K columns each.
    p1 = MN.layer_plans(G, D, K, H)[0]
    assert p1.CG == min(2 * K, D * K)
    for q in range(p1.tiles):
        cols = p1.tile(q, H, D * K)[1]
        assert cols.start % K == 0 and len(cols) % K == 0


@pytest.mark.parametrize("layer", range(3))
@pytest.mark.parametrize("field", PLAN_FIELDS)
def test_slice_order_is_fixed(field, layer):
    """A forward row's sum adds its NC tiles' partials in tile order,
    which cover the inputs in order; an input's cotangent adds its NR
    row groups' partials in order, which cover the outputs in order."""
    D, K, H = field
    O, I, _ = _layers(D, K, H)[layer]
    p = MN.layer_plans(264, D, K, H)[layer]
    for o in range(O):
        tiles = [q for q in range(p.tiles) if o in p.tile(q, O, I)[0]]
        assert [q % p.NC for q in tiles] == list(range(p.NC))
        assert [i for q in tiles for i in p.tile(q, O, I)[1]] == list(range(I))
    for i in range(I):
        tiles = [q for q in range(p.tiles) if i in p.tile(q, O, I)[1]]
        assert [q // p.NC for q in tiles] == list(range(p.NR))
        assert [o for q in tiles for o in p.tile(q, O, I)[0]] == list(range(O))


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("field", PLAN_FIELDS)
@pytest.mark.parametrize("G", CARD_GRIDS)
def test_tiles_fit_shared_memory(G, field, bwd):
    """At the card's grids a block's tiles (and, backward, their
    gradients) and buffers stay within its dynamic shared memory; at two
    blocks an SM (G = 264) both fit the SM's 228 KB with the 1 KB the
    card reserves a block."""
    D, K, H = field
    nbytes = 4 * MN.smem_floats(G, D, K, H, bwd)
    assert nbytes <= MN.SMEM_BUDGET
    if G == 264:
        assert 2 * (nbytes + 2048 + 1024) <= 233472
    # the parameters are held once over the grid's blocks, layer 1 in
    # one copy (the replicas of the smaller layers use blocks it leaves)
    p1 = MN.layer_plans(G, D, K, H)[0]
    n_par = H * D * K * (MN.N_COEFF + 1)
    assert n_par <= p1.tiles * p1.RG * p1.SW <= 2 * n_par
    if D * K * H >= 4096:
        assert p1.rep == 1


def test_slice_sums_the_plain_layer(setup):
    """Layer 1 of the scaled field as the tiles cut it: each tile's
    partial over its columns' nine coefficients, a row's NC partials
    added in tile order, in float32, is the plain layer (``mlp_field``'s
    first KAN layer) to float32 rounding."""
    from fetode_tpu_torch.ops.bsplines import bspline_basis

    m = _module(setup, torch.float64)
    w = MN.mlp_weights(m)
    g1, bw1, sw1 = (t.detach() for t in (w[4], w[5], w[6]))
    H, L = bw1.shape
    rng = np.random.default_rng(9)
    phi = torch.from_numpy(rng.uniform(0.05, 0.95, (3, L)))
    X = torch.cat([torch.nn.functional.silu(phi)[..., None],
                   bspline_basis(phi, g1, MN.ORDER)], -1)      # (3, L, 9)
    W = torch.cat([bw1[..., None], sw1], -1)                   # (H, L, 9)
    want = torch.einsum("blk,hlk->bh", X, W).numpy()
    p = MN.layer_plans(264, SPEC["latent_dim"], SPEC["num_basis"], H)[0]
    x32, w32 = X.float().numpy(), W.float().numpy()
    got = np.zeros((3, H), np.float32)
    for q in range(p.tiles):
        rows, cols = p.tile(q, H, L)
        part = np.einsum("blk,hlk->bh", x32[:, cols], w32[rows][:, cols])
        got[:, rows] = (got[:, rows] + part.astype(np.float32)).astype(
            np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [B, 8 * B, 16 * B])
def test_kernels_same_bits_twice_on_card(setup, batch):
    """Every form (the chunk at B = 5, the rows at 40, the phases at 80):
    the output, records and every gradient the same bits in two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    s = setup
    w = MN.mlp_weights(_module(s).to(dev))
    h0 = torch.from_numpy(np.resize(s["h0"], (batch, s["h0"].shape[1]))).to(
        dev)
    hbar = torch.from_numpy(np.resize(s["hbar"], (batch,
                                                  s["hbar"].shape[1]))).to(dev)
    with torch.no_grad():
        runs = [MN.mlp_node_fwd(w, h0) for _ in range(2)]
    grads = [MN.mlp_node_bwd(w, h0, runs[0][1], hbar) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert all(torch.equal(a, b) for a, b in zip(grads[0][0], grads[1][0]))
    assert torch.equal(grads[0][1], grads[1][1])
