"""PyTorch port, the ECG logistic-mixer whole-solve (``ops/logistic_node.py``
on ``ops/node_common.py``) against the JAX package's
``ops/pallas_logistic_node.py: make_logistic_node_solver`` run in
interpret mode, and against its XLA dopri5 solve.

As in ``tests/test_pallas_logistic_node.py``: ``KanFetNODESpec(T=24,
latent_dim=8, num_basis=4, max_steps=16)``, parameters from
``PRNGKey(0)``, rtol 1e-2 / atol 1e-3, here B = 5 initial states and a
final-state cotangent from a numpy seed.  The interpret-mode JAX kernel
runs once for the module (records and gradients in one program).

Tolerances:
* float64 eager solve against the XLA solve, step for step: 1e-10
  (one algorithm, sums in another order).
* records and forward output against the JAX kernel, float32: 1e-5 (at
  rtol 1e-2 every error estimate lies far above float32 rounding, so the
  two frameworks take the same steps; what differs is rounding).
* gradients of the port's plain replay on JAX's recorded mesh against
  ``jax.grad`` through the JAX kernel (its hand-written VJP): relative
  norm 1e-4 in float32 (the JAX kernel's own bound against its oracle)
  and 1e-9 in float64 against ``jax.grad`` of a float64 jnp replay of
  the same mesh with the JAX model's field.
The CUDA kernels are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import ecg as JM
from fetode_tpu.ops.pallas_logistic_node import make_logistic_node_solver
from fetode_tpu.solvers.dopri5 import odeint_dopri5
from fetode_tpu.solvers.tableaux import DOPRI5
from fetode_tpu_torch.convert import ecg_params_from_numpy
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.ops import logistic_node as LN
from fetode_tpu_torch.ops import node_common as NC

SPEC = dict(T=24, latent_dim=8, num_basis=4, max_steps=16)
B = 5


@pytest.fixture(scope="module")
def setup():
    jspec = JM.KanFetNODESpec(**SPEC)
    D, K = jspec.latent_dim, jspec.num_basis
    jparams = JM.kanfet_node_init(jax.random.PRNGKey(0), jspec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    rng = np.random.default_rng(1)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    hbar = rng.standard_normal((B, D)).astype(np.float32)
    solver = make_logistic_node_solver(D, K, rtol=jspec.rtol,
                                       atol=jspec.atol,
                                       max_steps=jspec.max_steps,
                                       interpret=True)

    def loss(m, w, b, h):
        return jnp.sum(solver(m, w, b, h) * hbar)

    @jax.jit
    def run(m, w, b, h):
        return (solver.fwd_with_records(m, w, b, h),
                jax.grad(loss, argnums=(0, 1, 2, 3))(m, w, b, h))

    (out, recs), grads = run(jparams["field_mixer"], jparams["proj_w"],
                             jparams["proj_b"], jnp.asarray(h0))
    g_m, g_w, g_b, g_h = grads
    return dict(jspec=jspec, jparams=jparams, tree=tree, h0=h0, hbar=hbar,
                out=np.asarray(out), recs=[np.asarray(r) for r in recs],
                g_params=np.concatenate([np.ravel(g_m["a"]),
                                         np.ravel(g_m["b"]), np.ravel(g_w),
                                         np.ravel(g_b)]),
                g_h0=np.asarray(g_h), spec=TM.KanFetNODESpec(**SPEC))


def _module(s, dtype=torch.float32):
    m = TM.kanfet_node_init(torch.Generator().manual_seed(0), s["spec"],
                            dtype=dtype)
    m.load_state_dict(ecg_params_from_numpy(s["tree"], dtype=np.float64))
    return m.to(dtype)


def _weights(m):
    return (m.field_mixer.a, m.field_mixer.b, m.proj_w, m.proj_b)


def _records(jrecs, dtype=np.float32):
    tda, yrec, krec, misc = jrecs
    return NC.SolveRecords(*(torch.from_numpy(np.array(r, dtype))
                             for r in (tda, yrec, krec, misc[0])))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(grads):
    return np.concatenate([g.detach().numpy().ravel() for g in grads])


def test_eager_solve_matches_xla_float64(setup):
    """float64, step for step: the port's recording eager solve against the
    JAX package's XLA dopri5 solve of the model field."""
    s = setup
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 s["jparams"])
    h0 = s["h0"].astype(np.float64)
    ref = odeint_dopri5(
        lambda t, h: JM.kanfet_node_field(p64, s["jspec"], t, h),
        jnp.asarray(h0), jnp.asarray([0.0, 1.0]), rtol=s["jspec"].rtol,
        atol=s["jspec"].atol, max_steps=s["jspec"].max_steps,
        mode="while")[-1]
    m = _module(s, torch.float64)
    out, recs = NC.record_solve_reference(
        LN.logistic_field(*_weights(m)), torch.from_numpy(h0),
        rtol=s["spec"].rtol, atol=s["spec"].atol,
        max_steps=s["spec"].max_steps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
    assert 2 <= int(recs.misc[0]) <= s["spec"].max_steps
    assert float(recs.misc[1]) == pytest.approx(1.0)


def test_records_match_jax(setup):
    """The plain recording solve against the JAX kernel's records: the same
    attempts, accept flags and times, states and stages to 1e-5."""
    s = setup
    m = _module(s)
    with torch.no_grad():
        out, recs = LN.logistic_node_fwd(*_weights(m),
                                         torch.from_numpy(s["h0"]),
                                         max_steps=s["spec"].max_steps)
    want = _records(s["recs"])
    n = int(want.misc[0])
    assert int(recs.misc[0]) == n
    np.testing.assert_array_equal(recs.tda[:n, 1].numpy(),
                                  want.tda[:n, 1].numpy())
    for got, ref in zip(recs, want):
        np.testing.assert_allclose(got[:n].numpy(), ref[:n].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(recs.misc.numpy(), want.misc.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), s["out"], rtol=1e-5, atol=1e-5)


def test_replay_on_jax_mesh_reproduces_output(setup):
    s = setup
    m = _module(s)
    with torch.no_grad():
        out = NC.replay_reference(LN.logistic_field(*_weights(m)),
                                  torch.from_numpy(s["h0"]),
                                  _records(s["recs"]))
    np.testing.assert_allclose(out.numpy(), s["out"], rtol=1e-5, atol=1e-5)


def test_replay_gradients_on_jax_mesh(setup):
    """float32: the plain replay's autograd on JAX's recorded mesh against
    ``jax.grad`` through the JAX kernel."""
    s = setup
    m = _module(s)
    grads, h0bar = LN.logistic_node_bwd(*_weights(m),
                                        torch.from_numpy(s["h0"]),
                                        _records(s["recs"]),
                                        torch.from_numpy(s["hbar"]))
    assert _rel(_flat(grads), s["g_params"]) < 1e-4
    assert _rel(h0bar.numpy(), s["g_h0"]) < 1e-4


def _jnp_replay(field, h0, tda, n):
    """A jnp replay of recorded attempts: t, dt and accept held constant."""
    y = h0
    for m in range(n):
        dt, adv = tda[m, 0], tda[m, 1]
        if adv < 0.5:
            continue
        ks = [field(y)]
        for i in range(1, 7):
            ks.append(field(y + dt * sum(a * k for a, k in
                                         zip(DOPRI5.a[i][:i], ks))))
        y = y + dt * sum(b * k for b, k in zip(DOPRI5.b, ks))
    return y


def test_replay_gradients_float64(setup):
    """float64, one mesh (JAX's records): the port's replay gradients
    against ``jax.grad`` of a jnp replay with the JAX model's field."""
    s = setup
    tda = s["recs"][0].astype(np.float64)
    n = int(s["recs"][3][0, 0])
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 s["jparams"])
    hbar = s["hbar"].astype(np.float64)

    def loss(sub, h):
        p = dict(p64, **sub)
        out = _jnp_replay(lambda y: JM.kanfet_node_field(p, s["jspec"], 0.0,
                                                         y), h, tda, n)
        return jnp.sum(out * hbar)

    sub = {k: p64[k] for k in ("field_mixer", "proj_w", "proj_b")}
    g, gh = jax.grad(loss, argnums=(0, 1))(sub, jnp.asarray(
        s["h0"].astype(np.float64)))
    want = np.concatenate([np.ravel(g["field_mixer"]["a"]),
                           np.ravel(g["field_mixer"]["b"]),
                           np.ravel(g["proj_w"]), np.ravel(g["proj_b"])])
    m = _module(s, torch.float64)
    grads, h0bar = NC.replay_vjp_reference(
        LN.logistic_field(*_weights(m)), _weights(m),
        torch.from_numpy(s["h0"].astype(np.float64)),
        _records(s["recs"], np.float64), torch.from_numpy(hbar))
    assert _rel(_flat(grads), want) < 1e-9
    assert _rel(h0bar.numpy(), np.asarray(gh)) < 1e-9


def test_wrappers_on_cpu_are_the_plain_version(setup):
    s = setup
    m = _module(s)
    w = _weights(m)
    h0 = torch.from_numpy(s["h0"])
    before = (LN.logistic_node_fwd.launches, LN.logistic_node_bwd.launches)
    out = LN.logistic_node_solve(m, h0, s["spec"])
    assert out.requires_grad
    ref = NC.solve_reference(LN.logistic_field(*w), h0)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    with torch.no_grad():
        out_ng = LN.logistic_node_solve(m, h0, s["spec"])
        out_f, recs = LN.logistic_node_fwd(*w, h0)
    np.testing.assert_array_equal(out_ng.numpy(), ref.detach().numpy())
    np.testing.assert_array_equal(out_f.numpy(), ref.detach().numpy())
    hbar = torch.from_numpy(s["hbar"])
    grads, h0bar = LN.logistic_node_bwd(*w, h0, recs, hbar)
    want, want_h = NC.replay_vjp_reference(LN.logistic_field(*w), w, h0,
                                           recs, hbar)
    for g, r in zip(list(grads) + [h0bar], list(want) + [want_h]):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    # Autograd through the solve gives the same gradients.
    h = h0.clone().requires_grad_(True)
    got = torch.autograd.grad(torch.sum(LN.logistic_node_solve(
        m, h, s["spec"]) * hbar), list(w) + [h])
    for g, r in zip(got, list(want) + [want_h]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert (LN.logistic_node_fwd.launches,
            LN.logistic_node_bwd.launches) == before  # no kernel on the CPU


def test_refusals(setup):
    s = setup
    m = _module(s)
    h0 = torch.from_numpy(s["h0"])
    x = torch.zeros((2, SPEC["T"]))
    with pytest.raises(ValueError, match="CUDA"):
        TM.kanfet_node_apply(m, s["spec"]._replace(solver_mode="pallas"), x)
    with pytest.raises(ValueError, match="h0 must be"):
        LN.logistic_node_solve(m, h0[0], s["spec"])
    with pytest.raises(ValueError, match=r"\(D, K\)"):
        LN.logistic_node_fwd(m.field_mixer.a, m.field_mixer.b,
                             m.proj_w[:, :-1], m.proj_b, h0)
    with pytest.raises(ValueError, match="runs on CUDA"):
        NC.check_cuda(h0, "logistic_node_fwd")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    m = _module(s).to(dev)
    w = _weights(m)
    h0 = torch.from_numpy(s["h0"]).to(dev)
    hbar = torch.from_numpy(s["hbar"]).to(dev)
    with torch.no_grad():
        out, recs = LN.logistic_node_fwd(*w, h0)
        ref, _ = NC.record_solve_reference(LN.logistic_field(*w), h0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    grads, h0bar = LN.logistic_node_bwd(*w, h0, recs, hbar)
    want, want_h = NC.replay_vjp_reference(LN.logistic_field(*w), w, h0,
                                           recs, hbar)
    flat = [torch.cat([g.reshape(-1) for g in gs]).cpu().numpy()
            for gs in (grads, want)]
    assert _rel(*flat) < 1e-4
    assert _rel(h0bar.cpu().numpy(), want_h.cpu().numpy()) < 1e-4


# ------------------------------------------------ B.5's launch plan (CPU)

PLAN_BATCHES = (1, 8, 30, 32, 64, 256, 300)


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("B", PLAN_BATCHES)
def test_row_plan_covers_every_row_once(B, bwd):
    """``row_plan`` at the ECG widths (D = 64, K = 12): every row owned by
    exactly one CTA, in order; one cluster of at most 16 CTAs up to
    ``GRID_PAST`` rows, else the grid form; a CTA's shared memory within
    227 KB; where the weights, the rows and the backward's gW records and
    partials live is stated, and the parameters sit in shared memory at
    these widths; the backward's [gW | gbp] columns each owned once."""
    D, K, M = 64, 12, 16
    p = LN.row_plan(B, D, K, M, bwd)
    rows = [r for rg in p["rows"] for r in rg]
    assert rows == list(range(B))
    assert all(len(rg) >= 1 for rg in p["rows"]) and len(p["rows"]) == p["C"]
    assert p["grid"] == (B > LN.GRID_PAST)
    if not p["grid"]:
        assert p["C"] <= LN.MAX_CLUSTER
    else:
        assert p["C"] <= LN.MAX_GRID and p["R"] >= LN.CLUSTER_ROWS
    assert p["smem_bytes"] <= 232448
    assert p["weights"] == "shared"
    assert p["rows_at"] in ("shared", "device")
    assert 1 <= p["group_rows"] <= LN.GROUP_ROWS
    if bwd:
        cols = [c for cg in p["gw_cols"] for c in cg]
        assert cols == list(range(D * K + 1))
        assert p["gw_records"] == "device" and p["gw_partials"] == "device"
        assert p["rec_row"] == D + D * K and p["gw_splits"] >= 1
        assert p["work_floats"] >= 6 * M * B * p["rec_row"]
    else:
        assert "gw_cols" not in p


@pytest.mark.parametrize("D,K", [(8, 4), (64, 12), (64, 40), (300, 64)])
def test_row_plan_places_wide_fields(D, K):
    """No width the grid-stride form took is refused: wide fields move the
    rows, then the parameters, to device memory and take fewer rows a
    pass, and still fit a CTA's shared memory."""
    for B in (8, 64, 256):
        for bwd in (False, True):
            p = LN.row_plan(B, D, K, 16, bwd)
            assert p["smem_bytes"] <= 232448
            assert [r for rg in p["rows"] for r in rg] == list(range(B))
    assert LN.row_plan(64, 300, 64)["weights"] == "device"


@pytest.mark.cuda
def test_kernels_same_bits_twice_on_card(setup):
    """Two calls of each kernel give the same bits: output, records and
    gradients (fixed owners and orders, no atomics), at the test's widths
    and at the ECG widths in both launch forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    m = _module(s).to(dev)
    rng = np.random.default_rng(3)
    cases = [(_weights(m), torch.from_numpy(s["h0"]).to(dev),
              torch.from_numpy(s["hbar"]).to(dev))]
    big = TM.kanfet_node_init(torch.Generator().manual_seed(0),
                              TM.KanFetNODESpec(num_basis=12), device=dev)
    for b in (8, 96):
        cases.append((_weights(big), torch.from_numpy(rng.standard_normal(
            (b, 64)).astype(np.float32)).to(dev), torch.from_numpy(
            rng.standard_normal((b, 64)).astype(np.float32)).to(dev)))
    for w, h0, hbar in cases:
        runs = []
        for _ in range(2):
            with torch.no_grad():
                out, recs = LN.logistic_node_fwd(*w, h0)
            grads, h0bar = LN.logistic_node_bwd(*w, h0, recs, hbar)
            n = int(recs.misc[0])      # the attempts made; the rest unwritten
            runs.append([out, recs.tda[:n], recs.yrec[:n], recs.krec[:n],
                         recs.misc, *grads, h0bar])
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)
