"""PyTorch port, per-row output times (multiple shooting's segments, each
solved from its own first time to its own last): the eager per-row
dopri5 (``solvers/dopri5.py``), ``models/predprey.py: predict_batch``
and the plain versions of the B.1 / B.2 kernels
(``ops/kanfet_node.py: kanfet_solve_reference``,
``ops/kanfet_adjoint.py: record_attempts_reference`` /
``replay_reference``) with ``(B, T)`` times, against ``jax.vmap`` of the
JAX solve over x0 and ts.  The kernels take the same times as an operand
of stride T; ``chip_smoke.py`` holds them against these plain versions
on the card.

Tolerances: bit for bit against the batch solved with each row's times
shared (the same batch, so the field's products see the same shapes; a
one-row batch takes other BLAS paths: 1e-12 relative in float64), and
1e-10 against ``jax.vmap`` of the JAX solve in float64; the replay's
gradient against autograd of the eager scan 1e-9 (relative norm,
float64: one step mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu_torch.convert import params_from_numpy
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn import kan as tkan
from fetode_tpu_torch.ops import kanfet_adjoint as KA
from fetode_tpu_torch.ops import kanfet_node as KN


@pytest.fixture(autouse=True)
def _one_thread():
    # The eager CPU paths under the suite's xdist workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _to_port(jtree, spec, dtype):
    """A JAX KAN parameter list -> the port's KAN in ``dtype``, bits
    kept."""
    kan = tkan.KAN(spec.kan, dtype=dtype)
    kan.load_state_dict(params_from_numpy(jtree, dtype=dtype))
    return kan


def _case(dtype=torch.float64, B=5, T=4, seed=3):
    spec = tpp.PredPreyNODE.kanfet(layers_hidden=(2, 4, 2), ferro_num_basis=4,
                                   rtol=1e-6, atol=1e-8, max_steps=64)
    kan = tpp.predprey_init(torch.Generator().manual_seed(seed), spec,
                            dtype=dtype)
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.uniform(0.5, 2.0, (B, 2))).to(dtype)
    ts = torch.from_numpy(np.stack([np.sort(rng.uniform(0.0, 0.6, T))
                                    + 0.3 * b for b in range(B)])).to(dtype)
    return spec, kan, x0, ts


def test_per_row_times_match_vmap():
    """(B, T) times, each row its own start and end: row b of the batch
    solve equals the same batch solved with row b's times shared, bit for
    bit, a one-row solve to 1e-12 and ``jax.vmap`` of the JAX solve to
    1e-10 (float64)."""
    spec_kw = dict(layers_hidden=(2, 4, 2), ferro_num_basis=4, rtol=1e-6,
                   atol=1e-8, max_steps=64, solver_mode="while")
    jspec = jpp.PredPreyNODE.kanfet(**spec_kw)
    tspec = tpp.PredPreyNODE.kanfet(**spec_kw)
    jparams = jpp.predprey_init(jax.random.PRNGKey(1), jspec, jnp.float64)
    kan = _to_port(jparams, tspec, torch.float64)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(0.5, 2.0, (5, 2))
    ts = np.stack([np.sort(rng.uniform(0.0, 0.6, 4)) + 0.3 * b
                   for b in range(5)])
    x0t, tst = torch.from_numpy(x0), torch.from_numpy(ts)
    with torch.no_grad():
        got = tpp.predict_batch(kan, tspec, x0t, tst)
        shared = torch.stack([tpp.predict_batch(kan, tspec, x0t, tst[b])[b]
                              for b in range(5)])
        alone = torch.cat([tpp.predict_batch(kan, tspec, x0t[b:b + 1],
                                             tst[b]) for b in range(5)])
    assert got.shape == (5, 4, 2) and torch.equal(got, shared)
    assert _rel(got, alone) < 1e-12
    want = jax.vmap(lambda a, t: jpp.predict(jparams, jspec, a, t))(
        jnp.asarray(x0), jnp.asarray(ts))
    assert _rel(got, want) < 1e-10
    np.testing.assert_array_equal(got[:, 0].numpy(), x0)


def test_kernel_plain_versions_take_row_times():
    """B.1's and B.2's plain versions with (B, T) times: the solve, the
    records (each row's attempts start at its own first time and end at
    its last) and the replay equal the batch solved with each row's times
    shared, row by row; the replay's gradient is autograd of the eager
    scan on the recorded mesh."""
    spec, kan, x0, ts = _case()
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    out = KN.kanfet_solve_reference(kan, spec.kan, x0, ts, **opts)
    y, rec = KA.record_attempts_reference(kan, spec.kan, x0, ts, **opts)
    assert torch.equal(out, y)
    for b in range(x0.shape[0]):
        yb, rb = KA.record_attempts_reference(kan, spec.kan, x0, ts[b],
                                              **opts)
        assert torch.equal(y[b], yb[b])
        n = int(rec.n_att[b])
        assert n == int(rb.n_att[b])
        assert torch.equal(rec.rec[:n, :, b], rb.rec[:n, :, b])
        assert float(rec.rec[0, 0, b]) == float(ts[b, 0])
        assert float(rec.t_end[b]) == pytest.approx(float(ts[b, -1]))
    rep = KA.replay_reference(kan, spec.kan, x0, ts, rec)
    assert torch.equal(rep, y)
    ybar = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(y.shape)))
    grads, x0bar = KA.replay_vjp_reference(kan, spec.kan, x0, ts, rec, ybar)
    weights = KA.train_weights(kan)
    x0r = x0.clone().requires_grad_(True)
    scan = tpp.predict_batch(kan, spec._replace(solver_mode="scan"), x0r, ts)
    want = torch.autograd.grad(scan, weights + [x0r], ybar)
    flat = torch.cat([g.reshape(-1) for g in grads] + [x0bar.reshape(-1)])
    wflat = torch.cat([g.reshape(-1) for g in want])
    assert float((flat - wflat).norm() / wflat.norm()) < 1e-9


def test_time_operand_shapes():
    spec, kan, x0, ts = _case(dtype=torch.float32)
    assert KN.ts_stride(ts[0]) == 0 and KN.ts_stride(ts) == ts.shape[1]
    for bad in (ts[:3], ts[..., None], torch.zeros(5, 0)):
        with pytest.raises(ValueError, match="ts must be"):
            KN.kanfet_solve(kan, spec.kan, x0, bad)
    with pytest.raises(ValueError, match="ts must be"):
        KA.kanfet_solve_train(kan, spec.kan, x0, ts[:2])
    from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
    with pytest.raises(ValueError, match="per_row"):
        odeint_dopri5(lambda t, y: -y, x0, ts[:2], per_row=True)
    with pytest.raises(ValueError, match="ts must be"):
        odeint_dopri5(lambda t, y: -y, x0[0], ts)
    # (B, T) times through the float32 solves: finite, each row from its
    # own x0
    with torch.no_grad():
        out = KN.kanfet_solve(kan, spec.kan, x0, ts.contiguous())
    assert torch.isfinite(out).all() and torch.equal(out[:, 0], x0)
    y = KA.kanfet_solve_train(kan, spec.kan, x0, ts.contiguous(),
                              max_steps=64)
    y.sum().backward()
    assert all(torch.isfinite(w.grad).all() for w in KA.train_weights(kan))
