"""PyTorch port, the forecasters' latent trajectory solve
(``ops/ode_dyn.py`` on ``ops/node_common.py``'s trajectory twins) against
the JAX package's ``ops/pallas_ode_dyn.py: make_ode_dyn_solver`` run in
interpret mode, and against its XLA dopri5 solve.

As in ``tests/test_pallas_ode_dyn.py``: ``ODEDynamicsConfig(latent_dim=8,
hidden=16)``, parameters from ``PRNGKey(0)``, rtol 1e-3 / atol 1e-4,
``max_steps`` 32, ``ts = arange(6)``; here B = 5 initial states and a
trajectory cotangent from a numpy seed.  The interpret-mode JAX kernel
runs once for the module (records and gradients in one program).

Tolerances:
* the trajectory against the JAX kernel and the JAX while-mode solve,
  float32: 1e-5, the JAX test's own (at rtol 1e-3 the error estimates lie
  far enough above float32 rounding that every solve takes the same
  attempts); output 0 is z0 exactly.
* records against the JAX kernel's: the same attempts and accept flags,
  values to 1e-5.
* gradients and z0bar of the plain replay on JAX's recorded mesh against
  ``jax.grad`` through the JAX kernel (its hand-written VJP with the
  dense-output cotangents): relative norm 1e-5.
The CUDA kernels are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models.forecasting import ODEDynamicsConfig as JCfg
from fetode_tpu.models.forecasting import ode_dynamics_apply as j_apply
from fetode_tpu.models.forecasting import ode_dynamics_init as j_init
from fetode_tpu.ops.pallas_ode_dyn import make_ode_dyn_solver
from fetode_tpu.solvers.dopri5 import odeint_dopri5 as j_odeint
from fetode_tpu_torch.convert import forecast_params_from_numpy
from fetode_tpu_torch.models import forecasting as TF
from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops import ode_dyn as OD

RTOL, ATOL, MAX_STEPS = 1e-3, 1e-4, 32
B, T = 5, 6


def _jax_run(params, sizes, z0, ts, ct, max_steps):
    solver = make_ode_dyn_solver(sizes, rtol=RTOL, atol=ATOL,
                                 max_steps=max_steps, interpret=True)

    @jax.jit
    def run(p, z):
        return (solver.fwd_with_records(p, z, ts),
                jax.grad(lambda p_, z_: jnp.sum(solver(p_, z_, ts) * ct),
                         argnums=(0, 1))(p, z))

    (traj, recs), (gp, gz) = run(params, z0)
    flat = np.concatenate([np.ravel(np.asarray(g[k])) for g in gp
                           for k in ("w", "b")])
    return dict(traj=np.asarray(traj), recs=[np.asarray(r) for r in recs],
                g_params=flat, g_z0=np.asarray(gz))


@pytest.fixture(scope="module")
def setup():
    cfg = JCfg(latent_dim=8, hidden=16)
    params = j_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    z0 = rng.standard_normal((B, cfg.latent_dim)).astype(np.float32)
    ct = rng.standard_normal((T, B, cfg.latent_dim)).astype(np.float32)
    ts = jnp.arange(T, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)
    sizes = tuple(cfg.mlp.sizes)
    return dict(cfg=cfg, params=params, tree=tree, z0=z0, ct=ct, ts=ts,
                full=_jax_run(params, sizes, jnp.asarray(z0), ts, ct,
                              MAX_STEPS),
                short=_jax_run(params, sizes, jnp.asarray(z0), ts, ct, 2))


def _layers(s, dtype=torch.float32):
    m = TF.ode_dynamics_init(torch.Generator().manual_seed(0),
                             TF.ODEDynamicsConfig(8, 16), dtype=dtype)
    m.load_state_dict(forecast_params_from_numpy(s["tree"]))
    return m.to(dtype)


def _records(jrecs):
    tda, yrec, krec, misc = jrecs
    return NC.SolveRecords(*(torch.from_numpy(np.array(r, np.float32))
                             for r in (tda, yrec, krec, misc[0])))


def _ts():
    return torch.arange(T, dtype=torch.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(grads):
    return np.concatenate([g.detach().numpy().ravel() for g in grads])


def test_trajectory_matches_jax_kernel_and_xla(setup):
    s = setup
    layers = _layers(s)
    z0 = torch.from_numpy(s["z0"])
    with torch.no_grad():
        out, _ = OD.ode_dyn_fwd(OD.layer_weights(layers), z0, _ts(),
                                max_steps=MAX_STEPS)
    assert out.shape == (T, B, 8)
    np.testing.assert_allclose(out.numpy(), s["full"]["traj"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(out[0].numpy(), s["z0"])
    xla = j_odeint(lambda t, z: j_apply(s["params"], s["cfg"], t, z),
                   jnp.asarray(s["z0"]), s["ts"], rtol=RTOL, atol=ATOL,
                   max_steps=MAX_STEPS, mode="while")
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("run", ["full", "short"])
def test_records_match_jax(setup, run):
    """The plain recording solve against the JAX kernel's records, with
    the full budget and with max_steps = 2 (the unreached tail): the same
    attempts and accept flags, and the first attempt's records to 1e-5.
    The first attempt's error estimate sits at float32 rounding (its PI
    factor near the 10x clip), so the next step sizes of two correct
    float32 solves differ by a few percent; the float64 test below holds
    the solve to the JAX one step for step."""
    s = setup
    steps = MAX_STEPS if run == "full" else 2
    layers = _layers(s)
    with torch.no_grad():
        _, recs = OD.ode_dyn_fwd(OD.layer_weights(layers),
                                 torch.from_numpy(s["z0"]), _ts(),
                                 max_steps=steps)
    want = _records(s[run]["recs"])
    n = int(want.misc[0])
    assert int(recs.misc[0]) == n
    np.testing.assert_array_equal(recs.tda[:n, 1].numpy(),
                                  want.tda[:n, 1].numpy())
    for got, ref in zip(recs[:3], want[:3]):
        np.testing.assert_allclose(got[:1].numpy(), ref[:1].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_eager_solve_matches_xla_float64(setup):
    """float64, step for step: the port's recording trajectory solve
    against the JAX package's XLA dopri5 solve of the model field."""
    s = setup
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 s["params"])
    z0 = s["z0"].astype(np.float64)
    ref = j_odeint(lambda t, z: j_apply(p64, s["cfg"], t, z),
                   jnp.asarray(z0), jnp.arange(T, dtype=jnp.float64),
                   rtol=RTOL, atol=ATOL, max_steps=MAX_STEPS, mode="while")
    layers = _layers(s, torch.float64)
    out, recs = NC.record_solve_traj_reference(
        OD.ode_dyn_field(*OD.layer_weights(layers)), torch.from_numpy(z0),
        torch.arange(T, dtype=torch.float64), rtol=RTOL, atol=ATOL,
        max_steps=MAX_STEPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
    assert float(recs.misc[1]) == pytest.approx(T - 1)


def test_unreached_tail_holds_last_state(setup):
    s = setup
    with torch.no_grad():
        out, recs = OD.ode_dyn_fwd(OD.layer_weights(_layers(s)),
                                   torch.from_numpy(s["z0"]), _ts(),
                                   max_steps=2)
    assert float(recs.misc[1]) < T - 1
    np.testing.assert_array_equal(out[-1].numpy(), out[-2].numpy())


@pytest.mark.parametrize("run", ["full", "short"])
def test_replay_gradients_on_jax_mesh(setup, run):
    """The plain replay on JAX's records reproduces its trajectory, and its
    autograd gives ``jax.grad`` through the JAX kernel (parameters and
    z0bar), head and unreached-tail cotangents included."""
    s = setup
    layers = _layers(s)
    w = OD.layer_weights(layers)
    z0 = torch.from_numpy(s["z0"])
    recs = _records(s[run]["recs"])
    with torch.no_grad():
        out = NC.replay_traj_reference(OD.ode_dyn_field(*w), z0, _ts(), recs)
    np.testing.assert_allclose(out.numpy(), s[run]["traj"], rtol=1e-5,
                               atol=1e-5)
    grads, z0bar = OD.ode_dyn_bwd(w, z0, _ts(), recs,
                                  torch.from_numpy(s["ct"]))
    assert _rel(_flat(grads), s[run]["g_params"]) < 1e-5
    assert _rel(z0bar.numpy(), s[run]["g_z0"]) < 1e-5


def test_wrappers_on_cpu_are_the_plain_version(setup):
    s = setup
    layers = _layers(s)
    w = OD.layer_weights(layers)
    z0 = torch.from_numpy(s["z0"])
    ct = torch.from_numpy(s["ct"])
    before = (OD.ode_dyn_fwd.launches, OD.ode_dyn_bwd.launches)
    out = OD.ode_dyn_solve(layers, z0, _ts())
    assert out.requires_grad
    ref = NC.solve_traj_reference(OD.ode_dyn_field(*w), z0, _ts())
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    with torch.no_grad():
        out_ng = OD.ode_dyn_solve(layers, z0, _ts())
        out_f, recs = OD.ode_dyn_fwd(w, z0, _ts())
    np.testing.assert_array_equal(out_ng.numpy(), out_f.numpy())
    want, want_z = NC.replay_traj_vjp_reference(OD.ode_dyn_field(*w), w, z0,
                                                _ts(), recs, ct)
    z = z0.clone().requires_grad_(True)
    got = torch.autograd.grad(torch.sum(OD.ode_dyn_solve(layers, z, _ts())
                                        * ct), w + [z])
    for g, r in zip(got, list(want) + [want_z]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert (OD.ode_dyn_fwd.launches, OD.ode_dyn_bwd.launches) == before


def test_refusals(setup):
    s = setup
    layers = _layers(s)
    w = OD.layer_weights(layers)
    z0 = torch.from_numpy(s["z0"])
    with pytest.raises(ValueError, match="h0 must be"):
        OD.ode_dyn_solve(layers, z0[0], _ts())
    with pytest.raises(ValueError, match="W0"):
        OD.ode_dyn_fwd([w[0][:, :-1]] + w[1:], z0, _ts())
    with pytest.raises(ValueError, match="CUDA"):
        TF._solve_latent(layers, TF.ODEDynamicsConfig(8, 16), z0, _ts(),
                         TF.LatentODEForecasterSpec(3, solver_mode="pallas"))
    with pytest.raises(ValueError, match="rk4"):      # fixed-step: ported
        TF._solve_latent(layers, TF.ODEDynamicsConfig(8, 16), z0, _ts(),
                         TF.LatentODEForecasterSpec(3, solver="rk9"))


@pytest.mark.cuda
def test_kernels_match_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    layers = _layers(s).to(dev)
    w = OD.layer_weights(layers)
    z0 = torch.from_numpy(s["z0"]).to(dev)
    ts = _ts().to(dev)
    ct = torch.from_numpy(s["ct"]).to(dev)
    with torch.no_grad():
        out, recs = OD.ode_dyn_fwd(w, z0, ts)
        ref, _ = NC.record_solve_traj_reference(OD.ode_dyn_field(*w), z0, ts)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    grads, z0bar = OD.ode_dyn_bwd(w, z0, ts, recs, ct)
    want, want_z = NC.replay_traj_vjp_reference(OD.ode_dyn_field(*w), w, z0,
                                                ts, recs, ct)
    flat = [torch.cat([g.reshape(-1) for g in gs]).cpu().numpy()
            for gs in (grads, want)]
    assert _rel(*flat) < 1e-4
    assert _rel(z0bar.cpu().numpy(), want_z.cpu().numpy()) < 1e-4


# ------------------------------------------------ the row-tile plan (B.7)
# Every batch the forecasting path gives the kernels (chip_smoke.py's
# ODE_CHECKS) at ETTPreset's widths, and a narrow field.
PATH_BATCHES = (1, 8, 41, 64, 97, 256, 297)


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("B", PATH_BATCHES)
def test_row_plan_covers_every_row_once(B, bwd):
    p = OD.row_plan(B, 64, 128, bwd)
    assert 1 <= p["C"] <= OD.MAX_CLUSTER
    assert p["R"] == -(-B // OD.MAX_CLUSTER)
    rows = [b for r in p["rows"] for b in r]
    assert rows == list(range(B))                 # each row once, in order
    assert all(len(r) >= 1 for r in p["rows"])    # no CTA without rows
    assert all(len(r) == p["R"] for r in p["rows"][:-1])
    assert p["smem_bytes"] <= OD.SMEM_BUDGET
    # The rows sit in shared memory while they fit: every forward and the
    # training batch's backward; past that (the backward at B = 256 and
    # 297) the plan states the device placement and the scratch it needs,
    # and the batch still runs on the kernel.
    assert p["rows_smem"] == (not bwd or B <= 97)
    assert p["weights_smem"]
    if not p["rows_smem"]:
        assert p["work_floats"] > 16 * p["tiles"] * p["C"]
    # The gradient tiles fit the registers of one CTA at these widths.
    assert p["tiles"] <= p["threads"] * p["tile_slots"]


def test_row_plan_places_wide_fields_in_device_memory():
    p = OD.row_plan(8, 256, 512, bwd=True)        # weights > 227 KB
    assert not p["weights_smem"] and not p["rows_smem"]
    assert p["smem_bytes"] <= OD.SMEM_BUDGET
    assert p["tiles"] > p["threads"] * p["tile_slots"]   # some in memory
    small = OD.row_plan(5, 8, 16, bwd=True)
    assert small["C"] == 5 and small["R"] == 1 and small["rows_smem"]
    with pytest.raises(ValueError, match="B must be"):
        OD.row_plan(0, 8, 16)


@pytest.mark.cuda
def test_kernels_same_bits_twice_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    s = setup
    w = OD.layer_weights(_layers(s).to(dev))
    z0 = torch.from_numpy(s["z0"]).to(dev)
    ct = torch.from_numpy(s["ct"]).to(dev)
    ts = _ts().to(dev)
    with torch.no_grad():
        runs = [OD.ode_dyn_fwd(w, z0, ts) for _ in range(2)]
    grads = [OD.ode_dyn_bwd(w, z0, ts, runs[0][1], ct) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert all(torch.equal(a, b) for a, b in zip(grads[0][0], grads[1][0]))
    assert torch.equal(grads[0][1], grads[1][1])
