"""PyTorch port, the ECG noise study: the member form of the ferro
whole-solve (``ops/ferro_node.py``: ``ferro_node_fwd_members``,
``ferro_node_bwd_members``, ``ferro_node_solve_members`` and their plain
versions), the population scanner (``train/loop.py:
make_population_epochs_scanner``), the population trainer
(``train/ecg_driver.py: train_ecg_population``) and ``cli ecg --model
noise_study``, against the JAX package and against the port's own
sequential runs.

Small widths: ``KanFetMLPNODESpec(T=24, latent_dim=8, ode_hidden=12,
num_basis=3)`` for the solves, as ``tests/test_torch_ferro_node.py``
takes them (P = 3 members of B = 4 rows, parameters from
``vmap(init)`` of ``PRNGKey(0)``'s split, member m's coef scaled so the
members take 2, 3 and 5 attempts, noise from a numpy seed at stds (0,
0.3, 0.3)); ``T=16, latent_dim=6, ode_hidden=6, num_basis=3`` and 24 + 8
series for the trainers.  Tolerances:
* the plain member form against ``jax.vmap`` of the JAX kernel in
  interpret mode: records and outputs 1e-5, gradients on JAX's mesh 1e-4
  relative, the attempt counts equal (``tests/test_torch_ferro_node.py``'s
  for the single solve);
* the plain member form against P single plain solves: the same bits;
* population curves against the port's sequential ``train_ecg_model``
  runs: 5e-6 absolute (``tests/test_population.py``'s for the JAX
  package's);
* two float64 population steps against the JAX package's
  ``make_population_epochs_scanner``: 1e-9.  Noisy members draw from two
  different RNGs (numpy-seeded ``torch.Generator`` against
  ``jax.random``), so that test takes std-0 members only;
* the kernel path (its plain version on the CPU) against ``auto``, the
  drift contract: member loss curves within rtol 5e-3 / atol 5e-4, best
  test accuracy within 2 points.
The CUDA member kernels are held against P single launches and against
the plain version on the card by ``chip_smoke.py`` (phase 45).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import ecg as JM
from fetode_tpu.ops.pallas_ferro_node import make_ferro_node_solver
from fetode_tpu.train import ecg_driver as jdrv
from fetode_tpu.train.loop import init_state as j_init_state
from fetode_tpu.train.loop import make_population_epochs_scanner as j_pop
from fetode_tpu.train.optim import make_optimizer as j_make_optimizer
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import ecg_params_from_numpy, \
    ecg_params_to_numpy
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.ops import ferro_node as FN
from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.train import ecg_driver as tdrv
from fetode_tpu_torch.train.loop import (
    PopulationState,
    init_state,
    make_minibatch_epochs_scanner,
    make_population_epochs_scanner,
)
from fetode_tpu_torch.train.optim import make_optimizer

SPEC = dict(T=24, latent_dim=8, ode_hidden=12, num_basis=3, max_steps=16)
P, B = 3, 4
STDS = (0.0, 0.3, 0.3)
COEF_SCALE = (1.0, 4.0, 8.0)      # members take 2, 3 and 5 attempts
NAMES = ("k", "ec", "ps", "bias", "coef")
CFG = FN.ferro_node_config(TM.KanFetMLPNODESpec(**SPEC))
TRAIN = dict(T=16, latent_dim=6, ode_hidden=6, num_basis=3)
MEMBERS = [(0.0, 0), (0.3, 0), (0.3, 1)]
RUN = tdrv.ECGRun(epochs=4, batch_size=4, epochs_per_call=2,
                  eval_noise_draws=2, eval_chunk=8, log_every=1000,
                  device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread under the suite's workers
    (as tests/test_torch_ecg.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(arrays):
    return np.concatenate([np.ravel(a) for a in arrays])


def _tree32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# ------------------------------------------------------- the member solve


@pytest.fixture(scope="module")
def solve_setup():
    """P members' parameters (member m's coef times COEF_SCALE[m]), h0,
    hbar and noise from a numpy seed, and in one program ``jax.vmap`` of
    the JAX kernel: each member's records and ``jax.grad`` of sum(hT *
    hbar)."""
    jspec = JM.KanFetMLPNODESpec(**SPEC)
    keys = jax.random.split(jax.random.PRNGKey(0), P)
    jp = _tree32(jax.vmap(lambda k: JM.kanfet_mlp_node_init(k, jspec))(keys))
    for layer in ("fc1", "fc2"):
        jp[layer]["coef"] = (jp[layer]["coef"] * np.asarray(
            COEF_SCALE, np.float32)[:, None, None, None]).astype(np.float32)
    D, H, K = SPEC["latent_dim"], SPEC["ode_hidden"], SPEC["num_basis"]
    rng = np.random.default_rng(1)
    h0 = rng.standard_normal((P, B, D)).astype(np.float32)
    hbar = rng.standard_normal((P, B, D)).astype(np.float32)
    s = np.asarray(STDS, np.float32)[:, None, None, None]
    noise = ((rng.standard_normal((P, B, H, D * K)) * s).astype(np.float32),
             (rng.standard_normal((P, B, D, H * K)) * s).astype(np.float32))
    c1, c2 = jspec.fc1_cfg, jspec.fc2_cfg
    solver = make_ferro_node_solver(
        (c1.in_dim, c1.out_dim, c1.num_basis),
        (c2.in_dim, c2.out_dim, c2.num_basis), gate_slope=c1.gate_slope,
        alpha=c1.alpha, h_bound=jspec.h_bound, dh_clip=jspec.dh_clip,
        rtol=jspec.rtol, atol=jspec.atol, max_steps=jspec.max_steps,
        interpret=True, noisy=True)

    def one(f1, f2, h, n1, n2, hb):
        def loss(a, b, c):
            return jnp.sum(solver(a, b, c, n1, n2) * hb)
        return (solver.fwd_with_records(f1, f2, h, n1, n2),
                jax.grad(loss, argnums=(0, 1, 2))(f1, f2, h))

    (out, recs), (g1, g2, gh) = jax.jit(jax.vmap(one))(
        jp["fc1"], jp["fc2"], jnp.asarray(h0), *noise, jnp.asarray(hbar))
    spec = TM.KanFetMLPNODESpec(**SPEC)
    mods = []
    for m in range(P):
        mod = TM.kanfet_mlp_node_init(torch.Generator().manual_seed(0), spec)
        mod.load_state_dict(ecg_params_from_numpy(
            jax.tree_util.tree_map(lambda a: a[m], jp), dtype=np.float64))
        mods.append(mod)
    return dict(
        mods=mods, h0=torch.from_numpy(h0), hbar=torch.from_numpy(hbar),
        noise=tuple(torch.from_numpy(n) for n in noise), spec=spec,
        out=np.asarray(out), recs=[np.asarray(r) for r in recs],
        g_params=[[np.asarray(g[n][m]) for g in (g1, g2) for n in NAMES]
                  for m in range(P)],
        g_h0=np.asarray(gh))


def _layers(mods):
    return [m.fc1 for m in mods], [m.fc2 for m in mods]


def _jax_records(s, m):
    tda, yrec, krec, misc = (r[m] for r in s["recs"])
    return NC.SolveRecords(*(torch.from_numpy(np.array(r, np.float32))
                             for r in (tda, yrec, krec, misc[0])))


def test_plain_members_match_vmapped_jax_kernel(solve_setup):
    """Each member's attempts, accept flags and records from the plain
    member forward against ``jax.vmap`` of the JAX kernel, the members'
    attempt counts different; each member's solve replayed on JAX's mesh
    against JAX's output; the plain member backward on JAX's recorded
    meshes against ``jax.grad`` through the vmapped kernel.

    A member of two attempts takes its step sizes from Hairer's initial
    step and the end of the interval, and all its records match.  Past
    two, the next step size follows the error estimate's ratio to the
    tolerance, and the estimate's cancellation (sum_j e_j k_j) leaves it
    with float32 rounding that differs between XLA and PyTorch, past the
    records' 1e-5: such a member's first attempt is compared directly and
    the rest on JAX's mesh, as the solo tests compare gradients."""
    s = solve_setup
    fc1s, fc2s = _layers(s["mods"])
    with torch.no_grad():
        out, recs = FN.ferro_node_fwd_members(fc1s, fc2s, s["h0"], CFG,
                                              noise=s["noise"])
    counts = [int(recs.misc[m, 0]) for m in range(P)]
    assert counts == [int(s["recs"][3][m][0, 0]) for m in range(P)]
    assert len(set(counts)) == P             # the members' meshes differ
    for m in range(P):
        want = _jax_records(s, m)
        n = counts[m]
        first = n if n <= 2 else 1
        np.testing.assert_array_equal(recs.tda[m, :n, 1].numpy(),
                                      want.tda[:n, 1].numpy())
        for got, ref in zip(FN._member(recs, m)[:3], want[:3]):
            np.testing.assert_allclose(got[:first].numpy(),
                                       ref[:first].numpy(), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(recs.misc[m].numpy(), want.misc.numpy(),
                                   rtol=1e-5, atol=1e-5)
        nz = (s["noise"][0][m], s["noise"][1][m])
        with torch.no_grad():
            on_mesh = NC.replay_reference(
                FN.ferro_field(fc1s[m], fc2s[m], CFG, nz), s["h0"][m], want)
        np.testing.assert_allclose(on_mesh.numpy(), s["out"][m], rtol=1e-5,
                                   atol=1e-5)
        if n <= 2:
            np.testing.assert_allclose(out[m].numpy(), s["out"][m],
                                       rtol=1e-5, atol=1e-5)
    jrecs = NC.SolveRecords(*(torch.stack(r) for r in zip(
        *(_jax_records(s, m) for m in range(P)))))
    grads, h0bar = FN.ferro_node_bwd_members(fc1s, fc2s, s["h0"], jrecs,
                                             s["hbar"], CFG, noise=s["noise"])
    for m in range(P):
        got = [g.numpy() for g in grads[m]]
        assert _rel(_flat(got), _flat(s["g_params"][m])) < 1e-4
        assert _rel(h0bar[m].numpy(), s["g_h0"][m]) < 1e-4
        for i in (4, 9):                     # g_coef of each layer
            assert _rel(got[i], s["g_params"][m][i]) < 1e-4


def test_plain_members_equal_single_solves(solve_setup):
    """The plain member form is P single plain solves, bit for bit: the
    outputs, the records, the gradients and h0bar."""
    s = solve_setup
    fc1s, fc2s = _layers(s["mods"])
    with torch.no_grad():
        out, recs = FN.ferro_node_fwd_members(fc1s, fc2s, s["h0"], CFG,
                                              noise=s["noise"])
    grads, h0bar = FN.ferro_node_bwd_members(fc1s, fc2s, s["h0"], recs,
                                             s["hbar"], CFG, noise=s["noise"])
    for m in range(P):
        nz = (s["noise"][0][m], s["noise"][1][m])
        with torch.no_grad():
            o1, r1 = FN.ferro_node_fwd(fc1s[m], fc2s[m], s["h0"][m], CFG,
                                       noise=nz)
        g1, hb1 = FN.ferro_node_bwd(fc1s[m], fc2s[m], s["h0"][m], r1,
                                    s["hbar"][m], CFG, noise=nz)
        np.testing.assert_array_equal(out[m].numpy(), o1.numpy())
        for got, want in zip(FN._member(recs, m), r1):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        for got, want in zip(grads[m], g1):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(h0bar[m].numpy(), hb1.numpy())


def test_solve_members_gradients_reach_each_member(solve_setup):
    """``ferro_node_solve_members`` under autograd: member m's parameters
    get the gradient of member m's solve alone."""
    s = solve_setup
    fc1s, fc2s = _layers(s["mods"])
    for mod in s["mods"]:
        mod.zero_grad()
    hT = FN.ferro_node_solve_members(fc1s, fc2s, s["h0"], s["spec"],
                                     noise=s["noise"])
    torch.sum(hT[1] * s["hbar"][1]).backward()
    assert all(p.grad is None or not p.grad.any()
               for m in (0, 2) for p in s["mods"][m].parameters())
    nz = (s["noise"][0][1], s["noise"][1][1])
    _, r1 = FN.ferro_node_fwd(fc1s[1], fc2s[1], s["h0"][1], CFG, noise=nz)
    want, _ = FN.ferro_node_bwd(fc1s[1], fc2s[1], s["h0"][1], r1,
                                s["hbar"][1], CFG, noise=nz)
    got = [getattr(p, n).grad for p in (fc1s[1], fc2s[1]) for n in NAMES]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
    for mod in s["mods"]:
        mod.zero_grad()


def test_frozen_solve_noise_members():
    """Member m's noise is ``frozen_solve_noise`` of its own generator at
    its own std; a std-0 member's is zero."""
    spec = TM.KanFetMLPNODESpec(**SPEC)
    c1, c2 = spec.fc1_cfg, spec.fc2_cfg
    gens = [torch.Generator().manual_seed(10 + m) for m in range(P)]
    nz1, nz2 = FN.frozen_solve_noise_members(gens, B, c1, c2, STDS)
    assert nz1.shape == (P, B, c1.out_dim, c1.in_dim * c1.num_basis)
    assert nz2.shape == (P, B, c2.out_dim, c2.in_dim * c2.num_basis)
    for m in range(P):
        w1, w2 = FN.frozen_solve_noise(torch.Generator().manual_seed(10 + m),
                                       B, c1, c2, noise_std=STDS[m])
        np.testing.assert_array_equal(nz1[m].numpy(), w1.numpy())
        np.testing.assert_array_equal(nz2[m].numpy(), w2.numpy())
    assert not nz1[0].any() and nz1[1].abs().max() > 0


@pytest.mark.parametrize("case", ["h0", "members", "noise", "records"])
def test_member_wrapper_checks(solve_setup, case):
    s = solve_setup
    fc1s, fc2s = _layers(s["mods"])
    with pytest.raises(ValueError):
        if case == "h0":
            FN.ferro_node_fwd_members(fc1s, fc2s, s["h0"][0], CFG)
        elif case == "members":
            FN.ferro_node_fwd_members(fc1s[:2], fc2s[:2], s["h0"], CFG)
        elif case == "noise":
            FN.ferro_node_fwd_members(fc1s, fc2s, s["h0"], CFG,
                                      noise=(s["noise"][0][:2],
                                             s["noise"][1][:2]))
        else:
            FN._check_member_records(FN._member_records(16, P, B, 8,
                                                        "cpu"), P, B, 7,
                                     torch.device("cpu"), "x")


def test_pack_layout():
    """The members' weights packed as the kernels take them, (P, 5, out,
    in*K), column i*K + k, and the gradients unpacked back."""
    D, H, K = 2, 3, 4
    rng = np.random.default_rng(5)
    w = [torch.from_numpy(rng.standard_normal(
        (D, H, K) if j < 5 else (H, D, K)).astype(np.float32))
        for m in range(2) for j in range(10)]
    prm = FN._pack(w, 2, torch.device("cpu"), "x")
    assert [tuple(p.shape) for p in prm] == [(2, 5, H, D * K),
                                             (2, 5, D, H * K)]
    assert prm[1][1, 3, 1, 2 * K + 3] == w[10 + 8][2, 1, 3]
    assert prm[0][0, 0].equal(FN.kernel_layout(w[0]))
    back = FN._unpack(prm, (D, H, K, K))
    for m in range(2):
        for j in range(10):
            assert back[m][j].equal(w[10 * m + j])


# ------------------------------------------------------------ the trainers


def _data(seed=0, n=24, n_test=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + n_test, TRAIN["T"])).astype(np.float32)
    y = (x.mean(1) > 0).astype(np.int64)
    return x[:n], y[:n], x[n:], y[n:]


def _population(spec, run=RUN, members=MEMBERS):
    return tdrv.train_ecg_population(
        lambda g: TM.kanfet_mlp_node_init(g, spec),
        lambda ps, x, gens, stds: TM.kanfet_mlp_node_apply_members(
            ps, spec, x, generators=gens, noise_stds=stds),
        _data(), run, members, log=None)


@pytest.fixture(scope="module")
def runs():
    """The port's sequential runs (one ``train_ecg_model`` per member, the
    generator handed to a noisy member only) and its population, under
    ``auto`` on the CPU (each member's eager solve)."""
    seq = []
    for std, seed in MEMBERS:
        spec = TM.KanFetMLPNODESpec(**TRAIN, noise_std=std)
        _, hist = tdrv.train_ecg_model(
            lambda g, s=spec: TM.kanfet_mlp_node_init(g, s),
            lambda p, x, g, s=spec, sd=std: TM.kanfet_mlp_node_apply(
                p, s, x, generator=g if sd > 0 else None),
            _data(), dataclasses.replace(RUN, seed=seed), log=None)
        seq.append(hist)
    best, pop = _population(TM.KanFetMLPNODESpec(**TRAIN))
    return seq, pop, best


def test_population_curves_match_sequential(runs):
    seq, pop, _ = runs
    for (std, seed), h_seq, h_pop in zip(MEMBERS, seq, pop):
        for key in ("loss", "train_acc", "test_acc"):
            np.testing.assert_allclose(
                np.asarray(h_pop[key]), np.asarray(h_seq[key]), rtol=0,
                atol=5e-6, err_msg=f"member (std={std}, seed={seed}) {key}")
        assert abs(h_pop["best_test_acc"] - h_seq["best_test_acc"]) < 1e-6


def test_population_members_differ_and_best_is_stacked(runs):
    _, pop, best = runs
    losses = [np.asarray(h["loss"]) for h in pop]
    assert not np.allclose(losses[0], losses[1])   # clean vs noisy, one seed
    assert not np.allclose(losses[1], losses[2])   # one std, two seeds
    assert all(v.shape[0] == len(MEMBERS) for v in best.values())
    assert set(pop[0]) == {"loss", "train_acc", "test_acc", "best_test_acc",
                           "wall_seconds", "block_seconds"}
    assert len(pop[0]["block_seconds"]) == len(pop[0]["loss"]) == 2


def test_kernel_path_drift_contract(runs, monkeypatch):
    """The drift contract between the kernel path (its plain version on the
    CPU: every member's solve recorded and replayed, noise drawn up front)
    and the eager ``auto`` path: each member's loss curve within rtol 5e-3
    / atol 5e-4, its best test accuracy within 2 points."""
    _, auto, _ = runs
    calls = []

    def kernel(spec, x):
        calls.append(x.shape)
        return True

    monkeypatch.setattr(TM, "use_kernel", kernel)
    _, kern = _population(TM.KanFetMLPNODESpec(**TRAIN))
    assert calls and all(len(c) == 3 for c in calls)  # the member path ran
    for (std, seed), h_k, h_a in zip(MEMBERS, kern, auto):
        np.testing.assert_allclose(h_k["loss"], h_a["loss"], rtol=5e-3,
                                   atol=5e-4,
                                   err_msg=f"member (std={std}, seed={seed})")
        assert abs(h_k["best_test_acc"] - h_a["best_test_acc"]) <= 0.02


def test_population_scanner_clips_each_member():
    """Each member steps as ``make_minibatch_epochs_scanner`` (keyed) alone,
    its global-norm clip over its own gradients: member 1's are far past
    the clip, member 0's inside it."""
    def loss_one(p, generator, xb):
        noise = torch.randn(xb.shape, generator=generator)
        return ((p.weight * (xb + noise)).sum() - 1.0) ** 2

    def fresh(w):
        p = torch.nn.Linear(5, 1, bias=False)
        with torch.no_grad():
            p.weight.fill_(w)
        return init_state(p, make_optimizer(1e-2, params=p.parameters(),
                                            kind="adamw", weight_decay=0.1,
                                            grad_clip=1.0))

    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 2, 3, 4, 5)).astype(np.float32))   # (P, epochs, batches, B, 5)
    scale = (0.01, 30.0)
    pop = PopulationState(tuple(fresh(0.1 * s) for s in scale))
    run = make_population_epochs_scanner(
        lambda ps, gens, extras, xb: torch.stack(
            [loss_one(p, g, xb[m] * extras[m])
             for m, (p, g) in enumerate(zip(ps, gens))]))
    pop, losses = run(pop, [(5, 10), (6, 20)], scale, (x,))
    assert losses.shape == (2, 2, 3)
    for m, (seed, ep0) in enumerate([(5, 10), (6, 20)]):
        single, want = make_minibatch_epochs_scanner(
            lambda p, g, xb, s=scale[m]: loss_one(p, g, xb * s),
            keyed=True)(fresh(0.1 * scale[m]), (seed, ep0), (x[m],))
        torch.testing.assert_close(losses[m], want, rtol=0, atol=0)
        torch.testing.assert_close(pop.params[m].weight, single.params.weight,
                                   rtol=0, atol=0)


def test_population_steps_match_jax_float64():
    """float64, std-0 members (the two packages' noise RNGs differ, so no
    noisy member can match): two population steps from ``vmap(init)``'s
    parameters on the same minibatches, the block losses and every
    member's parameters after them against the JAX package's
    ``make_population_epochs_scanner``."""
    seeds = (0, 1)
    jspec = JM.KanFetMLPNODESpec(**TRAIN, solver_mode="scan")
    jp = _tree32(jax.vmap(lambda k: JM.kanfet_mlp_node_init(k, jspec))(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds])))
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 2, 4, TRAIN["T"]))   # (P, E, nb, B, T)
    y = rng.integers(0, 2, (2, 1, 2, 4)).astype(np.int32)
    tx = j_make_optimizer(1e-3, kind="adamw", weight_decay=1e-4,
                          grad_clip=1.0, params=p64)

    def loss_fn(p, key, std, xb, yb):
        return jdrv.cross_entropy(JM.kanfet_mlp_node_apply(
            p, jspec, xb, noise_key=key, noise_std=std), yb)

    state = jax.vmap(lambda p: j_init_state(p, tx))(p64)
    state, jlosses = j_pop(loss_fn, tx)(
        state, jax.random.split(jax.random.PRNGKey(3), 2),
        jnp.zeros(2, jnp.float64), (jnp.asarray(x), jnp.asarray(y)))

    tspec = TM.KanFetMLPNODESpec(**TRAIN, solver_mode="scan")
    mods = []
    for m in range(2):
        mod = TM.kanfet_mlp_node_init(torch.Generator(), tspec,
                                      dtype=torch.float64)
        mod.load_state_dict(ecg_params_from_numpy(
            jax.tree_util.tree_map(lambda a: a[m], jp), dtype=np.float64))
        mods.append(mod)
    pop = PopulationState(tuple(init_state(mod, make_optimizer(
        1e-3, params=mod.parameters(), kind="adamw", weight_decay=1e-4,
        grad_clip=1.0)) for mod in mods))
    run = make_population_epochs_scanner(
        lambda ps, gens, stds, xb, yb: torch.stack([
            tdrv.cross_entropy(lg, yb[m]) for m, lg in enumerate(
                TM.kanfet_mlp_node_apply_members(
                    ps, tspec, xb, generators=gens, noise_stds=stds))]))
    pop, losses = run(pop, [(s, 0) for s in seeds], [0.0, 0.0],
                      (torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jlosses),
                               rtol=1e-9)
    for m in range(2):
        got = _flat(jax.tree_util.tree_leaves(ecg_params_to_numpy(
            pop.params[m], np.float64)))
        want = _flat(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda a: np.asarray(a[m]), state.params)))
        start = _flat(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda a: np.asarray(a[m]), p64)))
        assert _rel(got, want) < 1e-9
        assert np.abs(got - start).max() > 1e-4     # the steps moved it


# --------------------------------------------------------------- the CLI


def test_cli_noise_study_on_cpu(tmp_path):
    """``cli ecg --model noise_study`` on the CPU at a tiny grid: one entry
    a std with the JAX CLI's keys, finite member losses, eval chunks of
    twice the batch."""
    result = cli.main(["ecg", "--device", "cpu", "--model", "noise_study",
                       "--epochs", "1", "--latent_dim", "4", "--num_basis",
                       "2", "--noise_stds", "0,0.2", "--noise_seeds", "0,1",
                       "--out-dir", str(tmp_path)])
    with open(tmp_path / "noise_study.json") as f:
        summary = json.load(f)
    assert summary == result["noise_study"]
    assert set(summary) == {"0.0", "0.2"}
    for entry in summary.values():
        assert set(entry) == {"mean_best_test_acc", "per_seed"}
        assert set(entry["per_seed"]) == {"0", "1"}
        assert 0.0 <= entry["mean_best_test_acc"] <= 1.0
    assert len(result["loss_curves"]) == 4
    assert np.isfinite(list(result["loss_curves"].values())).all()
    assert result["eval_chunk"] == 16


@pytest.mark.parametrize("mode", ["auto", "pallas", "scan"])
def test_cli_noise_study_takes_one_eval_chunk(mode, tmp_path, monkeypatch,
                                              capsys):
    """Every solver mode evaluates in chunks of 2 x batch_size (the JAX CLI
    sets them in pallas mode only); scan runs as auto, saying so."""
    seen = {}

    def fake(init_fn, apply_fn, data, noise_stds, run, seeds, log):
        seen["run"] = run
        return {std: {seed: {"best_test_acc": 0.5, "loss": [0.1],
                             "block_seconds": [0.0]} for seed in seeds}
                for std in noise_stds}

    monkeypatch.setattr(tdrv, "compare_noise_population", fake)
    cli.main(["ecg", "--device", "cpu", "--model", "noise_study",
              "--solver_mode", mode, "--batch_size", "4", "--out-dir",
              str(tmp_path)])
    assert seen["run"].eval_chunk == 8
    assert seen["run"].eval_noise_draws == 4
    assert ("runs as 'auto'" in capsys.readouterr().out) == (mode == "scan")


@pytest.mark.parametrize("case", ["ckpt_dir", "mesh_model", "mesh_devices",
                                  "aot_cache", "gate_impl", "generator",
                                  "cli_mesh_model"])
def test_population_refusals(case, tmp_path):
    spec = TM.KanFetMLPNODESpec(**TRAIN)
    if case in ("ckpt_dir", "mesh_model"):
        run = dataclasses.replace(RUN, **{case: "x" if case == "ckpt_dir"
                                          else 2})
        with pytest.raises(ValueError, match="train_ecg_population"):
            _population(spec, run)
    elif case == "mesh_devices":
        # the members over the ranks are ported
        # (tests/test_torch_mesh_drivers.py): P = 3 does not divide over 2
        # ranks, and 2 ranks without their process group refuse
        run = dataclasses.replace(RUN, mesh_devices=2)
        with pytest.raises(ValueError, match="not divisible by "
                                             "mesh_devices=2"):
            _population(spec, run)
        with pytest.raises(RuntimeError, match="process group"):
            _population(spec, run, MEMBERS[:2])
    elif case == "aot_cache":
        # accepted and logged: the port has no compiled program to cache
        logs = []
        tdrv.train_ecg_population(
            lambda g: TM.kanfet_mlp_node_init(g, spec),
            lambda ps, x, gens, stds: TM.kanfet_mlp_node_apply_members(
                ps, spec, x, generators=gens, noise_stds=stds),
            _data(), dataclasses.replace(RUN, aot_cache="x", epochs=2),
            MEMBERS[:1], log=logs.append)
        assert any("aot_cache" in m for m in logs)
    elif case == "cli_mesh_model":
        with pytest.raises(SystemExit, match="noise_study"):
            cli.main(["ecg", "--device", "cpu", "--model", "noise_study",
                      "--mesh_model", "2", "--out-dir", str(tmp_path)])
    else:
        params = [TM.kanfet_mlp_node_init(torch.Generator(), spec)
                  for _ in range(2)]
        x = torch.zeros(2, 3, spec.T)
        if case == "gate_impl":
            with pytest.raises(ValueError, match="tanh"):
                TM.kanfet_mlp_node_apply_members(
                    params, spec._replace(gate_impl="tanh",
                                          solver_mode="pallas"), x)
        else:
            with pytest.raises(ValueError, match="generator"):
                TM.kanfet_mlp_node_apply_members(
                    params, spec._replace(solver_mode="pallas"), x,
                    noise_stds=[0.0, 0.2])
