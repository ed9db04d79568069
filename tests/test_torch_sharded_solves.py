"""PyTorch port, the four per-shard whole solves (B.2
``kanfet_solve_train_sharded``, B.4 ``ferro_node_solve_sharded`` clean and
with frozen device noise, B.5 ``logistic_node_solve_sharded``, B.6
``mlp_node_solve_sharded``) and one ``kanfet_mlp_node`` training step with
``mesh=``, over two gloo ranks, against the JAX package's
``pallas_*_solve_sharded`` and ``kanfet_mlp_node_apply(mesh=)`` on a
two-device mesh of the virtual CPU devices (the Pallas kernels in
interpret mode).

Shapes as in the single-device tests (``tests/test_torch_adjoint.py``,
``test_torch_ferro_node.py``, ``test_torch_logistic_node.py``,
``test_torch_mlp_node.py``), with B = 4 rows, two a rank: flagship KANFET
[2, 10, 2] on the first 12 fit times and the ECG fields, all at rtol
1e-2, where every error estimate lies far above float32 rounding, so both
frameworks take the same steps on every shard (at the adjoint tests' rtol
1e-4 the first error estimate of B.2 sits at float32 rounding and the two
frameworks' meshes part after it, ``tests/test_torch_adjoint.py``).
Parameters come from the JAX init through ``convert.py``; states and
cotangents from a numpy seed; the device noise is the JAX package's draw
for the global batch, handed to the port as numpy.  The ranks run once
for the module (``parallel.spawn_local``; on the CPU each rank's solve
is the kernels' plain version); the JAX package is imported inside the
functions that use it, so a rank, which imports this module, loads no
JAX.

Tolerances (the issue of the port's mesh): outputs and the loss rtol
1e-5, gradients rtol 1e-4 / atol 1e-6.  Each rank's block of the output
equals the unsharded solve of its own rows bit for bit: the per-shard
step control.
"""

import sys

import numpy as np
import pytest
import torch

from fetode_tpu_torch.convert import ecg_params_from_numpy, params_from_numpy
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.models import predprey as tpp
from fetode_tpu_torch.nn.kan import KAN
from fetode_tpu_torch.ops import ferro_node as FN
from fetode_tpu_torch.ops import kanfet_adjoint as KA
from fetode_tpu_torch.ops import logistic_node as LN
from fetode_tpu_torch.ops import mlp_node as MN
from fetode_tpu_torch.parallel import make_mesh as t_make_mesh
from fetode_tpu_torch.parallel import spawn_local

B = 4
SOLVES = ("B.2", "B.4", "B.4 noisy", "B.5", "B.6")
FERRO = dict(T=24, latent_dim=8, ode_hidden=12, num_basis=3, max_steps=16)
LOGISTIC = dict(T=24, latent_dim=8, num_basis=4, max_steps=16)
MLP = dict(T=24, latent_dim=8, num_basis=4, ode_hidden=16, field="mlp",
           max_steps=16)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _np_tree(t):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _value_and_grads(fn, params, h0, hbar):
    """sum(fn(params, h0) * hbar), its output and its gradients."""
    import jax
    import jax.numpy as jnp

    def loss(p, h):
        y = fn(p, h)
        return jnp.sum(y * hbar), y

    (lv, y), (gp, gh) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, h0)
    return dict(out=np.asarray(y), loss=float(lv), g_params=_np_tree(gp),
                g_h0=np.asarray(gh))


def _jax_and_inputs():
    import jax
    import jax.numpy as jnp
    import optax

    from fetode_tpu.models import ecg as JM
    from fetode_tpu.models import predprey as jpp
    from fetode_tpu.ops.pallas_adjoint import (
        pallas_kanfet_solve_train_sharded,
    )
    from fetode_tpu.ops.pallas_ferro_node import (
        _spec_solve_noise,
        pallas_ferro_node_solve_sharded,
    )
    from fetode_tpu.ops.pallas_logistic_node import (
        pallas_logistic_node_solve_sharded,
    )
    from fetode_tpu.ops.pallas_mlp_node import pallas_mlp_node_solve_sharded
    from fetode_tpu.parallel import make_mesh

    mesh = make_mesh(2)
    rng = np.random.default_rng(1)
    ref, inputs = {}, {}

    # B.2: flagship KANFET, the first 12 fit times
    task = jpp.PredPreyTask()
    ts = np.linspace(0.0, task.tf_learn, task.n_train,
                     dtype=np.float32)[:12]
    jspec = jpp.PredPreyNODE.kanfet(max_steps=64)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                jpp.predprey_init(jax.random.PRNGKey(0),
                                                  jspec))
    x0s = rng.uniform(0.5, 2.0, (B, 2)).astype(np.float32)
    ybar = rng.standard_normal((B, 12, 2)).astype(np.float32)
    opts = dict(rtol=1e-2, atol=1e-3, max_steps=64)
    ref["B.2"] = _value_and_grads(
        lambda p, x: pallas_kanfet_solve_train_sharded(
            p, jspec.kan, x, jnp.asarray(ts), mesh, interpret=True, **opts),
        jp, jnp.asarray(x0s), ybar)
    ref["B.2"]["names"] = params_from_numpy(ref["B.2"]["g_params"])
    inputs["b2"] = dict(kan_cfg=tpp.PredPreyNODE.kanfet(max_steps=64).kan,
                        params=_np_tree(jp), ts=ts, x0s=x0s, ybar=ybar,
                        opts=opts)

    # B.4: the ferro field, clean and with frozen noise of std 0.15
    jspec = JM.KanFetMLPNODESpec(**FERRO)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                JM.kanfet_mlp_node_init(
                                    jax.random.PRNGKey(0), jspec))
    h0 = rng.standard_normal((B, FERRO["latent_dim"])).astype(np.float32)
    hbar = rng.standard_normal(h0.shape).astype(np.float32)
    jnoisy = jspec._replace(noise_std=0.15)
    key = jax.random.PRNGKey(7)
    for tag, s, kw in (("B.4", jspec, {}),
                       ("B.4 noisy", jnoisy, dict(noise_key=key))):
        ref[tag] = _value_and_grads(
            lambda p, h, s=s, kw=kw: pallas_ferro_node_solve_sharded(
                p["fc1"], p["fc2"], h, s, mesh, interpret=True, **kw),
            jp, jnp.asarray(h0), hbar)
        ref[tag]["names"] = ecg_params_from_numpy(ref[tag]["g_params"])
    noise = _spec_solve_noise(jp["fc1"], jp["fc2"], jnp.asarray(h0),
                              jnoisy.fc1_cfg, jnoisy.fc2_cfg, key)
    inputs["b4"] = dict(spec=TM.KanFetMLPNODESpec(**FERRO),
                        spec_noisy=TM.KanFetMLPNODESpec(**FERRO,
                                                        noise_std=0.15),
                        params=_np_tree(jp), h0=h0, hbar=hbar,
                        noise=[np.asarray(n, np.float32) for n in noise])

    # B.5 / B.6: the logistic-mixer and KAN-MLP fields at their inits
    for tag, key_, sd, fn in (
            ("B.5", "b5", LOGISTIC, pallas_logistic_node_solve_sharded),
            ("B.6", "b6", MLP, pallas_mlp_node_solve_sharded)):
        jspec = JM.KanFetNODESpec(**sd)
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    JM.kanfet_node_init(
                                        jax.random.PRNGKey(0), jspec))
        h0 = rng.standard_normal((B, sd["latent_dim"])).astype(np.float32)
        hbar = rng.standard_normal(h0.shape).astype(np.float32)
        ref[tag] = _value_and_grads(
            lambda p, h, s=jspec, f=fn: f(p, h, s, mesh, interpret=True),
            jp, jnp.asarray(h0), hbar)
        ref[tag]["names"] = ecg_params_from_numpy(ref[tag]["g_params"])
        inputs[key_] = dict(spec=TM.KanFetNODESpec(**sd),
                            params=_np_tree(jp), h0=h0, hbar=hbar)

    # one kanfet_mlp_node cross-entropy step with mesh=
    jspec = JM.KanFetMLPNODESpec(**FERRO, solver_mode="pallas")
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                JM.kanfet_mlp_node_init(
                                    jax.random.PRNGKey(3), jspec))
    x = rng.standard_normal((B, FERRO["T"])).astype(np.float32)
    y = np.asarray([0, 1, 1, 0], np.int32)

    def ce(p):
        logits = JM.kanfet_mlp_node_apply(p, jspec, jnp.asarray(x),
                                          mesh=mesh)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (lv, logits), g = jax.jit(jax.value_and_grad(ce, has_aux=True))(jp)
    ref["ecg"] = dict(loss=float(lv), logits=np.asarray(logits),
                      names=ecg_params_from_numpy(_np_tree(g)))
    inputs["ecg"] = dict(spec=TM.KanFetMLPNODESpec(**FERRO), x=x, y=y,
                         params=_np_tree(jp))
    return ref, inputs


def _solves_rank(rank, inp):
    """A rank: the four per-shard solves on a data = 2 mesh: each global output,
    the gradients of sum(out * cotangent) and, per rank, the unsharded
    solve of the rank's own rows for comparison."""
    torch.set_num_threads(1)
    mesh = t_make_mesh(2)
    out = {"jax_loaded": "jax" in sys.modules}

    def run(name, module, solve_sharded, solve_one, h0, hbar):
        h = torch.from_numpy(h0).requires_grad_(True)
        y = solve_sharded(module, h)
        loss = torch.sum(y * torch.from_numpy(hbar))
        loss.backward()
        res = {"out": _np(y), "loss": float(loss), "g_h0": _np(h.grad),
               "grads": {k: _np(p.grad) for k, p in module.named_parameters()
                         if p.grad is not None}}
        b = h0.shape[0] // 2
        # the same path as inside the sharded solve (under autograd)
        mine = solve_one(module, torch.from_numpy(
            h0[rank * b:(rank + 1) * b]).requires_grad_(True))
        res["own_rows"] = _np(mine)
        res["block"] = res["out"][rank * b:(rank + 1) * b]
        out[name] = res

    b2 = inp["b2"]
    kan = KAN(b2["kan_cfg"])
    kan.load_state_dict(params_from_numpy(b2["params"]))
    ts = torch.from_numpy(b2["ts"])
    opts = b2["opts"]
    run("B.2", kan,
        lambda m, x: KA.kanfet_solve_train_sharded(m, m.cfg, x, ts, mesh,
                                                   **opts),
        lambda m, x: KA.kanfet_solve_train(m, m.cfg, x, ts, **opts),
        b2["x0s"], b2["ybar"])

    b4 = inp["b4"]
    for tag, spec in (("B.4", b4["spec"]), ("B.4 noisy", b4["spec_noisy"])):
        m = TM.kanfet_mlp_node_init(torch.Generator().manual_seed(0), spec)
        m.load_state_dict(ecg_params_from_numpy(b4["params"]))
        noise = (tuple(torch.from_numpy(n) for n in b4["noise"])
                 if tag.endswith("noisy") else None)
        b = b4["h0"].shape[0] // 2

        def own(mm, h, noise=noise, spec=spec):
            nz = None if noise is None else tuple(
                n[rank * b:(rank + 1) * b] for n in noise)
            return FN.ferro_node_solve(mm.fc1, mm.fc2, h, spec, noise=nz)

        run(tag, m,
            lambda mm, h, noise=noise, spec=spec: FN.ferro_node_solve_sharded(
                mm.fc1, mm.fc2, h, spec, mesh, noise=noise),
            own, b4["h0"], b4["hbar"])

    for tag, key, sharded, one in (
            ("B.5", "b5", LN.logistic_node_solve_sharded,
             LN.logistic_node_solve),
            ("B.6", "b6", MN.mlp_node_solve_sharded, MN.mlp_node_solve)):
        d = inp[key]
        m = TM.kanfet_node_init(torch.Generator().manual_seed(0), d["spec"])
        m.load_state_dict(ecg_params_from_numpy(d["params"]))
        run(tag, m,
            lambda mm, h, spec=d["spec"], f=sharded: f(mm, h, spec, mesh),
            lambda mm, h, spec=d["spec"], f=one: f(mm, h, spec),
            d["h0"], d["hbar"])

    # one kanfet_mlp_node cross-entropy step's loss and gradients, mesh=
    e = inp["ecg"]
    m = TM.kanfet_mlp_node_init(torch.Generator().manual_seed(0), e["spec"])
    m.load_state_dict(ecg_params_from_numpy(e["params"]))
    logits = TM.kanfet_mlp_node_apply(m, e["spec"], torch.from_numpy(e["x"]),
                                      mesh=mesh)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(e["y"]).long())
    loss.backward()
    out["ecg"] = {"loss": float(loss), "logits": _np(logits),
                  "grads": {k: _np(p.grad) for k, p in m.named_parameters()
                            if p.grad is not None}}
    return out


@pytest.fixture(scope="module")
def solves():
    ref, inputs = _jax_and_inputs()
    res = spawn_local(_solves_rank, 2, (inputs,), device="cpu", timeout=120)
    return ref, res


def _check_grads(got, want_by_name):
    assert got, "no gradients"
    for k, g in got.items():
        np.testing.assert_allclose(g, want_by_name[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("solve", SOLVES)
def test_sharded_solve_matches_jax(solves, solve, rank):
    """Output, loss and the gradients of the parameters and of the
    initial state, on every rank, against the JAX sharded solve."""
    ref, res = solves
    got, want = res[rank][solve], ref[solve]
    assert not res[rank]["jax_loaded"]
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["g_h0"], want["g_h0"], rtol=1e-4,
                               atol=1e-6)
    _check_grads(got["grads"], want["names"])


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("solve", SOLVES)
def test_rank_block_is_the_unsharded_solve_of_its_rows(solves, solve, rank):
    _, res = solves
    np.testing.assert_array_equal(res[rank][solve]["block"],
                                  res[rank][solve]["own_rows"])


@pytest.mark.parametrize("rank", [0, 1])
def test_kanfet_mlp_node_step_with_mesh_matches_jax(solves, rank):
    ref, res = solves
    got, want = res[rank]["ecg"], ref["ecg"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-6)
    _check_grads(got["grads"], want["names"])


def test_sharded_solves_refuse_an_indivisible_batch():
    mesh = t_make_mesh(2)
    spec = tpp.PredPreyNODE.kanfet()
    kan = KAN(spec.kan)
    with pytest.raises(ValueError, match="not divisible by data=2"):
        KA.kanfet_solve_train_sharded(kan, spec.kan, torch.ones((3, 2)),
                                      torch.linspace(0, 1, 4), mesh)
    m = TM.kanfet_mlp_node_init(torch.Generator().manual_seed(0),
                                TM.KanFetMLPNODESpec(**FERRO))
    with pytest.raises(ValueError, match="not divisible by data=2"):
        FN.ferro_node_solve_sharded(m.fc1, m.fc2, torch.ones((5, 8)),
                                    TM.KanFetMLPNODESpec(**FERRO), mesh)
    with pytest.raises(ValueError, match="noise_std with a mesh"):
        TM.kanfet_mlp_node_apply(m, TM.KanFetMLPNODESpec(**FERRO),
                                 torch.ones((2, FERRO["T"])), mesh=mesh,
                                 noise_std=0.1,
                                 generator=torch.Generator())
