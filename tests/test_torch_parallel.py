"""PyTorch port, ``fetode_tpu_torch/parallel``: the mesh and sharding rules
against the JAX package's ``fetode_tpu/parallel`` (in this process), and
the data x model step over four gloo ranks against the single-device JAX
step of ``tests/test_parallel.py``.

The rules (``make_mesh``, ``parse_mesh_flag``, ``model_param_specs``,
``kan_param_specs``, ``shard_batch_leaves``, the multi-slice mesh) run in
the pytest process on layout-only meshes, as the JAX tests run on the
virtual devices.  The multi-rank case spawns four CPU ranks once for the
module (``parallel.spawn_local``: gloo through a file store, one torch
thread a rank; the JAX package is imported inside the functions that
use it, so a rank, which imports this module, loads no JAX): a data = 2
x model = 2 mesh, the
KAN's output features over 'model' (``kan_stack_param_specs``), each rank
storing its block and gathering the module after the step, the rows over
every rank (``shard_rows``: each rank 4 of the 16).  Tolerances are the JAX test's: the forward within 2e-5, the
step's loss rtol 1e-5, the parameters after it atol 2e-5 (with a clip
that bites as well: the global norm summed over the model group).
"""

import sys

import numpy as np
import pytest
import torch

from fetode_tpu_torch import parallel as TP
from fetode_tpu_torch.convert import _flatten, params_from_numpy
from fetode_tpu_torch.models.predprey import PredPreyNODE as TPredPreyNODE
from fetode_tpu_torch.models.predprey import predict_batch
from fetode_tpu_torch.nn.kan import KAN
from fetode_tpu_torch.parallel.collectives import all_gather_cat
from fetode_tpu_torch.train.loop import init_state, make_train_step
from fetode_tpu_torch.train.optim import make_optimizer

N_RANKS = 4
CLIP = 1e-3


@pytest.mark.parametrize("n, model, shape", [(8, 1, (8, 1)), (8, 2, (4, 2)),
                                             (4, 4, (1, 4)), (2, 1, (2, 1))])
def test_make_mesh_shapes_match_jax(n, model, shape):
    from fetode_tpu.parallel import make_mesh as j_make_mesh

    m = TP.make_mesh(n, model=model)
    assert (m.shape["data"], m.shape["model"]) == shape
    assert dict(j_make_mesh(n, model=model).shape) == m.shape
    assert not m.live and m.rank == 0       # no group of n ranks here


@pytest.mark.parametrize("kw", [dict(n_devices=8, model=3),
                                dict(n_devices=8, data=3, model=2)])
def test_make_mesh_raises_as_jax(kw):
    from fetode_tpu.parallel import make_mesh as j_make_mesh

    with pytest.raises(ValueError):
        j_make_mesh(**kw)
    with pytest.raises(ValueError):
        TP.make_mesh(**kw)


def test_mesh_coordinates_are_row_major():
    m = TP.make_mesh(8, model=2)
    assert [tuple(m.coords(r).values()) for r in range(8)] == \
        [(r // 2, r % 2) for r in range(8)]


def test_model_param_specs_rule():
    """The JAX test's five leaves: float leaves with ndim >= 2 and a
    divisible leading dim shard over 'model'; everything else replicates;
    a model = 1 mesh replicates everything."""
    import jax.numpy as jnp

    from fetode_tpu.parallel import make_mesh as j_make_mesh
    from fetode_tpu.parallel import model_param_specs as j_model_specs

    shapes = {"w": ((16, 3), np.float32), "w3": ((4, 2, 5), np.float32),
              "bias": ((16,), np.float32), "odd": ((3, 3), np.float32),
              "ints": ((8, 2), np.int32)}
    jtree = {k: jnp.zeros(s, d) for k, (s, d) in shapes.items()}
    ttree = {k: torch.from_numpy(np.zeros(s, d)) for k, (s, d) in
             shapes.items()}
    want = j_model_specs(jtree, j_make_mesh(8, model=2))
    got = TP.model_param_specs(ttree, TP.make_mesh(8, model=2))
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["w"] == ("model", None) and got["odd"] == ()
    got1 = TP.model_param_specs(ttree, TP.make_mesh(8, model=1))
    assert all(s == () for s in got1.values())


def test_kan_param_specs_match_jax():
    import jax

    from fetode_tpu.models.predprey import PredPreyNODE, predprey_init
    from fetode_tpu.parallel import kan_stack_param_specs as j_kan_specs

    spec = PredPreyNODE.kanfet(layers_hidden=(2, 4, 2), ferro_num_basis=2)
    jspecs = j_kan_specs(predprey_init(jax.random.PRNGKey(0), spec))
    want = {}
    for i, layer in enumerate(jspecs):
        _flatten(f"layers.{i}.", layer, want)
    kan = KAN(TPredPreyNODE.kanfet(layers_hidden=(2, 4, 2),
                                   ferro_num_basis=2).kan)
    got = TP.kan_stack_param_specs(kan)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["layers.0.base_weight"] == ("model", None)
    assert got["layers.0.ferro.coef"] == (None, "model", None)
    assert set(got) == set(kan.state_dict())


def test_parse_mesh_flag():
    assert TP.parse_mesh_flag("data=4,model=2") == (8, 2)
    assert TP.parse_mesh_flag("8") == (8, 1)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert TP.parse_mesh_flag("auto") == (n, 1)


def test_shard_batch_leaves_handles_ragged():
    mesh = TP.make_mesh(8)
    tree = {"even": torch.arange(4 * 16 * 3.0).reshape(4, 16, 3),
            "ragged": torch.zeros((4, 10, 3)),
            "keys": torch.zeros((4, 2), dtype=torch.int64)}
    out = TP.shard_batch_leaves(tree, mesh, batch_axis=1)
    assert out["even"].shape == (4, 2, 3)            # rank 0's two rows
    assert torch.equal(out["even"], tree["even"][:, :2])
    assert out["ragged"] is tree["ragged"]
    assert out["keys"] is tree["keys"]


def test_sharding_local_block():
    mesh = TP.make_mesh(4, model=2)
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(TP.Sharding(mesh, ("data", "model")).local(x),
                       x[:2, :3])
    assert torch.equal(TP.replicated(mesh).local(x), x)
    assert torch.equal(TP.batch_sharding(mesh).local(x), x[:2])
    with pytest.raises(ValueError, match="not divisible"):
        TP.Sharding(mesh, (None, "model")).local(torch.zeros(2, 3))


def test_multislice_mesh_and_global_sharding():
    mesh = TP.make_multislice_mesh()
    assert mesh.axis_names == ("dcn", "data", "model")
    assert mesh.shape["dcn"] == 1
    sh = TP.global_batch_sharding(mesh)
    assert sh.spec == (("dcn", "data"),)
    x = torch.arange(8.0 * 3).reshape(8, 3)
    assert torch.equal(sh.local(x), x)


def test_layout_mesh_refuses_collectives():
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        TP.driver_mesh(2)
    assert TP.driver_mesh(0) is None


def test_backend_refusals(monkeypatch):
    """More NCCL ranks on a host than cards raises before any group is
    made; NCCL needs CUDA ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one NCCL rank per card"):
        TP.initialize_distributed("file:///nonexistent", 2, 1,
                                  device="cuda")
    with pytest.raises(ValueError, match="needs CUDA ranks"):
        TP.initialize_distributed("file:///nonexistent", 2, 0, device="cpu",
                                  backend="nccl")
    TP.initialize_distributed(num_processes=1)          # one process: no-op
    assert TP.world() == (0, 1)


# ------------------------------------------------- data x model, four ranks


def _dp_tp_rank(rank, inp):
    """A rank of the data = 2 x model = 2 mesh: the KAN's output features
    over 'model' (each rank stores its block), the rows over every rank
    (``shard_rows``); the forward of every row and one Adam step (without
    and with a clip that bites) on the rank's rows."""
    torch.set_num_threads(1)
    spec = TPredPreyNODE.kanfet(layers_hidden=(2, 4, 2), ferro_num_basis=2,
                                method="rk4")
    ts = torch.from_numpy(inp["ts"])
    mesh = TP.make_mesh(4, model=2)
    x0s, tg = TP.shard_rows((torch.from_numpy(inp["x0s"]),
                             torch.from_numpy(inp["targets"])), mesh)
    out = {"coords": mesh.coords(), "jax_loaded": "jax" in sys.modules}
    for clip in (None, inp["clip"]):
        kan = KAN(spec.kan)
        kan.load_state_dict(params_from_numpy(inp["params"]))
        place = TP.shard_params(kan, mesh, TP.kan_stack_param_specs(kan),
                                grad_sum=True)
        out["blocks"] = {k: b.detach().numpy().copy()
                         for k, (b, _) in place.blocks.items()}
        with torch.no_grad():
            pred = predict_batch(kan, spec, x0s, ts)
        out["forward"] = all_gather_cat(
            pred, mesh.group(mesh.axis_names)).numpy()
        state = init_state(kan, make_optimizer(1e-3, params=place,
                                               kind="adam", grad_clip=clip))
        step = make_train_step(
            lambda p, x, y: torch.mean((predict_batch(p, spec, x, ts) - y)
                                       ** 2))
        state, loss = step(state, x0s, tg)
        tag = "clip" if clip else "plain"
        out[f"loss_{tag}"] = float(loss)
        out[f"params_{tag}"] = {k: v.detach().numpy().copy()
                                for k, v in kan.state_dict().items()}
    return out


def _jax_reference():
    import jax
    import jax.numpy as jnp
    import optax

    from fetode_tpu.models.predprey import PredPreyNODE, predict, predprey_init
    from fetode_tpu.train.optim import make_optimizer as j_make_optimizer

    key = jax.random.PRNGKey(0)
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 4, 2), ferro_num_basis=2,
                               method="rk4")
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    predprey_init(key, spec))
    ts = jnp.linspace(0.0, 1.0, 5, dtype=jnp.float32)
    x0s = jax.random.uniform(key, (16, 2), jnp.float32, 0.5, 2.0)
    targets = jnp.ones((16, 5, 2), jnp.float32)
    fwd = jax.vmap(lambda x0: predict(params, spec, x0, ts))(x0s)
    ref = {"forward": np.asarray(fwd)}
    for tag, clip in (("plain", None), ("clip", CLIP)):
        tx = j_make_optimizer(1e-3, kind="adam", grad_clip=clip,
                              params=params)

        def loss_fn(p):
            preds = jax.vmap(lambda x0: predict(p, spec, x0, ts))(x0s)
            return jnp.mean((preds - targets) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        new = optax.apply_updates(params, updates)
        ref[f"loss_{tag}"] = float(loss)
        ref[f"params_{tag}"] = {k: v.numpy() for k, v in params_from_numpy(
            jax.tree_util.tree_map(np.asarray, new)).items()}
    inputs = {"params": jax.tree_util.tree_map(np.asarray, params),
              "ts": np.asarray(ts), "x0s": np.asarray(x0s),
              "targets": np.asarray(targets), "clip": CLIP}
    return ref, inputs


@pytest.fixture(scope="module")
def dp_tp():
    ref, inputs = _jax_reference()
    results = TP.spawn_local(_dp_tp_rank, N_RANKS, (inputs,), device="cpu",
                             timeout=120)
    return ref, inputs, results


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_dp_tp_forward_matches_unsharded(dp_tp, rank):
    ref, _, res = dp_tp
    assert not res[rank]["jax_loaded"]
    np.testing.assert_allclose(res[rank]["forward"], ref["forward"],
                               atol=2e-5)


@pytest.mark.parametrize("tag", ["plain", "clip"])
@pytest.mark.parametrize("rank", range(N_RANKS))
def test_dp_tp_train_step_matches_unsharded(dp_tp, rank, tag):
    """The loss of one Adam step and the parameters after it (gathered
    from the model blocks) against the single-device JAX step.  The knot
    grids are buffers in the port, which no optimiser steps (the JAX
    optimiser moves them), so they are held to their initial values."""
    ref, inputs, res = dp_tp
    np.testing.assert_allclose(res[rank][f"loss_{tag}"], ref[f"loss_{tag}"],
                               rtol=1e-5)
    got = res[rank][f"params_{tag}"]
    assert set(got) == set(ref[f"params_{tag}"])
    init = params_from_numpy(inputs["params"])
    for k, v in ref[f"params_{tag}"].items():
        want = init[k].numpy() if k.endswith(".grid") else v
        np.testing.assert_allclose(got[k], want, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_dp_tp_blocks_are_the_rank_rows(dp_tp, rank):
    """Each rank stores its model index's block of every sharded leaf (the
    initial parameters), replicated over 'data'."""
    _, inputs, res = dp_tp
    full = {k: v.numpy() for k, v in params_from_numpy(
        inputs["params"]).items()}
    m = res[rank]["coords"]["model"]
    assert res[rank]["coords"] == {"data": rank // 2, "model": rank % 2}
    specs = TP.kan_stack_param_specs(KAN(TPredPreyNODE.kanfet(
        layers_hidden=(2, 4, 2), ferro_num_basis=2).kan))
    sharded = {k for k, s in specs.items() if "model" in s and k != "grid"}
    assert set(res[rank]["blocks"]) == {
        k for k in sharded if k in full and not k.endswith("grid")}
    for k, blk in res[rank]["blocks"].items():
        dim = specs[k].index("model")
        np.testing.assert_array_equal(
            blk, np.split(full[k], 2, axis=dim)[m])
