"""PyTorch port, the conditional-diffusion node encoder's whole solve
(``ops/node_enc.py`` on ``ops/node_common.py``'s trajectory twins, at the
output times [0, 1]) against the JAX package's
``ops/pallas_node_enc.py: make_node_enc_solver`` in interpret mode
(``solver_mode="pallas"``) and against its XLA dopri5 path of
``node_encoder_apply`` (``linspace(0, 1, 5)``).

As in ``tests/test_pallas_node_enc.py``: d_in 3, cond_dim C = 16,
x_proj_dim P = 8, ode_hidden H = 16, B = 4 windows of L = 20 steps,
rtol 1e-3 / atol 1e-4, max_steps 24; parameters from the JAX
``node_encoder_init(PRNGKey(0))`` converted with
``convert.cond_diffusion_params_from_numpy``, the windows and the
cotangent from a numpy seed.

Tolerances:
* z(1) against the JAX kernel and the XLA path, float32: 1e-5, the JAX
  test's own (the kernel's mesh [0, 1] and the XLA path's
  ``linspace(0, 1, 5)`` step alike; only the dense output at t = 1
  rounds differently).
* gradients of every encoder tensor (field, LN, x_proj and the z0 chain)
  and of the windows: cosine > 0.999 and the JAX test's rtol 0.02 /
  atol 5e-5, the port's plain solve (record, then the replay's
  autograd) and its eager path against ``jax.grad`` through the JAX
  kernel and through the XLA scan.
The CUDA kernels are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models.cond_diffusion import NodeEncoderCfg as JCfg
from fetode_tpu.models.cond_diffusion import node_encoder_apply as j_apply
from fetode_tpu.models.cond_diffusion import node_encoder_init as j_init
from fetode_tpu_torch.convert import cond_diffusion_params_from_numpy
from fetode_tpu_torch.models import cond_diffusion as CD
from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops import node_enc as NE

CFG = dict(d_in=3, cond_dim=16, x_proj_dim=8, ode_hidden=16, rtol=1e-3,
           atol=1e-4, max_steps=24)
B, L = 4, 20


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


def _jax_grads(params, cfg, past, tgt, mode):
    def loss(p, x):
        return jnp.sum(j_apply(p, cfg._replace(solver_mode=mode), x) * tgt)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, past)
    return _tree(gp), np.asarray(gx)


def _tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


@pytest.fixture(scope="module")
def setup():
    cfg = JCfg(**CFG)
    params = j_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    past = rng.standard_normal((B, L, cfg.d_in)).astype(np.float32)
    tgt = rng.standard_normal((B, cfg.cond_dim)).astype(np.float32)
    jp = jnp.asarray(past)
    return dict(
        cfg=cfg, params=params, tree=_tree(params), past=past, tgt=tgt,
        kern=np.asarray(j_apply(params, cfg._replace(solver_mode="pallas"),
                                jp)),
        xla=np.asarray(j_apply(params, cfg._replace(solver_mode="while"),
                               jp)),
        g_kern=_jax_grads(params, cfg, jp, tgt, "pallas"),
        g_scan=_jax_grads(params, cfg, jp, tgt, "scan"))


def _encoder(s):
    tcfg = CD.NodeEncoderCfg(**CFG)
    enc = CD.node_encoder_init(torch.Generator().manual_seed(0), tcfg)
    state = cond_diffusion_params_from_numpy({"encoder": s["tree"],
                                              "net": []})
    enc.load_state_dict({k.removeprefix("encoder."): v
                         for k, v in state.items()})
    return tcfg, enc


def _chain(enc, past):
    """The encoder's projection and z0 chain around the solve."""
    x_seq = past @ enc.x_proj_w.T + enc.x_proj_b
    return x_seq[:, 0] @ enc.z0_w.T + enc.z0_b, x_seq


def _plain_encode(enc, tcfg, past):
    z0, x_seq = _chain(enc, past)
    return NE.node_enc_solve(enc, tcfg, z0, x_seq)


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                 + 1e-30))


def _port_grads(enc, past):
    """The gradient leaves in the JAX tree's order (leaves sorted by key,
    the field's layers in order) and the windows' gradient."""
    g = {k: p.grad.numpy() for k, p in enc.named_parameters()}
    tree = {k: v for k, v in g.items() if not k.startswith("field.")}
    tree["field"] = [{"w": g[f"field.{i}.w"], "b": g[f"field.{i}.b"]}
                     for i in range(3)]
    return jax.tree_util.tree_leaves(tree), past.grad.numpy()


def test_final_state_matches_jax_kernel_and_xla(setup):
    s = setup
    tcfg, enc = _encoder(s)
    past = torch.from_numpy(s["past"])
    with torch.no_grad():
        plain = _plain_encode(enc, tcfg, past)
        eager = CD.node_encoder_apply(enc, tcfg, past)
    assert plain.shape == (B, tcfg.cond_dim)
    for got in (plain, eager):
        for want in (s["kern"], s["xla"]):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("path", ["plain", "eager"])
def test_grads_match_jax_kernel_and_scan(setup, path):
    """Every encoder tensor's gradient (the field's three layers, LN, the
    x_proj and z0 chains) and the windows' gradient, which carries the
    signal cotangent through x_proj."""
    s = setup
    tcfg, enc = _encoder(s)
    past = torch.from_numpy(s["past"]).requires_grad_(True)
    out = (_plain_encode(enc, tcfg, past) if path == "plain"
           else CD.node_encoder_apply(enc, tcfg, past))
    torch.sum(out * torch.from_numpy(s["tgt"])).backward()
    leaves, g_past = _port_grads(enc, past)
    for gp, gx in (s["g_kern"], s["g_scan"]):
        want = jax.tree_util.tree_leaves(gp) + [gx]
        assert len(want) == len(leaves) + 1
        for a, b in zip(leaves + [g_past], want):
            a, b = a.ravel(), b.ravel()
            assert _cos(a, b) > 0.999
            np.testing.assert_allclose(a, b, rtol=0.02, atol=5e-5)


def test_signal_cotangent_nonzero_beyond_t0(setup):
    """Interior time steps feed the solve only through the interpolation;
    a broken scatter of the x(t) cotangent would zero them."""
    s = setup
    tcfg, enc = _encoder(s)
    past = torch.from_numpy(s["past"])
    z0, x_seq = _chain(enc, past)
    w = NE.field_weights(enc)
    with torch.no_grad():
        _, recs = NE.node_enc_fwd(w, z0, x_seq)
    ct = 2.0 * NE.node_enc_fwd(w, z0, x_seq, record=False)[0].detach()
    _, _, xbar = NE.node_enc_bwd(w, z0, x_seq, recs, ct)
    assert xbar.shape == x_seq.shape
    assert float(xbar[:, 1:-1].abs().sum()) > 0
    assert torch.isfinite(xbar).all()


def test_signal_rows_match_linear_interp():
    """The kernel's two rows and lerp weight are ``linear_interp`` on
    ``linspace(0, 1, L)``, clamped at both ends."""
    from fetode_tpu_torch.ops.interp import linear_interp

    xs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, L, 5)).astype(np.float32))
    grid = torch.linspace(0.0, 1.0, L)
    for t in (-0.1, 0.0, 0.013, 0.5, 0.73, 0.999, 1.0, 1.2):
        i0, w = NE.signal_rows(t, L)
        assert 0 <= i0 <= L - 2
        got = xs[:, i0] + w * (xs[:, i0 + 1] - xs[:, i0])
        torch.testing.assert_close(got, linear_interp(grid, xs, t),
                                   rtol=1e-6, atol=1e-6)


def test_wrappers_on_cpu_are_the_plain_version(setup):
    s = setup
    tcfg, enc = _encoder(s)
    past = torch.from_numpy(s["past"])
    z0, x_seq = _chain(enc, past)
    w = NE.field_weights(enc)
    before = (NE.node_enc_fwd.launches, NE.node_enc_bwd.launches)
    with torch.no_grad():
        z1, recs = NE.node_enc_fwd(w, z0, x_seq)
        traj, _ = NC.record_solve_traj_reference(
            NE.node_enc_field(w, x_seq), z0, torch.tensor([0.0, 1.0]),
            max_steps=tcfg.max_steps)
    np.testing.assert_array_equal(z1.numpy(), traj[1].numpy())
    ct = torch.from_numpy(s["tgt"])
    grads, z0bar, xbar = NE.node_enc_bwd(w, z0, x_seq, recs, ct)
    leaves = [t.detach().requires_grad_(True) for t in w + [z0, x_seq]]
    out = NC.replay_traj_reference(NE.node_enc_field(leaves[:9], leaves[10]),
                                   leaves[9], torch.tensor([0.0, 1.0]),
                                   recs)[1]
    want = torch.autograd.grad(torch.sum(out * ct), leaves)
    for g, r in zip(list(grads) + [z0bar, xbar], want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert (NE.node_enc_fwd.launches, NE.node_enc_bwd.launches) == before


def test_refusals(setup):
    s = setup
    tcfg, enc = _encoder(s)
    past = torch.from_numpy(s["past"])
    z0, x_seq = _chain(enc, past)
    w = NE.field_weights(enc)
    with pytest.raises(ValueError, match="h0 must be"):
        NE.node_enc_solve(enc, tcfg, z0[0], x_seq)
    with pytest.raises(ValueError, match="x_seq must be"):
        NE.node_enc_fwd(w, z0, x_seq[:, :1])
    with pytest.raises(ValueError, match="w1z"):
        NE.node_enc_fwd(w[:2] + [w[2][:, :-1]] + w[3:], z0, x_seq)
    with pytest.raises(ValueError, match="CUDA"):
        CD.node_encoder_apply(enc, tcfg._replace(solver_mode="pallas"), past)
    with pytest.raises(ValueError, match="rk4"):      # fixed-step: ported
        CD.node_encoder_apply(enc, tcfg._replace(solver="rk9"), past)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    tcfg, enc = _encoder(s)
    enc = enc.to(dev)
    with torch.no_grad():
        z0, x_seq = _chain(enc, torch.from_numpy(s["past"]).to(dev))
    w = NE.field_weights(enc)
    ct = torch.from_numpy(s["tgt"]).to(dev)
    with torch.no_grad():
        z1, recs = NE.node_enc_fwd(w, z0, x_seq)
        ref, _ = NC.record_solve_traj_reference(
            NE.node_enc_field(w, x_seq), z0, NE._ts(dev))
    torch.cuda.synchronize()
    np.testing.assert_allclose(z1.cpu().numpy(), ref[1].cpu().numpy(),
                               rtol=1e-3, atol=1e-3)
    got = NE.node_enc_bwd(w, z0, x_seq, recs, ct)
    cpu = [t.detach().cpu() for t in w]
    want = NE.node_enc_bwd(cpu, z0.cpu(), x_seq.cpu(), NC.SolveRecords(
        *(r.cpu() for r in recs)), ct.cpu())
    for g, r in zip(list(got[0]) + list(got[1:]), list(want[0])
                    + list(want[1:])):
        assert float((g.cpu() - r).norm() / r.norm()) < 1e-4


# ------------------------------------------------ the row-tile plan (B.8)
# Every batch the conditional-diffusion path gives the kernels
# (chip_smoke.py's NODE_ENC_CHECKS), one row and the widest bucket, at the
# encoder's widths (C = P = H = 128) and at this file's narrow ones.
PATH_BATCHES = (1, 8, 31, 64, 181, 256)
WIDE = (128, 128, 128)
NARROW = (CFG["cond_dim"], CFG["x_proj_dim"], CFG["ode_hidden"])


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("batch", PATH_BATCHES)
def test_row_plan_covers_every_row_once(batch, bwd):
    p = NE.row_plan(batch, *WIDE, bwd)
    # Up to 64 rows one cluster of <= 16 CTAs; past them a cooperative
    # grid of CTAs owning 4 rows each.
    assert p["grid"] == (batch > NE.MAX_CLUSTER * NE.CLUSTER_ROWS)
    if p["grid"]:
        assert p["R"] == NE.CLUSTER_ROWS and p["G"] <= NE.MAX_GRID
    else:
        assert p["R"] == -(-batch // NE.MAX_CLUSTER)
        assert 1 <= p["G"] <= NE.MAX_CLUSTER
    rows = [b for r in p["rows"] for b in r]
    assert rows == list(range(batch))             # each row once, in order
    assert all(len(r) >= 1 for r in p["rows"])    # no CTA without rows
    assert all(len(r) == p["R"] for r in p["rows"][:-1])
    assert p["smem_bytes"] <= NE.SMEM_BUDGET
    # w1z and W2 (128 KB) sit in every CTA's shared memory, with W3 and
    # the rows in every forward; the backward moves W3 to device memory
    # where that keeps its rows (past one a CTA) beside them.  w1x and its
    # transpose are each CTA's padded copies in device memory.
    assert p["weights_smem"] and p["rows_smem"]
    assert p["w3_smem"] == (not bwd or p["R"] == 1)
    assert p["wx_floats"] == 128 * 128
    assert p["work_floats"] >= p["G"] * 2 * p["wx_floats"]
    if bwd:
        assert p["tiles"] == 2 * 32 * 33 + 32 * 65   # [w|g2] x [a2|a1, 1],
        assert p["tiles"] > p["threads"] * p["tile_slots"]  # g1 x [zn, x, 1]


def test_row_plan_places_what_does_not_fit_in_device_memory():
    """Past 512 rows a CTA owns more than 4, and the backward's rows and
    weights go to device memory the CTA owns; the batch still runs on the
    kernels."""
    p = NE.row_plan(1000, *WIDE, bwd=True)
    assert p["grid"] and p["G"] <= NE.MAX_GRID and p["R"] == 8
    assert not p["rows_smem"] and not p["weights_smem"] and not p["w3_smem"]
    assert p["smem_bytes"] <= NE.SMEM_BUDGET
    assert p["work_floats"] >= p["G"] * p["R"] * p["record_floats"]
    wide = NE.row_plan(8, 256, 256, 256, bwd=True)   # weights > 227 KB
    assert not wide["weights_smem"] and not wide["rows_smem"]
    assert wide["smem_bytes"] <= NE.SMEM_BUDGET


@pytest.mark.parametrize("batch", (1, B, 64, 256))
def test_row_plan_holds_a_narrow_field_in_shared_memory(batch):
    """At this file's widths the weights and every batch's rows fit."""
    for bwd in (False, True):
        p = NE.row_plan(batch, *NARROW, bwd)
        assert p["weights_smem"] and p["rows_smem"]
        assert p["smem_bytes"] <= NE.SMEM_BUDGET
        assert [b for r in p["rows"] for b in r] == list(range(batch))
    with pytest.raises(ValueError, match="B must be"):
        NE.row_plan(0, *NARROW)


@pytest.mark.cuda
def test_kernels_same_bits_twice_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    s = setup
    tcfg, enc = _encoder(s)
    enc = enc.to(dev)
    with torch.no_grad():
        z0, x_seq = _chain(enc, torch.from_numpy(s["past"]).to(dev))
    w = NE.field_weights(enc)
    ct = torch.from_numpy(s["tgt"]).to(dev)
    with torch.no_grad():
        runs = [NE.node_enc_fwd(w, z0, x_seq) for _ in range(2)]
    grads = [NE.node_enc_bwd(w, z0, x_seq, runs[0][1], ct) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert all(torch.equal(a, b) for a, b in zip(grads[0][0], grads[1][0]))
    assert torch.equal(grads[0][1], grads[1][1])
    assert torch.equal(grads[0][2], grads[1][2])
