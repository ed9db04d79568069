"""PyTorch port, the wide-stack predprey whole-solve (``ops/kanfet_wide.py``
on ``ops/node_common.py``'s trajectory pair) against the JAX package's
``ops/pallas_kanfet_wide.py: make_wide_train_solver`` run in interpret
mode, and the routing of ``models/predprey.py``.

Three stacks, as ``tests/test_pallas_kanfet_wide.py`` sets them up: the
fixture's [2, 10, 2] at B = 1, the dispatch boundary [2, 32, 2] at B = 1
(in·out·K = 512) and [2, 8, 8, 2] at B = 3; rtol 1e-4 / atol 1e-6,
``max_steps`` 64, the first 12 of the task's fit times; parameters from
``PRNGKey(0)``; the task's x0 = (1, 1), further rows from U[0.5, 2.0],
and a trajectory cotangent, from a numpy seed.  Each stack runs two
parameter sets through one jitted JAX program (records and gradients):
the init, and a "scaled" set with every layer's ferro coef and base
weight doubled, whose solve rejects at least one attempt.

Tolerances:
* the plain field on the kernels' operands against ``kan_apply`` at the
  fresh state: 1e-12 of the output's scale in float64 (the same
  function: the TPU kernel's cancelled form of the hysteresis target),
  1e-6 in float32 (its rounding);
* records: the first attempt's step size to 1e-5, and the accept flags
  through the attempt after JAX's first rejection.  At init the error
  estimates lie far below their tolerance (the first ~1e-5 of it, under
  float32 rounding): the attempt count and the time reached (1e-6) are
  held, but not the later step sizes, which two float32 implementations
  draw from rounding noise (they part by tens of percent).  On the
  scaled set the error estimates are of order one: the step sizes are
  held to 2% through the attempt after the first rejection.  Later, a
  decision can sit within float32 rounding of the threshold, and two
  right float32 solves then part: over twelve seeds of x0 the port took
  JAX's attempt count in 69 of 72 cases and missed by one or two in the
  rest;
* the replay of JAX's recorded mesh against JAX's trajectory: 1e-5;
* gradients of the port's plain replay on JAX's recorded mesh, through
  the module's parameters (the spline scaler's chain included), against
  ``jax.grad`` through the JAX kernel: relative norm < 1e-4 leaf by leaf
  and for x0, the knot grids zero on both sides (the JAX kernel reports
  zeros, the port keeps them as buffers).
The CUDA kernels are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fetode_tpu_torch.models.predprey as PP
from fetode_tpu.models.predprey import PredPreyNODE as JNODE
from fetode_tpu.models.predprey import PredPreyTask as JTask
from fetode_tpu.models.predprey import generate_data as jgenerate
from fetode_tpu.models.predprey import predprey_init as jinit
from fetode_tpu.ops.pallas_kanfet_wide import make_wide_train_solver
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import grads_to_numpy, params_from_numpy
from fetode_tpu_torch.models.predprey import PredPreyNODE, predprey_init
from fetode_tpu_torch.nn.kan import (
    KAN,
    kan_apply,
    kan_state_init,
    kanfet_config,
)
from fetode_tpu_torch.ops import kanfet_wide as KW
from fetode_tpu_torch.ops import node_common as NC

RTOL, ATOL, MAX_STEPS, T = 1e-4, 1e-6, 64, 12
STACKS = {"2-10-2": ((2, 10, 2), 1), "2-32-2": ((2, 32, 2), 1),
          "2-8-8-2": ((2, 8, 8, 2), 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager solves here are many small ops: one torch thread for this
    module (see tests/test_torch_mlp_node.py), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(tree):
    out = copy.deepcopy(tree)
    for layer in out:
        layer["ferro"]["coef"] = 2.0 * layer["ferro"]["coef"]
        layer["base_weight"] = 2.0 * layer["base_weight"]
    return out


@pytest.fixture(scope="module")
def ts():
    _, ts_learn, _ = jgenerate(JTask())
    return np.asarray(ts_learn[:T], np.float32)


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request, ts):
    layers, B = STACKS[request.param]
    spec = JNODE.kanfet(layers_hidden=layers, max_steps=MAX_STEPS)
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  list(jinit(jax.random.PRNGKey(0), spec)))
    rng = np.random.default_rng(len(layers) * 100 + B)
    x0 = np.concatenate([[[1.0, 1.0]], rng.uniform(0.5, 2.0, (B - 1, 2))]
                        ).astype(np.float32)
    ybar = rng.standard_normal((B, T, 2)).astype(np.float32)
    solver = make_wide_train_solver(spec.kan, rtol=RTOL, atol=ATOL,
                                    max_steps=MAX_STEPS, interpret=True)
    jts = jnp.asarray(ts)

    def loss(p, x):
        return jnp.sum(solver(p, x, jts) * ybar)

    @jax.jit
    def run(p, x):
        return (solver.fwd_with_records(p, x, jts),
                jax.grad(loss, argnums=(0, 1))(p, x))

    res = {}
    for name, tree in (("init", init), ("scaled", _scaled(init))):
        jt = tuple(jax.tree_util.tree_map(jnp.asarray, tree))
        (out, recs), (g_p, g_x) = run(jt, jnp.asarray(x0))
        res[name] = dict(tree=tree, out=np.asarray(out),
                         recs=[np.asarray(r) for r in recs],
                         g_p=jax.tree_util.tree_map(np.asarray, list(g_p)),
                         g_x0=np.asarray(g_x))
    return dict(name=request.param, layers=layers, B=B, x0=x0, ybar=ybar,
                spec=PredPreyNODE.kanfet(layers_hidden=layers,
                                         max_steps=MAX_STEPS), **res)


def _module(s, regime):
    kan = KAN(s["spec"].kan)
    kan.load_state_dict(params_from_numpy(s[regime]["tree"]))
    return kan


def _records(jrecs):
    tda, yrec, krec, misc = jrecs
    return NC.SolveRecords(*(torch.from_numpy(np.array(r, np.float32))
                             for r in (tda, yrec, krec, misc[0])))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_field_is_kan_apply(stack):
    """The plain field on the kernels' operands is ``kan_apply`` at the
    fresh hysteresis state: the same function (float64, 1e-12), which
    float32 evaluates within its rounding (1e-6 of the output's scale:
    the cancelled target rounds otherwise than kan_apply's)."""
    kan = _module(stack, "scaled")
    y = torch.from_numpy(np.random.default_rng(3).uniform(
        -2.0, 2.0, (5, 2)).astype(np.float32))
    for m, x, tol in ((kan, y, 1e-6), (copy.deepcopy(kan).double(),
                                       y.double(), 1e-12)):
        with torch.no_grad():
            a = KW.wide_field(KW.wide_weights(m), m.cfg)(0.0, x)
            b = kan_apply(m, x, kan_state_init((5,), m.cfg,
                                               dtype=x.dtype))[0]
        assert a.dtype == x.dtype
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _first(mask) -> int:
    idx = np.flatnonzero(mask)
    return int(idx[0]) if idx.size else len(mask)


@pytest.mark.parametrize("regime", ["init", "scaled"])
def test_records_match_jax(stack, ts, regime):
    """The plain recording solve against the JAX kernel's records, held
    where float32 rounding does not decide (module docstring), and the
    replay of JAX's mesh against JAX's trajectory."""
    s = stack
    kan = _module(s, regime)
    w = KW.wide_weights(kan)
    x0, tts = torch.from_numpy(s["x0"]), torch.from_numpy(ts)
    want = _records(s[regime]["recs"])
    with torch.no_grad():
        _, recs = KW.kanfet_wide_fwd(w, kan.cfg, x0, tts, rtol=RTOL,
                                     atol=ATOL, max_steps=MAX_STEPS)
        replay = NC.replay_traj_reference(KW.wide_field(w, kan.cfg), x0, tts,
                                          want)
    n, nj = int(recs.misc[0]), int(want.misc[0])
    flags, jflags = recs.tda[:n, 1].numpy(), want.tda[:nj, 1].numpy()
    np.testing.assert_allclose(recs.tda[0, 0].item(), want.tda[0, 0].item(),
                               rtol=1e-5)
    rej = _first(jflags == 0.0)                  # JAX's first rejection
    upto = min(rej + 2, nj)
    assert n >= upto
    np.testing.assert_array_equal(flags[:upto], jflags[:upto])
    if regime == "init":
        assert n == nj
        np.testing.assert_allclose(recs.misc[1].item(), want.misc[1].item(),
                                   rtol=1e-6)
    else:
        assert rej < nj
        np.testing.assert_allclose(recs.tda[:upto, 0].numpy(),
                                   want.tda[:upto, 0].numpy(), rtol=2e-2)
    np.testing.assert_allclose(replay.transpose(0, 1).numpy(),
                               s[regime]["out"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("regime", ["init", "scaled"])
def test_replay_gradients_on_jax_mesh(stack, ts, regime):
    """float32: autograd of the plain replay of ``wide_field`` on JAX's
    recorded mesh, through ``wide_weights`` to the module's parameters,
    against ``jax.grad`` through the JAX kernel, leaf by leaf."""
    s = stack
    kan = _module(s, regime)
    x0 = torch.from_numpy(s["x0"]).requires_grad_(True)
    out = NC.replay_traj_reference(
        KW.wide_field(KW.wide_weights(kan), kan.cfg), x0,
        torch.from_numpy(ts), _records(s[regime]["recs"]))
    torch.sum(out.transpose(0, 1) * torch.from_numpy(s["ybar"])).backward()
    got = jax.tree_util.tree_leaves_with_path(grads_to_numpy(kan))
    want = jax.tree_util.tree_leaves_with_path(s[regime]["g_p"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, r) in zip(got, want):
        if any(getattr(p, "key", None) == "_buffers" for p in path):
            assert not g.any() and not r.any(), path
            continue
        assert _rel(g, r) < 1e-4, jax.tree_util.keystr(path)
    assert _rel(x0.grad.numpy(), s[regime]["g_x0"]) < 1e-4


def test_wrappers_on_cpu_are_the_plain_version(ts):
    """On the CPU the wrappers and the public solve take the plain version
    and launch nothing; autograd reaches every parameter through it, the
    spline scaler included."""
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 8, 8, 2),
                               max_steps=MAX_STEPS)
    kan = predprey_init(torch.Generator().manual_seed(1), spec)
    w = KW.wide_weights(kan)
    x0 = torch.tensor([[1.0, 1.0], [0.7, 1.4]])
    tts = torch.from_numpy(ts)
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (T, 2, 2)).astype(np.float32))
    opts = dict(rtol=RTOL, atol=ATOL, max_steps=MAX_STEPS)
    before = (KW.kanfet_wide_fwd.launches, KW.kanfet_wide_bwd.launches)
    out = KW.kanfet_wide_solve_train(kan, spec.kan, x0, tts, **opts)
    assert out.shape == (2, T, 2) and out.requires_grad
    ref = KW.kanfet_wide_solve_train_reference(kan, spec.kan, x0, tts, **opts)
    assert torch.equal(out, ref)
    with torch.no_grad():
        out_ng = KW.kanfet_wide_solve_train(kan, spec.kan, x0, tts, **opts)
        traj, recs = KW.kanfet_wide_fwd(w, spec.kan, x0, tts, **opts)
    assert torch.equal(out_ng, ref.detach())
    assert torch.equal(traj.transpose(0, 1), ref.detach())
    grads, x0bar = KW.kanfet_wide_bwd(w, spec.kan, x0, tts, recs, ct)
    gw = KW.grad_weights(w)
    assert len(grads) == 7 * 3
    assert [g.shape for g in grads] == [t.shape for t in gw]
    want, want_x = NC.replay_traj_vjp_reference(
        KW.wide_field(w, spec.kan), gw, x0, tts, recs, ct)
    for g, r in zip(grads + [x0bar], want + [want_x]):
        assert torch.equal(g, r)
    params = list(kan.parameters())
    got = torch.autograd.grad(torch.sum(out.transpose(0, 1) * ct), params)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in got)
    assert (KW.kanfet_wide_fwd.launches,
            KW.kanfet_wide_bwd.launches) == before


def test_refusals(ts):
    x0 = torch.ones((1, 2))
    tts = torch.from_numpy(ts)
    for cfg, match in (
            (kanfet_config([2, 8, 2], grid_size=7), "grid 5, order 3"),
            (kanfet_config([2, 8, 2], ferro_num_basis=0), "pure KANFET"),
            (kanfet_config([2, 8, 3]), "D -> D")):
        kan = KAN(cfg)
        with pytest.raises(ValueError, match=match):
            KW.kanfet_wide_solve_train(kan, cfg, x0, tts)
    cfg = kanfet_config([2, 8, 2])
    cfg = cfg._replace(layers=(cfg.layers[0]._replace(ferro_alpha=0.5),
                               cfg.layers[1]))
    with pytest.raises(ValueError, match="one ferro gate"):
        KW.check_stack(cfg)
    kan = KAN(kanfet_config([2, 8, 2]))
    w = KW.wide_weights(kan)
    with pytest.raises(ValueError, match="operand shapes"):
        KW.kanfet_wide_fwd(w[:1] + [w[1][..., :-1]] + w[2:], kan.cfg, x0, tts)
    with pytest.raises(ValueError, match="8 operands a layer"):
        KW.kanfet_wide_fwd(w[:-1], kan.cfg, x0, tts)
    with pytest.raises(ValueError, match="x0s must be"):
        KW.kanfet_wide_fwd(w, kan.cfg, x0[0], tts)


def test_predict_routing(monkeypatch):
    """``predict`` (one trajectory) on the kernel path: in·out·K 160 goes
    to the per-trajectory kernels, 512 and 32,768 to the wide stack's, as
    the JAX package's ``test_pallas_mode_dispatch`` routes them;
    ``predict_batch`` steps each trajectory under its own controller and
    takes the per-trajectory kernels at every width, [2, 64, 64, 2] too,
    as the JAX trajectory driver does.  The kernels are stubbed and the
    kernel path forced, so no card is needed."""
    calls = []

    def stub(name):
        def solve(params, cfg, x0s, ts, **kw):
            calls.append(name)
            return torch.zeros((x0s.shape[0], ts.shape[0], 2))
        return solve

    monkeypatch.setattr(PP, "_use_kernel", lambda params, spec, x: True)
    monkeypatch.setattr(PP, "kanfet_solve", stub("B.1"))
    monkeypatch.setattr(PP, "kanfet_solve_train", stub("B.2"))
    monkeypatch.setattr(PP, "kanfet_wide_solve_train", stub("B.3"))
    ts = torch.linspace(0.0, 1.0, 4)
    x0 = torch.ones(2)
    for layers in ((2, 10, 2), (2, 32, 2), (2, 64, 64, 2)):
        spec = PredPreyNODE.kanfet(layers_hidden=layers, solver_mode="pallas")
        params = predprey_init(torch.Generator().manual_seed(0), spec)
        assert PP.predict(params, spec, x0, ts).shape == (4, 2)
        with torch.no_grad():
            PP.predict(params, spec, x0, ts)
    assert PP.max_ferro_n(spec) == 32_768
    assert calls == ["B.2", "B.1", "B.3", "B.3", "B.3", "B.3"]
    assert PP.predict_batch(params, spec, x0[None], ts).shape == (1, 4, 2)
    with torch.no_grad():
        PP.predict_batch(params, spec, x0[None], ts)
    assert calls[6:] == ["B.2", "B.1"]


def test_multilayer_stack_trains():
    """A [2, 8, 8, 2] stack through the wide solve on the CPU: six Adam
    steps keep the gradients finite and lower the loss (the JAX package's
    ``test_multilayer_stack_trains``)."""
    from fetode_tpu_torch.models.predprey import PredPreyTask, generate_data
    from fetode_tpu_torch.train.optim import make_optimizer

    _, ts_learn, truth = generate_data(PredPreyTask())
    tts, target = ts_learn[:8], truth[:8]
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 8, 8, 2), max_steps=32)
    kan = predprey_init(torch.Generator().manual_seed(1), spec)
    x0 = torch.tensor([[1.0, 1.0]])
    opt = make_optimizer(2e-3, params=kan.parameters(), kind="adam")
    losses = []
    for _ in range(6):
        opt.zero_grad()
        pred = KW.kanfet_wide_solve_train(kan, spec.kan, x0, tts, rtol=1e-3,
                                          atol=1e-5, max_steps=32)[0]
        loss = torch.mean((pred - target) ** 2)
        loss.backward()
        assert all(torch.isfinite(p.grad).all() for p in kan.parameters())
        losses.append(float(loss))
        opt.step()
    assert losses[-1] < losses[0]


def test_cli_predprey_wide_stack_on_cpu(tmp_path):
    """``cli predprey --layers 2,8,8,2`` trains two epochs on the CPU (the
    eager solves) with finite losses."""
    res = cli.main(["predprey", "--device", "cpu", "--layers", "2,8,8,2",
                    "--epochs", "2", "--epochs_per_call", "1", "--out-dir",
                    str(tmp_path)])
    assert np.isfinite(res["final_train"])
    rows = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 2


@pytest.mark.cuda
def test_kernels_match_plain_on_card(ts):
    """The kernels against the plain version at rtol 1e-3, where float32
    rounding decides no accept decision (``chip_smoke.py`` phase 32): the
    same attempts, the forward against plain's replay of the kernel's
    mesh, the backward against the float64 plain replay of its records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 8, 8, 2),
                               max_steps=MAX_STEPS)
    kan = predprey_init(torch.Generator().manual_seed(1), spec, device=dev)
    w = KW.wide_weights(kan)
    field = KW.wide_field(w, spec.kan)
    x0 = torch.tensor([[1.0, 1.0], [0.7, 1.4]], device=dev)
    tts = torch.from_numpy(ts).to(dev)
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (T, 2, 2)).astype(np.float32)).to(dev)
    opts = dict(rtol=1e-3, atol=1e-5, max_steps=MAX_STEPS)
    with torch.no_grad():
        out, recs = KW.kanfet_wide_fwd(w, spec.kan, x0, tts, **opts)
        _, rrec = NC.record_solve_traj_reference(field, x0, tts, **opts)
        ref = NC.replay_traj_reference(field, x0, tts, recs)
    torch.cuda.synchronize()
    assert int(recs.misc[0]) == int(rrec.misc[0])
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)
    grads, x0bar = KW.kanfet_wide_bwd(w, spec.kan, x0, tts, recs, ct)
    w64 = [t.double() for t in w]
    want, want_x = NC.replay_traj_vjp_reference(
        KW.wide_field(w64, spec.kan), KW.grad_weights(w64), x0.double(), tts,
        NC.SolveRecords(*(r.double() for r in recs)), ct.double())
    flat = [torch.cat([g.reshape(-1).double() for g in gs]).cpu().numpy()
            for gs in (grads, want)]
    assert _rel(*flat) < 1e-4
    assert _rel(x0bar.double().cpu().numpy(), want_x.cpu().numpy()) < 1e-4
