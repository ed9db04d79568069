"""PyTorch port, the recurrent models against the JAX package: every
function of ``nn/rnn.py`` (the logistic KAN cell in both mixes, its head
and RNN, the ferro KAN cell in both mixes with a state that has a
history, the FEPA-RNN, the KAN-RNN encoder, the digital RNN one- and
two-way) and ``models/ecg.py``'s ``node_rnn_apply`` (rk4, 8 steps) and
``ode_rnn_encode``, in float64: outputs, new states and the VJP of a
random cotangent (every parameter and the inputs), within 1e-9 (one
algorithm, the same operations; relative norm for gradients).  The
ferro layers take ``ops/ferro_fused.py: ferro_apply_fused``, whose CPU
form is the plain op.  The truncate-mode cell forms ``tanh(x_feat)``,
which is what the JAX cell's sliced concat computes: the same values and
gradients here.

Noisy paths draw from different generators in the two packages, so they
get shape, determinism-per-generator and noise-scale checks only.  Also:
one AdamW epoch of the FEPA-RNN against the JAX package's keyed
``make_minibatch_epoch`` (two steps, weight decay, global-norm clip 1.0;
losses and parameters 1e-9), the launch count of the ferro layer ops per
forward, and the state dtype.

Small widths: hidden 6, 3 bases, T = 10, B = 4; parameters from
``PRNGKey(0)``, inputs from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import ecg as JM
from fetode_tpu.nn import rnn as JR
from fetode_tpu.ops import ferro as jferro
from fetode_tpu.train import ecg_driver as jdrv
from fetode_tpu.train.loop import init_state as j_init_state
from fetode_tpu.train.loop import make_minibatch_epoch as j_minibatch_epoch
from fetode_tpu.train.optim import make_optimizer as j_make_optimizer
from fetode_tpu_torch.convert import (
    ecg_grads_to_numpy,
    ecg_params_from_numpy,
    ecg_params_to_numpy,
)
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.nn import rnn as TR
from fetode_tpu_torch.ops import ferro as tferro
from fetode_tpu_torch.ops import ferro_fused as FF
from fetode_tpu_torch.train import ecg_driver as tdrv
from fetode_tpu_torch.train.loop import init_state, make_minibatch_epoch
from fetode_tpu_torch.train.optim import make_optimizer

H, K, T, B, F = 6, 3, 10, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread under the suite's workers
    (see tests/test_torch_ecg.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _module(tinit, tcfg, jtree):
    mod = tinit(torch.Generator().manual_seed(0), tcfg, dtype=torch.float64)
    mod.load_state_dict(ecg_params_from_numpy(jtree, dtype=np.float64))
    return mod


def _state_pair(cfg_t, x_prev):
    """A port ferro state (float64) after one plain call on random
    parameters, and the same numbers as a JAX state."""
    p = tferro.ferro_init(torch.Generator().manual_seed(11), cfg_t,
                          dtype=torch.float64)
    _, ts = tferro.ferro_apply(p, tferro.ferro_state_init(
        x_prev.shape[:1], cfg_t, dtype=torch.float64),
        torch.from_numpy(x_prev), cfg_t)
    ts = tferro.FerroState(ts.prev_x.detach(), ts.branch.detach())
    return jferro.FerroState(*(jnp.asarray(t.numpy()) for t in ts)), ts


def _cell_states(jcfg, tcfg):
    rng = np.random.default_rng(9)
    ji, ti = _state_pair(tcfg.input_cfg,
                         rng.standard_normal((B, jcfg.input_size)))
    jh, th = _state_pair(tcfg.hidden_cfg,
                         rng.standard_normal((B, jcfg.hidden_size)))
    return JR.FerroCellState(ji, jh), TR.FerroCellState(ti, th)


def _case(name):
    """(JAX param tree, JAX fn(params, *xs), port module, port fn(module,
    *xs), inputs, JAX and port extra outputs) of one function."""
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(0)
    seq = rng.standard_normal((B, T, F))
    if name.startswith("logistic_cell"):
        mix = name.split("_")[-1]
        jc = JR.LogisticKANCellConfig(F, H, K, mix)
        tc = TR.LogisticKANCellConfig(F, H, K, mix)
        jp = JR.logistic_kan_cell_init(key, jc, jnp.float64)
        return (jp, lambda p, x, h: JR.logistic_kan_cell_apply(p, jc, x, h),
                _module(TR.logistic_kan_cell_init, tc, jp),
                lambda m, x, h: TR.logistic_kan_cell_apply(m, tc, x, h),
                [rng.standard_normal((B, F)), rng.standard_normal((B, H))])
    if name == "kan_head":
        jc, tc = JR.KANHeadConfig(H, 2, K), TR.KANHeadConfig(H, 2, K)
        jp = JR.kan_head_init(key, jc, jnp.float64)
        return (jp, lambda p, x: JR.kan_head_apply(p, jc, x),
                _module(TR.kan_head_init, tc, jp),
                lambda m, x: TR.kan_head_apply(m, tc, x),
                [rng.standard_normal((B, H))])
    if name == "logistic_rnn":
        jc = JR.LogisticKANRNNConfig(F, H, 2, K)
        tc = TR.LogisticKANRNNConfig(F, H, 2, K)
        jp = JR.logistic_kan_rnn_init(key, jc, jnp.float64)
        return (jp, lambda p, x: JR.logistic_kan_rnn_apply(p, jc, x),
                _module(TR.logistic_kan_rnn_init, tc, jp),
                lambda m, x: TR.logistic_kan_rnn_apply(m, tc, x), [seq])
    if name.startswith("ferro_cell"):
        mix = name.split("_")[-1]
        jc = JR.FerroKANCellConfig(F, H, K, mix=mix)
        tc = TR.FerroKANCellConfig(F, H, K, mix=mix)
        jp = JR.ferro_kan_cell_init(key, jc, jnp.float64)
        js, ts = _cell_states(jc, tc)
        return (jp, lambda p, x, h: JR.ferro_kan_cell_apply(p, jc, x, h, js),
                _module(TR.ferro_kan_cell_init, tc, jp),
                lambda m, x, h: TR.ferro_kan_cell_apply(m, tc, x, h, ts),
                [rng.standard_normal((B, F)), rng.standard_normal((B, H))])
    if name == "fepa_rnn":
        jc = JR.FerroKANRNNConfig(F, H, 2, K)
        tc = TR.FerroKANRNNConfig(F, H, 2, K)
        jp = JR.ferro_kan_rnn_init(key, jc, jnp.float64)
        return (jp, lambda p, x: JR.ferro_kan_rnn_apply(p, jc, x),
                _module(TR.ferro_kan_rnn_init, tc, jp),
                lambda m, x: TR.ferro_kan_rnn_apply(m, tc, x), [seq])
    if name == "kanrnn_encoder":
        jc = JR.KANRNNEncoderConfig(F, H, 5, K)
        tc = TR.KANRNNEncoderConfig(F, H, 5, K)
        jp = JR.kan_rnn_encoder_init(key, jc, jnp.float64)
        return (jp, lambda p, x: JR.kan_rnn_encoder_apply(p, jc, x),
                _module(TR.kan_rnn_encoder_init, tc, jp),
                lambda m, x: TR.kan_rnn_encoder_apply(m, tc, x), [seq])
    if name.startswith("digital_rnn"):
        bi = name.endswith("bi")
        jc = JR.DigitalRNNConfig(F, H, 2, bi)
        tc = TR.DigitalRNNConfig(F, H, 2, bi)
        jp = JR.digital_rnn_init(key, jc, jnp.float64)
        return (jp, lambda p, x: JR.digital_rnn_apply(p, jc, x),
                _module(TR.digital_rnn_init, tc, jp),
                lambda m, x: TR.digital_rnn_apply(m, tc, x), [seq])
    if name == "node_rnn":
        kw = dict(input_size=F, hidden_size=H, num_basis=K, n_steps=8)
        js, ts = JM.NodeRNNSpec(**kw), TM.NodeRNNSpec(**kw)
        jp = JM.node_rnn_init(key, js, jnp.float64)
        return (jp, lambda p, x: JM.node_rnn_apply(p, js, x),
                _module(TM.node_rnn_init, ts, jp),
                lambda m, x: TM.node_rnn_apply(m, ts, x), [seq])
    assert name == "ode_rnn_encoder"
    kw = dict(input_size=F, hidden_size=H, num_basis=K, n_steps=8)
    js, ts = JM.OdeRnnEncoderSpec(**kw), TM.OdeRnnEncoderSpec(**kw)
    jp = JM.ode_rnn_encoder_init(key, js, jnp.float64)
    return (jp, lambda p, x: jax.vmap(
        lambda xb: JM.ode_rnn_encode(p, js, xb))(x),
        _module(TM.ode_rnn_encoder_init, ts, jp),
        lambda m, x: TM.ode_rnn_encode(m, ts, x), [seq])


NAMES = ["logistic_cell_truncate", "logistic_cell_sum", "kan_head",
         "logistic_rnn", "ferro_cell_truncate", "ferro_cell_sum", "fepa_rnn",
         "kanrnn_encoder", "digital_rnn_bi", "digital_rnn_one",
         "node_rnn", "ode_rnn_encoder"]


@pytest.mark.parametrize("name", NAMES)
def test_matches_jax_float64(name):
    jtree, jfn, mod, tfn, xs = _case(name)
    jtree = jax.tree_util.tree_map(jnp.asarray, jtree)
    cell = name.startswith("ferro_cell")

    def jmain(p, *a):
        out = jfn(p, *a)
        return out[0] if cell else out

    xs_j = [jnp.asarray(a) for a in xs]

    @jax.jit
    def run(p, xs_j, ct):
        out, vjp = jax.vjp(jmain, p, *xs_j)
        return out, vjp(ct)

    ct = np.random.default_rng(7).standard_normal(
        jax.eval_shape(jmain, jtree, *xs_j).shape)
    out_j, g_j = run(jtree, xs_j, jnp.asarray(ct))
    xs_t = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    out = tfn(mod, *xs_t)
    out_t = out[0] if cell else out
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=1e-9,
                               atol=1e-12)
    torch.sum(out_t * torch.from_numpy(ct)).backward()
    got = ecg_grads_to_numpy(mod, np.float64)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(g_j[0])
    want = _flat(g_j[0])
    if np.linalg.norm(want) > 0:
        assert _rel(_flat(got), want) < 1e-9
    for x, g in zip(xs_t, g_j[1:]):
        if np.linalg.norm(g) > 0:
            assert _rel(x.grad.numpy(), np.asarray(g)) < 1e-9
        else:
            assert x.grad is None or not x.grad.any()
    if cell:       # the advanced states
        js_new, ts_new = jax.jit(jfn)(jtree, *xs_j)[1], out[1]
        for a, b in zip(jax.tree_util.tree_leaves(js_new),
                        [ts_new.input_state.prev_x, ts_new.input_state.branch,
                         ts_new.hidden_state.prev_x,
                         ts_new.hidden_state.branch]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-12)


def test_truncate_cell_is_tanh_of_the_input_op():
    """The identity the port's truncate cell uses, on the JAX cell itself:
    its output equals tanh of the input op alone."""
    jc = JR.FerroKANCellConfig(F, H, K)
    jp = JR.ferro_kan_cell_init(jax.random.PRNGKey(1), jc, jnp.float64)
    js, _ = _cell_states(jc, TR.FerroKANCellConfig(F, H, K))
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((B, F)))

    @jax.jit
    def both(p, x, h):
        h1, _ = JR.ferro_kan_cell_apply(p, jc, x, h, js)
        x_feat, _ = jferro.ferro_apply(jferro.FerroParams(**p["input_basis"]),
                                       js.input_state, x, jc.input_cfg)
        return h1, jnp.tanh(x_feat)

    h1, want = both(jp, x, jnp.asarray(rng.standard_normal((B, H))))
    np.testing.assert_allclose(np.asarray(h1), np.asarray(want), rtol=1e-15,
                               atol=1e-15)


def test_ferro_layer_launches_per_forward(monkeypatch):
    """FEPA-RNN: 2 T + 1 ferro layer ops a forward; node_rnn with rk4: 4
    n_steps + 2.  Counted on the CPU through the op the kernel wrapper
    would launch."""
    calls = []
    real = TR.ferro_apply_fused
    monkeypatch.setattr(TR, "ferro_apply_fused",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.zeros((2, T))
    rc = TR.FerroKANRNNConfig(hidden_size=H, num_basis=K)
    TR.ferro_kan_rnn_apply(TR.ferro_kan_rnn_init(torch.Generator(), rc), rc,
                           x)
    assert len(calls) == 2 * T + 1
    calls.clear()
    spec = TM.NodeRNNSpec(hidden_size=H, num_basis=K, n_steps=5)
    TM.node_rnn_apply(TM.node_rnn_init(torch.Generator(), spec), spec, x)
    assert len(calls) == 4 * 5 + 2


def test_state_dtype():
    cfg = TR.FerroKANRNNConfig(hidden_size=H, num_basis=K,
                               state_dtype="bfloat16")
    st = TR.ferro_kan_cell_state((2,), cfg.cell)
    assert st.input_state.branch.dtype == torch.bfloat16
    assert st.hidden_state.prev_x.dtype == torch.bfloat16
    p = TR.ferro_kan_rnn_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, T)).astype(np.float32))
    out_bf = TR.ferro_kan_rnn_apply(p, cfg, x)
    out32 = TR.ferro_kan_rnn_apply(p, cfg._replace(state_dtype=""), x)
    assert out_bf.dtype == torch.float32
    np.testing.assert_allclose(out_bf.detach().numpy(),
                               out32.detach().numpy(), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("model", ["fepa_rnn", "node_rnn"])
def test_noisy_paths_shape_and_determinism(model):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, T)).astype(np.float32))
    if model == "fepa_rnn":
        cfg = TR.FerroKANRNNConfig(hidden_size=H, num_basis=K, noise_std=0.3)
        p = TR.ferro_kan_rnn_init(torch.Generator().manual_seed(0), cfg)

        def run(g):
            return TR.ferro_kan_rnn_apply(p, cfg, x, generator=g)
    else:
        spec = TM.NodeRNNSpec(hidden_size=H, num_basis=K, n_steps=4,
                              noise_std=0.3)
        p = TM.node_rnn_init(torch.Generator().manual_seed(0), spec)

        def run(g):
            return TM.node_rnn_apply(p, spec, x, generator=g)
    a = run(torch.Generator().manual_seed(1))
    b = run(torch.Generator().manual_seed(1))
    c = run(torch.Generator().manual_seed(2))
    assert a.shape == (B, 2) and torch.isfinite(a).all()
    np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="generator"):
        run(None)


def test_noisy_ferro_layer_scale():
    """The noisy layer adds sum_{i,k} coef * N(0, std^2) per output: over
    4,000 rows the std of (noisy - clean) is std * ||coef[:, o, :]|| within
    5%."""
    cfg = tferro.FerroConfig(3, 2, 4, noise_std=0.2)
    p = tferro.ferro_init(torch.Generator().manual_seed(0), cfg,
                          dtype=torch.float64)
    s = tferro.ferro_state_init((4000,), cfg, dtype=torch.float64)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4000, 3)))
    with torch.no_grad():
        noisy, _ = TR.ferro_layer(p, s, x, cfg,
                                  torch.Generator().manual_seed(5))
        clean, _ = TR.ferro_layer(p, s, x, cfg._replace(noise_std=0.0))
    want = 0.2 * p.coef.detach().pow(2).sum((0, 2)).sqrt()
    np.testing.assert_allclose((noisy - clean).std(0).numpy(), want.numpy(),
                               rtol=0.05)


def test_fepa_rnn_epoch_matches_jax():
    """Two AdamW steps of the FEPA-RNN (weight decay 1e-4, clip 1.0) on the
    same minibatches, float64: losses and parameters 1e-9."""
    jc = JR.FerroKANRNNConfig(1, H, 2, K)
    tc = TR.FerroKANRNNConfig(1, H, 2, K)
    jp = JR.ferro_kan_rnn_init(jax.random.PRNGKey(0), jc, jnp.float64)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, B, T))
    y = rng.integers(0, 2, (2, B)).astype(np.int32)
    tx = j_make_optimizer(1e-3, kind="adamw", weight_decay=1e-4,
                          grad_clip=1.0, params=jp)

    def jloss(p, key, xb, yb):
        return jdrv.cross_entropy(JR.ferro_kan_rnn_apply(p, jc, xb), yb)

    state, losses_j = j_minibatch_epoch(jloss, tx, keyed=True)(
        j_init_state(jp, tx), jax.random.PRNGKey(1), (x, y))
    mod = _module(TR.ferro_kan_rnn_init, tc, jp)

    def tloss(p, generator, xb, yb):
        return tdrv.cross_entropy(TR.ferro_kan_rnn_apply(p, tc, xb), yb)

    opt = make_optimizer(1e-3, params=mod.parameters(), kind="adamw",
                         weight_decay=1e-4, grad_clip=1.0)
    tstate, losses_t = make_minibatch_epoch(tloss, keyed=True)(
        init_state(mod, opt), (0, 0),
        (torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_allclose(losses_t.detach().numpy(),
                               np.asarray(losses_j), rtol=1e-9)
    got = _flat(ecg_params_to_numpy(tstate.params, np.float64))
    assert _rel(got, _flat(state.params)) < 1e-9
    assert np.abs(got - _flat(jp)).max() > 1e-4      # the update moved


def test_fused_op_counts_nothing_on_the_cpu():
    """On the CPU the wrapper is the plain op: no kernel launch counted."""
    n = FF.ferro_apply_fused.launches
    rc = TR.FerroKANRNNConfig(hidden_size=H, num_basis=K)
    TR.ferro_kan_rnn_apply(TR.ferro_kan_rnn_init(torch.Generator(), rc), rc,
                           torch.zeros((2, T)))
    assert FF.ferro_apply_fused.launches == n
