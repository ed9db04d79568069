"""PyTorch port, the whole-chain DDPM sampler of the eps-head forecaster
(``ops/ddpm.py``) and the eager chains of ``nn/diffusion.py``, against the
JAX package's ``ops/pallas_ddpm.py: pallas_eps_head_sample`` (interpret
mode) and ``nn/diffusion.py: eps_head_sample_loop``.

Small width: pred_len P = 6, latent 8 (cond_dim 48), hidden H = 16, the
t-embedding's 128, T = 20 steps, B = 5 rows; parameters from
``PRNGKey(0)``, the conditioning from a numpy seed.  The JAX samplers
draw from a key; the test reproduces those draws with ``jax.random``
exactly as ``pallas_eps_head_sample`` lays them out (per sample: split
into init and loop keys, y0 from the first, one key per step from the
second) and feeds them to the port.  Tolerance 1e-5: the same float32
arithmetic over 20 steps, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.nn.diffusion import EpsHeadConfig as JEps
from fetode_tpu.nn.diffusion import eps_head_init as j_eps_init
from fetode_tpu.nn.diffusion import eps_head_sample_loop as j_sample_loop
from fetode_tpu.nn.diffusion import make_schedule as j_schedule
from fetode_tpu.ops.pallas_ddpm import pallas_eps_head_sample
from fetode_tpu_torch.convert import forecast_params_from_numpy
from fetode_tpu_torch.nn import diffusion as TD
from fetode_tpu_torch.ops import ddpm as DD

P, C, H, T, B = 6, 48, 16, 20, 5


def _jax_draws(key, S):
    """y0 (S, B, P) and noise (S, T, B, P) as ``pallas_eps_head_sample``
    draws them."""
    def draw(k):
        k_init, k_loop = jax.random.split(k)
        y0 = jax.random.normal(k_init, (B, P), jnp.float32)
        keys = jax.random.split(k_loop, T)
        noise = jax.vmap(lambda kk: jax.random.normal(kk, (B, P),
                                                      jnp.float32))(keys)
        return y0, noise

    if S == 1:
        y0, noise = draw(key)
        return np.array(y0)[None], np.array(noise)[None]
    y0, noise = jax.vmap(draw)(jax.random.split(key, S))
    return np.array(y0), np.array(noise)


@pytest.fixture(scope="module")
def setup():
    cfg = JEps(pred_len=P, cond_dim=C, hidden=H)
    params = j_eps_init(jax.random.PRNGKey(0), cfg)
    cond = np.random.default_rng(1).standard_normal((B, C)).astype(
        np.float32)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)
    tcfg = TD.EpsHeadConfig(pred_len=P, cond_dim=C, hidden=H)
    head = TD.eps_head_init(torch.Generator().manual_seed(0), tcfg)
    head.load_state_dict(forecast_params_from_numpy(tree))
    return dict(cfg=cfg, params=params, cond=cond, sched=j_schedule(T),
                tcfg=tcfg, head=head, tsched=TD.make_schedule(T))


def test_schedule_and_embedding_match_jax(setup):
    s = setup
    for got, want in zip(s["tsched"], s["sched"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    t = np.arange(7)
    from fetode_tpu.nn.diffusion import sinusoidal_emb as j_emb
    for dim in (16, 9):
        np.testing.assert_allclose(
            TD.sinusoidal_emb(torch.from_numpy(t), dim).numpy(),
            np.asarray(j_emb(jnp.asarray(t), dim)), rtol=1e-5, atol=1e-6)


def test_chain_matches_jax_kernel_and_scan(setup):
    s = setup
    key = jax.random.PRNGKey(8)
    y0, noise = _jax_draws(key, 1)
    cond = jnp.asarray(s["cond"])
    kern = pallas_eps_head_sample(s["params"], s["cfg"], s["sched"], cond,
                                  key, interpret=True)
    scan = j_sample_loop(s["params"], s["cfg"], s["sched"], cond, key)
    got = DD.eps_head_sample(s["head"], s["tcfg"], s["tsched"],
                             torch.from_numpy(s["cond"]),
                             y0=torch.from_numpy(y0),
                             noise=torch.from_numpy(noise))
    assert got.shape == (B, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(scan), rtol=1e-5,
                               atol=1e-5)
    loop = TD.eps_head_sample_loop(s["head"], s["tcfg"], s["tsched"],
                                   torch.from_numpy(s["cond"]),
                                   y0=torch.from_numpy(y0[0]),
                                   noise=torch.from_numpy(noise[0]))
    np.testing.assert_allclose(loop.detach().numpy(), np.asarray(scan),
                               rtol=1e-5, atol=1e-5)


def test_multisample_fold_order(setup):
    """S = 3 samples folded into rows s*B + b: the same samples as the JAX
    kernel's fold, and each equal to its own single-sample chain."""
    s = setup
    key = jax.random.PRNGKey(11)
    y0, noise = _jax_draws(key, 3)
    kern = pallas_eps_head_sample(s["params"], s["cfg"], s["sched"],
                                  jnp.asarray(s["cond"]), key, n_samples=3,
                                  interpret=True)
    cond = torch.from_numpy(s["cond"])
    got = DD.eps_head_sample(s["head"], s["tcfg"], s["tsched"], cond,
                             n_samples=3, y0=torch.from_numpy(y0),
                             noise=torch.from_numpy(noise))
    assert got.shape == (3, B, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-5,
                               atol=1e-5)
    for i in range(3):
        one = DD.eps_head_sample(s["head"], s["tcfg"], s["tsched"], cond,
                                 y0=torch.from_numpy(y0[i:i + 1]),
                                 noise=torch.from_numpy(noise[i:i + 1]))
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_generic_loop_matches_hoisted(setup):
    """``p_sample_loop`` with ``eps_head_apply`` is the hoisted chain on
    the same draws, and ``q_sample`` is its closed form."""
    s = setup
    cond = torch.from_numpy(s["cond"])
    rng = np.random.default_rng(3)
    y0 = torch.from_numpy(rng.standard_normal((B, P)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((T, B, P)).astype(
        np.float32))
    with torch.no_grad():
        ref = TD.p_sample_loop(
            s["tsched"], lambda y, t, c: TD.eps_head_apply(s["head"],
                                                           s["tcfg"], y, t,
                                                           c),
            (B, P), cond, y0=y0, noise=noise)
        fast = TD.eps_head_sample_loop(s["head"], s["tcfg"], s["tsched"],
                                       cond, y0=y0, noise=noise)
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    t_idx = torch.tensor([0, 5, 10, 19])
    y_t, eps = TD.q_sample(s["tsched"], y0[:4], t_idx,
                           torch.Generator().manual_seed(0))
    want = (s["tsched"].sqrt_alphas_bar[t_idx][:, None] * y0[:4]
            + s["tsched"].sqrt_one_minus_alphas_bar[t_idx][:, None] * eps)
    np.testing.assert_allclose(y_t.numpy(), want.numpy(), atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version(setup):
    s = setup
    before = DD.ddpm_chain.launches
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    cond = torch.from_numpy(s["cond"])
    a = DD.eps_head_sample(s["head"], s["tcfg"], s["tsched"], cond, g1,
                           n_samples=2)
    b = DD.eps_head_sample(s["head"], s["tcfg"], s["tsched"], cond, g2,
                           n_samples=2)
    assert a.shape == (2, B, P) and torch.isfinite(a).all()
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float((a[0] - a[1]).abs().max()) > 1e-6
    assert DD.ddpm_chain.launches == before
    with pytest.raises(ValueError, match="noise must be"):
        DD.ddpm_chain(torch.zeros(4, P), torch.zeros(4, H), torch.zeros(T, H),
                      torch.zeros(T, 3, P), torch.zeros(T, 3),
                      *(torch.zeros(x) for x in ((H, P), (H, H), (H,),
                                                 (P, H), (P,))))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    s = setup
    head = s["head"].to(dev)
    sched = TD.make_schedule(T, device=dev)
    cond = torch.from_numpy(s["cond"]).to(dev)
    y0, noise = (torch.from_numpy(a).to(dev)
                 for a in _jax_draws(jax.random.PRNGKey(8), 3))
    got = DD.eps_head_sample(head, s["tcfg"], sched, cond, n_samples=3,
                             y0=y0, noise=noise)
    cond_h, temb_h, w1y = TD.eps_head_tables(head, s["tcfg"], sched, cond)
    with torch.no_grad():
        want = DD.ddpm_chain_reference(
            y0.reshape(3 * B, P), cond_h.repeat(3, 1), temb_h,
            noise.transpose(0, 1).reshape(T, 3 * B, P),
            TD.chain_coefficients(sched), w1y, head[1].w, head[1].b,
            head[2].w, head[2].b)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.reshape(3 * B, P).cpu().numpy(),
                               want.cpu().numpy(), rtol=1e-5, atol=1e-5)
