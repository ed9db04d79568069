"""PyTorch port, the fixed-step solvers (``solvers/fixed.py``) against the
JAX package's ``fetode_tpu/solvers/fixed.py``: every tableau of
``FIXED_TABLEAUX`` through ``odeint_fixed`` (with substeps) and
``integrate_final``, and ``rollout_discrete`` plain and residual, on a
non-autonomous nonlinear field with a parameter, values and gradients, in
float64 within 1e-12 (one algorithm, the same operations in the same
order; rounding of a few ulps).  Also the models' fixed-step options that
the port now takes (the ECG NODEs, the latent forecaster, the conditional
node encoder) against their JAX twins, float64, 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import cond_diffusion as JCD
from fetode_tpu.models import ecg as JM
from fetode_tpu.models import forecasting as JF
from fetode_tpu.solvers import fixed as jfixed
from fetode_tpu.solvers.tableaux import FIXED_TABLEAUX as J_TABLEAUX
from fetode_tpu_torch.convert import (
    cond_diffusion_params_from_numpy,
    ecg_params_from_numpy,
    forecast_params_from_numpy,
)
from fetode_tpu_torch.models import cond_diffusion as TCD
from fetode_tpu_torch.models import ecg as TM
from fetode_tpu_torch.models import forecasting as TF
from fetode_tpu_torch.solvers import fixed as tfixed
from fetode_tpu_torch.solvers.tableaux import FIXED_TABLEAUX

METHODS = sorted(FIXED_TABLEAUX)
RNG = np.random.default_rng(0)
Y0 = RNG.standard_normal((3, 2))
W = RNG.standard_normal((2, 2))
TS = np.array([0.0, 0.3, 0.5, 1.1])


def _jfield(t, y, w):
    return jnp.tanh(y @ w) * jnp.cos(t) - 0.5 * y


def _tfield(t, y, w):
    return torch.tanh(y @ w) * torch.cos(t) - 0.5 * y


def test_tableaux_match_jax():
    assert sorted(J_TABLEAUX) == METHODS
    for m in METHODS:
        assert tuple(J_TABLEAUX[m]) == tuple(FIXED_TABLEAUX[m]), m


@pytest.mark.parametrize("method", METHODS)
def test_odeint_and_integrate_final_match_jax(method):
    """Trajectory (2 substeps an interval) and final state, each with the
    gradient of a random cotangent with respect to y0 and the parameter."""
    ct_traj = RNG.standard_normal((len(TS), 3, 2))
    ct_fin = RNG.standard_normal((3, 2))

    def jrun(y0, w):
        traj = jfixed.odeint_fixed(_jfield, y0, jnp.asarray(TS), w,
                                   method=method, n_substeps=2)
        fin = jfixed.integrate_final(_jfield, y0, 0.2, 1.3, w, method=method,
                                     n_steps=5)
        return traj, fin

    (traj_j, fin_j), vjp = jax.vjp(jrun, jnp.asarray(Y0), jnp.asarray(W))
    g_j = vjp((jnp.asarray(ct_traj), jnp.asarray(ct_fin)))
    y0 = torch.from_numpy(Y0).requires_grad_(True)
    w = torch.from_numpy(W).requires_grad_(True)
    traj_t = tfixed.odeint_fixed(_tfield, y0, torch.from_numpy(TS), w,
                                 method=method, n_substeps=2)
    fin_t = tfixed.integrate_final(_tfield, y0, 0.2, 1.3, w, method=method,
                                   n_steps=5)
    np.testing.assert_allclose(traj_t.detach().numpy(), traj_j, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(fin_t.detach().numpy(), fin_j, rtol=1e-12,
                               atol=1e-12)
    g_t = torch.autograd.grad(
        (traj_t * torch.from_numpy(ct_traj)).sum()
        + (fin_t * torch.from_numpy(ct_fin)).sum(), [y0, w])
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("residual_dt", [None, 0.1])
def test_rollout_discrete_matches_jax(residual_dt):
    def jstep(x, w):
        return jnp.tanh(x @ w)

    def tstep(x, w):
        return torch.tanh(x @ w)

    want = jfixed.rollout_discrete(jstep, jnp.asarray(Y0), 6, jnp.asarray(W),
                                   residual_dt=residual_dt)
    got = tfixed.rollout_discrete(tstep, torch.from_numpy(Y0), 6,
                                  torch.from_numpy(W),
                                  residual_dt=residual_dt)
    assert got.shape == (7, 3, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_unknown_method_names_the_choices():
    with pytest.raises(ValueError, match="rk4"):
        tfixed.integrate_final(_tfield, torch.from_numpy(Y0), 0.0, 1.0,
                               torch.from_numpy(W), method="rk9")


def _tree(p):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), p)


@pytest.mark.parametrize("name", ["kanfet_node", "kanfet_mlp_node",
                                  "forecaster", "node_encoder"])
def test_model_fixed_step_options_match_jax(name):
    """The fixed-step ``solver`` of the models that take one: rk4 (the
    node encoder euler), float64 logits / outputs, 1e-9; on the CPU under
    the default ``solver_mode``."""
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(0)
    if name in ("kanfet_node", "kanfet_mlp_node"):
        small = dict(T=12, latent_dim=4, num_basis=3, solver="rk4")
        if name == "kanfet_node":
            jspec, tspec = JM.KanFetNODESpec(**small), TM.KanFetNODESpec(
                **small)
            jp = JM.kanfet_node_init(key, jspec, jnp.float64)
            japply, tinit, tapply = (JM.kanfet_node_apply, TM.kanfet_node_init,
                                     TM.kanfet_node_apply)
        else:
            small.update(ode_hidden=5, n_steps=4)
            jspec, tspec = JM.KanFetMLPNODESpec(**small), \
                TM.KanFetMLPNODESpec(**small)
            jp = JM.kanfet_mlp_node_init(key, jspec, jnp.float64)
            japply, tinit, tapply = (JM.kanfet_mlp_node_apply,
                                     TM.kanfet_mlp_node_init,
                                     TM.kanfet_mlp_node_apply)
        x = rng.standard_normal((3, 12))
        want = japply(jp, jspec, jnp.asarray(x))
        mod = tinit(torch.Generator(), tspec, dtype=torch.float64)
        mod.load_state_dict(ecg_params_from_numpy(_tree(jp),
                                                  dtype=np.float64))
        got = tapply(mod, tspec, torch.from_numpy(x))
    elif name == "forecaster":
        kw = dict(num_features=2, context_len=6, pred_len=3, latent_dim=4,
                  enc_hidden=5, dec_hidden=5, dyn_hidden=5, solver="rk4")
        jspec, tspec = JF.LatentODEForecasterSpec(**kw), \
            TF.LatentODEForecasterSpec(**kw)
        jp = JF.latent_ode_forecaster_init(key, jspec, jnp.float64)
        x = rng.standard_normal((3, 6, 2))
        want = JF.latent_ode_forecast(jp, jspec, jnp.asarray(x))
        mod = TF.latent_ode_forecaster_init(torch.Generator(), tspec,
                                            dtype=torch.float64)
        mod.load_state_dict(forecast_params_from_numpy(_tree(jp),
                                                       dtype=np.float64))
        got = TF.latent_ode_forecast(mod, tspec, torch.from_numpy(x))
    else:
        kw = dict(d_in=2, cond_dim=4, solver="euler")
        jcfg, tcfg = JCD.NodeEncoderCfg(**kw), TCD.NodeEncoderCfg(**kw)
        jp = JCD.node_encoder_init(key, jcfg, jnp.float64)
        x = rng.standard_normal((3, 8, 2))
        want = JCD.node_encoder_apply(jp, jcfg, jnp.asarray(x))
        mod = TCD.node_encoder_init(torch.Generator(), tcfg,
                                    dtype=torch.float64)
        state = cond_diffusion_params_from_numpy(
            {"encoder": _tree(jp), "net": []}, dtype=np.float64)
        mod.load_state_dict({k[len("encoder."):]: v
                             for k, v in state.items()})
        got = TCD.node_encoder_apply(mod, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-9, atol=1e-12)
