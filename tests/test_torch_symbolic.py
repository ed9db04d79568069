"""PyTorch port, the symbolic-regression demo (``models/symbolic.py``) and
``cli symbolic`` against the JAX package's ``models/symbolic.py``.

The JAX net is initialised from ``PRNGKey(0)`` (what its
``train_symbolic(seed=0)`` starts from) and converted with
``convert.symbolic_params_from_numpy``.  Tolerances:
* ``symbolic_net_apply`` on 32 points of [-3, 3]: float32 within 1e-6
  (the same operations; sums over the bases in another order);
* 20 full-batch Adam epochs from the same parameters: the port's loss
  curve within 1e-4 relative of JAX's.  The JAX side runs with x64 on
  (the test process enables it), so its ``linspace`` inputs and the loss
  are float64 while the parameters stay float32; the port is float32
  throughout, and Adam's normalised steps keep the curves together;
* the trained parameters within 1e-3 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import symbolic as JS
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import (
    symbolic_grads_to_numpy,
    symbolic_params_from_numpy,
    symbolic_params_to_numpy,
)
from fetode_tpu_torch.models import symbolic as TS

SPEC = dict(hidden=8, num_basis=6, l1_coef=1e-3)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        JS.symbolic_net_init(jax.random.PRNGKey(0),
                             JS.SymbolicNetSpec(**SPEC)))


def _module(tree):
    spec = TS.SymbolicNetSpec(**SPEC)
    m = TS.symbolic_net_init(torch.Generator().manual_seed(0), spec)
    m.load_state_dict(symbolic_params_from_numpy(tree))
    return m


def test_apply_matches_jax(jparams):
    x = np.linspace(-3.0, 3.0, 32, dtype=np.float32)[:, None]
    want, _ = JS.symbolic_net_apply(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        JS.SymbolicNetSpec(**SPEC), jnp.asarray(x))
    with torch.no_grad():
        got, (s1, s2) = TS.symbolic_net_apply(
            _module(jparams), TS.SymbolicNetSpec(**SPEC), torch.from_numpy(x))
    assert got.shape == (32, 1) and s1.branch.shape == (32, 1, 8, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_params_round_trip(jparams):
    m = _module(jparams)
    back = symbolic_params_to_numpy(m)
    assert sorted(back) == ["l1", "l2"]
    for layer in ("l1", "l2"):
        assert sorted(back[layer]) == sorted(jparams[layer])
        for k, v in jparams[layer].items():
            np.testing.assert_array_equal(back[layer][k], v)
    zeros = symbolic_grads_to_numpy(m)        # no backward yet
    assert all(not v.any() for d in zeros.values() for v in d.values())


def test_training_tracks_jax(jparams):
    spec = JS.SymbolicNetSpec(**SPEC)
    jp, jlosses = JS.train_symbolic(spec, epochs=20, lr=5e-3, n_points=128,
                                    seed=0)
    tp, tlosses = TS.train_symbolic(TS.SymbolicNetSpec(**SPEC), epochs=20,
                                    lr=5e-3, n_points=128, device="cpu",
                                    init_params=_module(jparams))
    assert tlosses.shape == (20,) and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    got = symbolic_params_to_numpy(tp)
    for layer in ("l1", "l2"):
        for k, v in jp[layer].items():
            np.testing.assert_allclose(got[layer][k], np.asarray(v),
                                       rtol=1e-3, atol=1e-3)


def test_train_symbolic_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        TS.train_symbolic(epochs=0)
    params, losses = TS.train_symbolic(epochs=0, device="cpu")
    assert losses.shape == (0,)
    assert params.l1.coef.device.type == "cpu"


def test_cli_symbolic_on_cpu(tmp_path):
    res = cli.main(["symbolic", "--device", "cpu", "--epochs", "5",
                    "--out-dir", str(tmp_path)])
    assert np.isfinite(res["final_loss"])
    assert res["final_loss"] < res["initial_loss"]
    npz = np.load(tmp_path / "symbolic_trained.npz")
    assert sorted(npz.files) == sorted(
        f"{layer}.{k}" for layer in ("l1", "l2")
        for k in ("k", "ec", "ps", "bias", "coef"))
    assert npz["l1.coef"].shape == (1, 8, 6)
    assert npz["l2.coef"].shape == (8, 1, 6)


def test_cli_symbolic_plots_refused(tmp_path):
    """No longer refused: the loss curve and both layers' P-E loops."""
    cli.main(["symbolic", "--device", "cpu", "--plots", "--epochs", "3",
              "--out-dir", str(tmp_path)])
    pngs = sorted(p.name for p in tmp_path.rglob("*.png"))
    assert "loss.png" in pngs and len(pngs) == 13
