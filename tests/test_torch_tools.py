"""PyTorch port, ``train/tools.py`` and ``utils/{trees,debug}.py`` against
the JAX package's.

* ``EarlyStopping`` and ``exponential_decay_schedule``: the same answers
  as JAX's on the same metric sequences.
* ``cosine_schedule``: optax's ``cosine_decay_schedule`` values within
  1e-7 over 1,000 steps (past the end too), and through
  ``torch.optim.lr_scheduler.LambdaLR`` on an optimiser of lr 1.0.
* ``trainable_mask`` / ``tree_size`` on a KAN stack against JAX's on the
  same stack's param tree (the knot grids are the JAX mask's
  ``_buffers`` leaves and the port's buffers); ``tree_health`` the same
  figures as JAX's; ``check_finite``, ``debug_nans`` (autograd's anomaly
  mode), the watchdog and ``enable_compile_cache`` (a logged no-op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fetode_tpu.nn import kan as JK
from fetode_tpu.train import tools as JT
from fetode_tpu.utils import debug as JD
from fetode_tpu.utils import trees as JTR
from fetode_tpu_torch.convert import params_from_numpy, params_to_numpy
from fetode_tpu_torch.nn import kan as TK
from fetode_tpu_torch.train import tools as TT
from fetode_tpu_torch.utils import debug as TD
from fetode_tpu_torch.utils import trees as TTR


@pytest.mark.parametrize("mode", ["min", "max"])
def test_early_stopping_matches_jax(mode):
    metrics = [1.0, 0.9, 0.95, 0.9, 0.91, 0.89, 0.95, 0.96, 0.97, 0.5]
    j, t = (m.EarlyStopping(patience=3, min_delta=0.005, mode=mode)
            for m in (JT, TT))
    for v in metrics:
        assert t.step(v) == j.step(v)
        assert (t.best, t.counter, t.should_stop) == \
            (j.best, j.counter, j.should_stop)


def test_exponential_decay_matches_jax():
    j = JT.exponential_decay_schedule(1e-3, decay=0.5, every=3)
    t = TT.exponential_decay_schedule(1e-3, decay=0.5, every=3)
    assert [t(e) for e in range(20)] == [j(e) for e in range(20)]


@pytest.mark.parametrize("min_scale", [0.0, 0.1])
def test_cosine_schedule_is_optax(min_scale):
    want = optax.cosine_decay_schedule(3e-3, 1000, alpha=min_scale)
    t = TT.cosine_schedule(3e-3, 1000, min_scale)
    steps = np.arange(1100)
    np.testing.assert_allclose([t(int(s)) for s in steps],
                               np.asarray(jax.vmap(want)(steps)), rtol=0,
                               atol=1e-7)
    assert JT.cosine_schedule(3e-3, 1000, min_scale)(500) == \
        pytest.approx(t(500), abs=1e-7)


def test_cosine_schedule_drives_lambda_lr():
    w = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([w], lr=1.0)
    sched = TT.cosine_schedule(1e-2, 50)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, sched)
    want = optax.cosine_decay_schedule(1e-2, 50)
    for step in range(60):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(want(step)), abs=1e-7)
        opt.step()
        lr.step()


def test_dotdict():
    d = TT.dotdict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2 and d.missing is None
    del d.a
    assert "a" not in d


def _kan():
    cfg = JK.KANConfig.make([2, 5, 3], logistic_num_basis=2,
                            ferro_num_basis=2)
    jp = JK.kan_init(jax.random.PRNGKey(0), cfg, jnp.float64)
    kan = TK.kan_init(torch.Generator().manual_seed(0), TK.KANConfig(
        tuple(TK.KANLinearConfig(**c._asdict()) for c in cfg.layers)),
        dtype=torch.float64)
    kan.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), dtype=torch.float64))
    return jp, kan


def test_trainable_mask_and_size_match_jax():
    jp, kan = _kan()
    mask = TTR.trainable_mask(kan)
    assert list(mask) == list(kan.state_dict())
    as_tree = params_to_numpy({k: torch.tensor(float(v))
                               for k, v in mask.items()})
    want = jax.tree_util.tree_map(bool, JTR.trainable_mask(jp))
    got = jax.tree_util.tree_map(bool, as_tree)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)
    assert TTR.tree_size(kan) == JTR.tree_size(jp)
    kan.layers[0].base_weight.requires_grad_(False)
    assert not TTR.trainable_mask(kan)["layers.0.base_weight"]


def test_tree_health_and_check_finite_match_jax():
    jp, kan = _kan()
    with torch.no_grad():
        kan.layers[1].base_weight[0, 0] = float("nan")
    jp[1]["base_weight"] = jp[1]["base_weight"].at[0, 0].set(jnp.nan)
    got = TD.tree_health(kan)
    want = JD.tree_health(jp)
    assert sorted((v["nonfinite"], str(round(v["max_abs"], 12)))
                  for v in got.values()) == \
        sorted((v["nonfinite"], str(round(v["max_abs"], 12)))
               for v in want.values())
    with pytest.raises(FloatingPointError, match="layers.1.base_weight"):
        TD.check_finite(kan, "kan")
    ok = {"a": torch.ones(3), "b": [torch.zeros(2), torch.arange(3)]}
    assert TD.check_finite(ok) is ok


def test_debug_nans_raises_in_the_backward():
    x = torch.tensor(-1.0, requires_grad=True)
    with TD.debug_nans():
        y = torch.sqrt(x)
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    with TD.debug_nans(False):
        torch.sqrt(x).backward()
    assert torch.isnan(x.grad)


def test_watchdog_and_compile_cache():
    TD.device_init_watchdog(0)()
    disarm = TD.device_init_watchdog(30.0)
    disarm()
    lines = []
    path = TD.enable_compile_cache("/elsewhere", log=lines.append)
    assert path.endswith("_build") and "no-op" in lines[0]
