"""PyTorch port, the predprey serving slice on the CPU: the CLI exports a
bundle, loads it back and benches it; the loaded bundle serves
trajectories that match the JAX package's ``vmap(predict)`` on the same
parameters; bucket padding and chunking; fingerprint and device checks.

Small sizes: 40 output times (horizon 14 * 39/139, the times of
``tests/test_pallas_node.py``), buckets (2, 4), one timed call per window.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetode_tpu.models import predprey as jpp
from fetode_tpu_torch import cli
from fetode_tpu_torch.config import make_config
from fetode_tpu_torch.convert import params_to_numpy
from fetode_tpu_torch.nn.kan import KAN, kanfet_config
from fetode_tpu_torch.serve import (
    Servable,
    export_servable,
    fingerprint,
    load_servable,
    serve_bench,
)

N_POINTS = 40
HORIZON = 14.0 * 39 / 139


def _argv(tmp_path, *extra):
    return ["serve", "--source", "predprey", "--device", "cpu",
            "--n_points", str(N_POINTS), "--horizon", repr(HORIZON),
            "--buckets", "2,4", "--iters", "1",
            "--out-dir", str(tmp_path), *extra]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    argv = _argv(tmp)
    result = cli.main(argv)
    cfg = make_config("serve", cli._parse(argv)[1])
    _, fn, _ = cli.predprey_serving(cfg, torch.device("cpu"))
    sv = load_servable(result["bundle"], fn, KAN(kanfet_config([2, 10, 2])))
    return dict(result=result, sv=sv, fn=fn, out_dir=tmp)


def test_cli_serve_result(served):
    r = served["result"]
    assert r["source"] == "predprey" and r["buckets"] == [2, 4]
    assert r["fingerprint"] == fingerprint(torch.device("cpu"))
    assert [row["batch"] for row in r["bench"]] == [2, 4]
    for row in r["bench"]:
        assert row["windows"] >= 3 and len(row["window_p50_ms"]) == 3
        assert 0 < row["p50_ms"] <= row["p99_ms"]
        assert row["device"] == "cpu"
    with open(os.path.join(served["out_dir"], "result.json")) as f:
        assert json.load(f)["bundle"] == r["bundle"]


def test_served_trajectories_match_jax_vmap_predict(served):
    """The slice against JAX on the bundle's own parameters.  1e-3, the
    JAX package's kernel tolerance; the solves agree to ~1e-5 here."""
    sv = served["sv"]
    tree = params_to_numpy(sv.params)
    jspec = jpp.PredPreyNODE.kanfet(solver_mode="while")
    ts = np.linspace(0.0, HORIZON, N_POINTS).astype(np.float32)
    x0s = np.random.default_rng(3).uniform(0.5, 2.0, (3, 2)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda x0: jpp.predict(
        tree, jspec, x0, jnp.asarray(ts)))(jnp.asarray(x0s)))
    out = sv.predict(torch.from_numpy(x0s)).numpy()
    assert out.shape == (3, N_POINTS, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_pallas_mode_on_cpu_serves_the_reference(served, tmp_path):
    """``--solver_mode pallas`` is the kernel wrapper, which on the CPU
    returns its plain twin: same trajectories as the default mode."""
    argv = _argv(tmp_path, "--solver_mode", "pallas")
    r = cli.main(argv)
    cfg = make_config("serve", cli._parse(argv)[1])
    _, fn, _ = cli.predprey_serving(cfg, torch.device("cpu"))
    sv = load_servable(r["bundle"], fn, KAN(kanfet_config([2, 10, 2])))
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 2.0, (4, 2)).astype(np.float32))
    np.testing.assert_array_equal(sv.predict(x).numpy(),
                                  served["sv"].predict(x).numpy())


@pytest.mark.parametrize("batch,calls", [(1, [2]), (3, [4]), (4, [4]),
                                         (9, [4, 4, 2])])
def test_bucket_padding_and_chunking(batch, calls):
    """Exact, with a row-wise stand-in for the solve: pads up to the
    smallest bucket, chunks past the largest, and returns the rows in
    order."""
    model = KAN(kanfet_config([2, 3, 2], ferro_num_basis=1))
    seen = []

    def fn(p, x):
        seen.append(x.shape[0])
        return torch.stack([x, 2 * x], dim=1)

    sv = Servable("", {"buckets": [2, 4], "sample_dtype": "float32"}, fn,
                  model)
    x = torch.arange(2 * batch, dtype=torch.float32).reshape(batch, 2)
    out = sv.predict(x)
    assert seen == calls
    assert torch.equal(out, torch.stack([x, 2 * x], dim=1))


def test_bucket_padding_with_the_solve(served):
    """Padded and chunked requests against one direct solve of the same
    rows.  1e-5: on the CPU the padded rows share the batched matmuls, so
    a row's arithmetic can move by an ulp with its batch-mates."""
    sv, fn = served["sv"], served["fn"]
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 2.0, (5, 2)).astype(np.float32))
    with torch.no_grad():
        direct = fn(sv.params, x)
    for rows in (slice(0, 1), slice(0, 3), slice(0, 5)):
        np.testing.assert_allclose(sv.predict(x[rows]).numpy(),
                                   direct[rows].numpy(), rtol=1e-5, atol=1e-5)


def test_fingerprint_mismatch_raises(served, tmp_path):
    model = KAN(kanfet_config([2, 10, 2]))
    export_servable(str(tmp_path), served["sv"].params,
                    torch.ones(1, 2), buckets=(2,))
    meta_path = tmp_path / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["fingerprint"]["device_kind"] = "another card"
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="exported under"):
        load_servable(str(tmp_path), served["fn"], model)


def test_serve_bench_refuses_empty_windows(served):
    with pytest.raises(ValueError, match="iters"):
        serve_bench(served["sv"], torch.ones(2, 2), iters=0)


def test_cli_refusals(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of --device cuda without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--source", "predprey", "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["symbolic", "--out-dir", str(tmp_path)])
    # timemmd is ported: its preset has the JAX package's fields (and the
    # port's device), and without CUDA it refuses the card as the others
    from fetode_tpu.config import TimeMMDPreset as JTimeMMD

    jcfg, tcfg = JTimeMMD(), make_config("timemmd")
    assert {f: getattr(tcfg, f) for f in vars(jcfg)} == vars(jcfg)
    assert set(vars(tcfg)) - set(vars(jcfg)) == {"device"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["timemmd", "--out-dir", str(tmp_path)])
    # serve --ckpt_dir is ported (tests/test_torch_checkpoint.py); a
    # directory without checkpoints is refused
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        cli.main(["serve", "--source", "predprey", "--device", "cpu",
                  "--ckpt_dir", str(tmp_path / "empty"), "--out-dir",
                  str(tmp_path)])
    with pytest.raises(ValueError, match="unknown option"):
        cli.main(["serve", "--no_such_flag", "1", "--out-dir", str(tmp_path)])
