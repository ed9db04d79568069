"""PyTorch port, the Kuramoto-MNIST slice (``data/mnist.py``,
``models/kuramoto.py``, ``ops/kuramoto.py``, ``cli mnist``, ``serve
--source mnist``) against the JAX package: ``models/kuramoto.py`` (the
scan) and ``ops/pallas_kuramoto.py`` in interpret mode, as
``tests/test_pallas_kuramoto.py`` runs it.

Size of the JAX tests: an 8 x 8 lattice, 5 steps, B = 6 images; the head
KANLinear(128 -> 10), grid 5, order 3, 8 logistic bases; parameters from
``PRNGKey(3)`` converted with ``convert.kuramoto_params_from_numpy``, with
omega = 0.3 randn and K = 0.7 from a numpy seed so that every term of the
coupling is exercised.  Tolerances are the JAX tests' own: 2e-5 on the
features, 3e-4 on gradients, 5e-5 on logits.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fetode_tpu.data.mnist import load_mnist as j_load_mnist
from fetode_tpu.data.mnist import synthetic_digits as j_synthetic_digits
from fetode_tpu.models.kuramoto import KuramotoSpec as JSpec
from fetode_tpu.models.kuramoto import kuramoto_features as j_features
from fetode_tpu.models.kuramoto import kuramoto_init as j_init
from fetode_tpu.models.kuramoto import kuramoto_kan_apply as j_apply
from fetode_tpu.ops.pallas_kuramoto import pallas_kuramoto_features
from fetode_tpu.train.loop import init_state as j_init_state
from fetode_tpu.train.loop import make_minibatch_epoch as j_minibatch_epoch
from fetode_tpu.train.optim import make_optimizer as j_make_optimizer
from fetode_tpu_torch import cli
from fetode_tpu_torch.convert import (
    kuramoto_grads_to_numpy,
    kuramoto_params_from_numpy,
    kuramoto_params_to_numpy,
)
from fetode_tpu_torch.data.mnist import load_mnist, synthetic_digits
from fetode_tpu_torch.models import kuramoto as TK
from fetode_tpu_torch.ops import kuramoto as KO
from fetode_tpu_torch.train.loop import init_state, make_minibatch_epoch
from fetode_tpu_torch.train.optim import make_optimizer

H = W = 8
STEPS, B = 5, 6


def _tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _module(tree, spec):
    mod = TK.KuramotoKAN(spec)
    mod.load_state_dict(kuramoto_params_from_numpy(tree))
    return mod


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(tree)])


def _zero_grid(tree):
    tree["head"]["_buffers"]["grid"] = np.zeros_like(
        tree["head"]["_buffers"]["grid"])
    return tree


def _make(num_basis):
    jspec = JSpec(H=H, W=W, steps=STEPS, num_basis=num_basis)
    params = dict(j_init(jax.random.PRNGKey(3), jspec))
    rng = np.random.default_rng(7)
    params["omega"] = jnp.asarray(0.3 * rng.standard_normal((H, W)),
                                  jnp.float32)
    params["K"] = jnp.asarray(0.7, jnp.float32)
    tspec = TK.KuramotoSpec(H=H, W=W, steps=STEPS, num_basis=num_basis,
                            rollout="scan")
    return jspec, params, tspec, _tree(params)


@pytest.fixture(scope="module")
def setup():
    jspec, params, tspec, tree = _make(8)
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 1.0, (B, H, W)).astype(np.float32)
    wv = rng.standard_normal((B, 2 * H * W)).astype(np.float32)
    return dict(jspec=jspec, params=params, tspec=tspec, tree=tree, x=x,
                wv=wv, labels=np.arange(B) % 10)


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("seed,n", [(0, 512), (1, 128), (5, 37)])
def test_synthetic_digits_equal_jax(seed, n):
    x, y = synthetic_digits(seed=seed, n=n)
    jx, jy = j_synthetic_digits(seed=seed, n=n)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.dtype == np.float32 and y.dtype == np.int32


def _write_idx(path, arr, gz):
    head = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_reads_idx(tmp_path, gz):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (5, 28, 28))
    lbls = rng.integers(0, 10, (5,))
    ext = ".gz" if gz else ""
    _write_idx(tmp_path / f"t10k-images-idx3-ubyte{ext}", imgs, gz)
    _write_idx(tmp_path / f"t10k-labels-idx1-ubyte{ext}", lbls, gz)
    x, y = load_mnist("test", root=str(tmp_path))
    jx, jy = j_load_mnist("test", root=str(tmp_path))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(x, imgs / 255.0, rtol=1e-6)
    with pytest.raises(FileNotFoundError):
        load_mnist("train", root=str(tmp_path / "none"))


# ---------------------------------------------------------------- B.10 plain


@pytest.mark.parametrize("ndim", [3, 4])
def test_rollout_matches_jax(setup, ndim):
    """The plain rollout (the port's scan) against JAX's scan and the JAX
    kernel in interpret mode, for (B, H, W) and (B, 1, H, W) images."""
    s = setup
    x = s["x"] if ndim == 3 else s["x"][:, None]
    ref = np.asarray(j_features(s["params"], s["jspec"], jnp.asarray(x)))
    pal = np.asarray(pallas_kuramoto_features(s["params"], s["jspec"],
                                              jnp.asarray(x), interpret=True))
    mod = _module(s["tree"], s["tspec"])
    with torch.no_grad():
        got = TK.kuramoto_features(mod, s["tspec"], torch.from_numpy(x))
        fwd = KO.kuramoto_fwd(mod.omega, mod.K, KO.theta0_of(
            torch.from_numpy(x), H, W), s["tspec"].lattice)
    assert got.shape == (B, 2 * H * W)
    for want in (ref, pal):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(fwd.numpy(), got.numpy())


def _jax_rollout_grads(s):
    wv = jnp.asarray(s["wv"])

    def loss(om, kc, xi):
        f = pallas_kuramoto_features({"omega": om, "K": kc}, s["jspec"], xi,
                                     interpret=True)
        return jnp.sum(f * wv)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        s["params"]["omega"], s["params"]["K"], jnp.asarray(s["x"]))]


@pytest.mark.parametrize("plain", ["autograd", "bwd_reference"])
def test_rollout_grads_match_jax_kernel(setup, plain):
    """(omega, K, x) gradients of both plain versions against ``jax.grad``
    through the JAX kernel's replay adjoint."""
    s = setup
    want = _jax_rollout_grads(s)
    mod = _module(s["tree"], s["tspec"])
    lat = s["tspec"].lattice
    x = torch.from_numpy(s["x"]).requires_grad_()
    theta0 = KO.theta0_of(x, H, W)
    wv = torch.from_numpy(s["wv"])
    if plain == "autograd":
        torch.sum(KO.kuramoto_rollout_reference(mod.omega, mod.K, theta0,
                                                lat) * wv).backward()
        got = [mod.omega.grad, mod.K.grad, x.grad]
    else:
        th0bar, gom, gk = KO.kuramoto_bwd(mod.omega.detach(), mod.K.detach(),
                                          theta0.detach(), wv, lat)
        theta0.backward(th0bar)
        got = [gom, gk, x.grad]
    for g, w, name in zip(got, want, ("omega", "K", "x")):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=3e-4,
                                   atol=3e-4, err_msg=name)


def test_bwd_reference_equals_autograd_float64(setup):
    """The written-out replay adjoint is the VJP of the rollout: against
    autograd in float64, 1e-10."""
    s = setup
    lat = s["tspec"].lattice
    rng = np.random.default_rng(4)
    om = torch.from_numpy(0.3 * rng.standard_normal((H, W))).requires_grad_()
    K = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    th0 = torch.from_numpy(rng.uniform(-3, 3, (B, H * W))).requires_grad_()
    ct = torch.from_numpy(rng.standard_normal((B, 2 * H * W)))
    torch.sum(KO.kuramoto_rollout_reference(om, K, th0, lat) * ct).backward()
    th0bar, gom, gk = KO.kuramoto_rollout_bwd_reference(
        om.detach(), K.detach(), th0.detach(), ct, lat)
    for got, want in ((th0bar, th0.grad), (gom, om.grad), (gk, K.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-12)


# ---------------------------------------------------------------- B.11 plain


@pytest.fixture(scope="module", params=[8, 0], ids=["logistic", "no_logistic"])
def heads(request, setup):
    if request.param == 8:
        return setup
    jspec, params, tspec, tree = _make(0)
    return dict(setup, jspec=jspec, params=params, tspec=tspec, tree=tree)


def test_logits_match_jax(heads):
    """``kuramoto_kan_apply`` (scan) and ``kuramoto_logits_reference``
    against JAX's scan and ``pallas_fused`` logits, with and without the
    logistic branch (``test_fused_no_logistic_branch``)."""
    s = heads
    x = jnp.asarray(s["x"])
    ref = np.asarray(j_apply(s["params"], s["jspec"], x))
    fused = np.asarray(j_apply(s["params"],
                               s["jspec"]._replace(rollout="pallas_fused"),
                               x))
    mod = _module(s["tree"], s["tspec"])
    xt = torch.from_numpy(s["x"])
    with torch.no_grad():
        scan = TK.kuramoto_kan_apply(mod, s["tspec"], xt)
        plain = KO.kuramoto_logits(mod.omega, mod.K, KO.theta0_of(xt, H, W),
                                   *TK.head_operands(mod.head),
                                   s["tspec"].lattice)
    assert scan.shape == (B, 10)
    for got in (scan, plain):
        for want in (ref, fused):
            np.testing.assert_allclose(got.numpy(), want, rtol=5e-5,
                                       atol=5e-5)


def test_pack_head_layout(heads):
    """The fused kernel's head operands: knots and logistic parameters
    feature-minor, the weights term-major (base, spline, logistic) and
    feature-minor, all without autograd."""
    mod = _module(heads["tree"], heads["tspec"])
    grid, wb, sw, la, lb, lw = TK.head_operands(mod.head)
    p = KO.pack_head(grid, wb, sw, la, lb, lw)
    n_coeff, n_l = sw.shape[2], 0 if la is None else la.shape[1]
    assert (p.n_classes, p.n_logistic) == (10, n_l)
    assert p.wp.shape == (10, 1 + n_coeff + n_l, 2 * H * W)
    assert all(t.is_contiguous() and not t.requires_grad for t in p)
    assert torch.equal(p.knots, grid.T)
    assert torch.equal(p.wp[:, 0], wb.detach())
    assert torch.equal(p.wp[:, 1:1 + n_coeff], sw.detach().transpose(1, 2))
    if n_l:
        assert torch.equal(p.la, la.detach().T)
        assert torch.equal(p.lb, lb.detach().T)
        assert torch.equal(p.wp[:, 1 + n_coeff:], lw.detach().transpose(1, 2))
    else:
        assert p.la.shape == p.lb.shape == (0, 2 * H * W)


def test_packed_head_made_once_per_weight_version(setup):
    """A packing is made from the weights as they are when it is made: after
    an in-place write (an optimiser step) or ``load_state_dict`` the next
    packing carries the new weights, and the plain version of the fused
    kernel, which reads a given packing, gives the logits of those
    weights; ``unpack_head`` inverts ``pack_head``."""
    mod = _module(setup["tree"], setup["tspec"])
    spec, x = setup["tspec"], torch.from_numpy(setup["x"])
    theta0 = KO.theta0_of(x, H, W)

    def fused_plain(packed):
        return KO.kuramoto_logits(mod.omega, mod.K, theta0,
                                  *TK.head_operands(mod.head), spec.lattice,
                                  packed=packed)

    packed = TK.packed_head(mod.head)
    for got, want in zip(KO.unpack_head(packed), TK.head_operands(mod.head)):
        assert torch.equal(got, want.detach())
    with torch.no_grad():
        mod.head.base_weight.add_(1.0)
        stepped = TK.packed_head(mod.head)
        assert torch.equal(stepped.wp[:, 0], mod.head.base_weight)
        torch.testing.assert_close(fused_plain(stepped),
                                   TK.kuramoto_kan_apply(mod, spec, x))
        assert not torch.allclose(fused_plain(packed), fused_plain(stepped))
    mod.load_state_dict(kuramoto_params_from_numpy(setup["tree"]))
    for a, b in zip(TK.packed_head(mod.head), packed):
        assert torch.equal(a, b)
    opt = make_optimizer(1e-2, params=mod.parameters(), kind="adamw")
    for p in mod.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert torch.equal(TK.packed_head(mod.head).wp[:, 0],
                       mod.head.base_weight.detach())


def test_packing_sees_writes_through_data(setup):
    """A write through ``.data`` bumps no version counter; the next packing
    and the fused path's plain version on it must still see it."""
    mod = _module(setup["tree"], setup["tspec"])
    spec, x = setup["tspec"], torch.from_numpy(setup["x"])
    before = TK.packed_head(mod.head)
    mod.head.spline_scaler.data.mul_(2.0)
    mod.head.logistic.b.data.add_(0.5)
    after = TK.packed_head(mod.head)
    assert not torch.equal(after.wp, before.wp)
    assert torch.equal(after.lb, mod.head.logistic.b.detach().T)
    with torch.no_grad():
        got = KO.kuramoto_logits(mod.omega, mod.K, KO.theta0_of(x, H, W),
                                 *TK.head_operands(mod.head), spec.lattice,
                                 packed=after)
        want = TK.kuramoto_kan_apply(mod, spec, x)
    torch.testing.assert_close(got, want)


def test_fused_grads_match_jax(heads):
    """The fused classifier's gradients (the plain version under autograd,
    as the CPU takes it) against ``jax.grad`` of JAX's ``pallas_fused``
    path, every leaf; the knot grid, a buffer here, is zeroed."""
    s = heads
    x = jnp.asarray(s["x"])
    labels = jnp.asarray(s["labels"])
    jspec = s["jspec"]._replace(rollout="pallas_fused")

    def loss(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            j_apply(p, jspec, x), labels).mean()

    want = _zero_grid(_tree(jax.grad(loss)(s["params"])))
    mod = _module(s["tree"], s["tspec"])
    xt = torch.from_numpy(s["x"])
    logits = KO.kuramoto_logits(mod.omega, mod.K, KO.theta0_of(xt, H, W),
                                *TK.head_operands(mod.head),
                                s["tspec"].lattice)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(s["labels"]).long()).backward()
    got = kuramoto_grads_to_numpy(mod)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=3e-4, atol=3e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_convert_round_trip(setup):
    back = kuramoto_params_to_numpy(_module(setup["tree"], setup["tspec"]))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(setup["tree"]))
    np.testing.assert_array_equal(_flat(back), _flat(setup["tree"]))


# ------------------------------------------------------------- model, train


@pytest.mark.parametrize("rollout", ["pallas", "pallas_fused", "typo"])
def test_dispatch_refusals(setup, rollout):
    mod = _module(setup["tree"], setup["tspec"])
    spec = setup["tspec"]._replace(rollout=rollout)
    x = torch.from_numpy(setup["x"])
    match = "CUDA tensors" if rollout != "typo" else "expected"
    with pytest.raises(ValueError, match=match):
        TK.kuramoto_kan_apply(mod, spec, x)
    with pytest.raises(ValueError, match=match):
        TK.kuramoto_features(mod, spec, x)


def test_auto_on_cpu_is_the_scan(setup):
    mod = _module(setup["tree"], setup["tspec"])
    x = torch.from_numpy(setup["x"])
    with torch.no_grad():
        auto = TK.kuramoto_kan_apply(mod, setup["tspec"]._replace(
            rollout="auto"), x)
        scan = TK.kuramoto_kan_apply(mod, setup["tspec"], x)
    np.testing.assert_array_equal(auto.numpy(), scan.numpy())
    assert TK.KuramotoSpec().rollout == "auto"


def test_init_shapes_and_names():
    spec = TK.KuramotoSpec(H=H, W=W)
    mod = TK.kuramoto_init(torch.Generator().manual_seed(0), spec)
    jtree = _tree(j_init(jax.random.PRNGKey(0), JSpec(H=H, W=W)))
    mine = kuramoto_params_to_numpy(mod)
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(jtree))
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.shape == b.shape
    assert float(mod.K.detach()) == 0.5 and not mod.omega.detach().any()


def test_adamw_epoch_matches_jax(setup):
    """One epoch of ``make_minibatch_epoch`` (3 minibatches of 4, AdamW 1e-3,
    weight decay 1e-4, cross-entropy) from the converted parameters: the
    losses equal JAX's within 1e-5."""
    s = setup
    xs, ys = synthetic_digits(seed=3, n=12, H=H, W=W)
    bx, by = xs.reshape(3, 4, H, W), ys.reshape(3, 4)
    tx = j_make_optimizer(1e-3, kind="adamw", weight_decay=1e-4,
                          params=s["params"])

    def j_loss(p, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            j_apply(p, s["jspec"], x), y).mean()

    _, j_losses = j_minibatch_epoch(j_loss, tx)(
        j_init_state(s["params"], tx), (jnp.asarray(bx), jnp.asarray(by)))
    mod = _module(s["tree"], s["tspec"])
    opt = make_optimizer(1e-3, params=mod.parameters(), kind="adamw",
                         weight_decay=1e-4)

    def loss_fn(p, x, y):
        return torch.nn.functional.cross_entropy(
            TK.kuramoto_kan_apply(p, s["tspec"], x), y)

    _, losses = make_minibatch_epoch(loss_fn)(
        init_state(mod, opt), (torch.from_numpy(bx),
                               torch.from_numpy(by).long()))
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=1e-5, atol=1e-5)


def test_cli_mnist_on_cpu(tmp_path):
    result = cli.main(["mnist", "--device", "cpu", "--epochs", "1",
                       "--kuramoto_steps", "2", "--batch_size", "64",
                       "--out-dir", str(tmp_path)])
    assert 0.0 <= result["test_acc"] <= 1.0
    assert (tmp_path / "result.json").exists()


def test_cli_serve_mnist_on_cpu(tmp_path):
    """Requests through the bundle equal direct calls on the unpadded
    batch: the images are independent."""
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.serve import load_servable

    argv = ["serve", "--source", "mnist", "--rollout", "scan", "--device",
            "cpu", "--buckets", "8", "--iters", "2", "--out-dir",
            str(tmp_path)]
    result = cli.main(argv)
    assert [row["batch"] for row in result["bench"]] == [8]
    cfg = make_config("serve", cli._parse(argv)[1])
    params, fn, _ = cli.SERVING["mnist"](cfg, torch.device("cpu"))
    sv = load_servable(result["bundle"], fn, params)
    x = torch.from_numpy(synthetic_digits(seed=4, n=3)[0])
    with torch.no_grad():
        got = sv.predict(x)
        want = fn(sv.params, x)
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("argv", [["mnist"], ["serve", "--source", "mnist"],
                                  ["mnist", "--device", "cpu",
                                   "--mesh_devices", "2"], ["symbolic"]])
def test_cli_refusals(tmp_path, argv):
    if "--mesh_devices" in argv:
        # the override spelling of --mesh runs: main starts two gloo
        # ranks itself, and rank 0's result is the single-device one
        small = ["--epochs", "1", "--kuramoto_steps", "2", "--batch_size",
                 "64"]
        got = cli.main(argv + small + ["--out-dir", str(tmp_path / "mesh")])
        assert (tmp_path / "mesh" / "result.json").exists()
        want = cli.main(argv[:3] + small + ["--out-dir", str(tmp_path)])
        np.testing.assert_allclose(got["test_acc"], want["test_acc"])
    else:
        if torch.cuda.is_available():
            pytest.skip("checks the refusal of --device cuda without CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv + ["--out-dir", str(tmp_path)])


# --------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fetode_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
def test_rollout_kernels_match_plain_on_card(setup):
    dev = _card()
    s = setup
    mod = _module(s["tree"], s["tspec"]).to(dev)
    lat = s["tspec"].lattice
    theta0 = KO.theta0_of(torch.from_numpy(s["x"]).to(dev), H, W)
    ct = torch.from_numpy(s["wv"]).to(dev)
    with torch.no_grad():
        feat = KO.kuramoto_fwd(mod.omega, mod.K, theta0, lat)
        want = KO.kuramoto_rollout_reference(mod.omega, mod.K, theta0, lat)
    got_b = KO.kuramoto_bwd(mod.omega, mod.K, theta0, ct, lat)
    want_b = KO.kuramoto_rollout_bwd_reference(mod.omega, mod.K, theta0, ct,
                                               lat)
    torch.cuda.synchronize()
    torch.testing.assert_close(feat, want, rtol=1e-4, atol=1e-4)
    for g, w in zip(got_b, want_b):
        assert float((g - w).norm() / w.norm()) < 1e-4


@pytest.mark.cuda
def test_fused_kernel_matches_plain_on_card(heads):
    dev = _card()
    s = heads
    mod = _module(s["tree"], s["tspec"]).to(dev)
    theta0 = KO.theta0_of(torch.from_numpy(s["x"]).to(dev), H, W)
    args = (mod.omega, mod.K, theta0, *TK.head_operands(mod.head),
            s["tspec"].lattice)
    with torch.no_grad():
        got = KO.kuramoto_logits(*args)
        packed = KO.kuramoto_logits(*args, packed=KO.pack_head(*args[3:-1]))
        want = KO.kuramoto_logits_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(packed, got)


# ------------------------------------------------ B.11's slice plan (CPU)


@pytest.mark.parametrize("B", [1, 8, 64, 300, 1024])
@pytest.mark.parametrize("HW,C", [(28 * 28, 10), (H * W, 3)],
                         ids=["mnist", "narrow"])
def test_slice_plan_covers_every_feature_once(HW, C, B):
    """``slice_plan``: the 8 CTAs of a cluster own disjoint feature slices
    that cover the 2 HW features in order, the same at every batch, so
    every image gets every feature's terms exactly once; the clusters own
    disjoint image ranges that cover the batch; a CTA fits 227 KB."""
    F = 2 * HW
    p = KO.slice_plan(HW, C, 8, B)
    feats = [f for sl in p["slices"] for f in sl]
    assert feats == list(range(F)) and len(p["slices"]) == KO.CLUSTER
    assert p["slices"] == KO.slice_plan(HW, C, 8, 1)["slices"]
    assert [i for rg in p["images"] for i in rg] == list(range(B))
    assert 1 <= p["clusters"] <= KO.MAX_CLUSTERS == 16
    assert p["smem_bytes"] <= KO.LOGITS_SMEM


@pytest.mark.parametrize("n_logistic,where", [(0, "shared"), (8, "shared"),
                                              (32, "device")])
def test_slice_plan_places_the_weights(n_logistic, where):
    """Where a CTA holds its slice's weights: in shared memory while they
    fit beside its rollouts (MNIST, 0 or 8 logistic terms), else read
    from device memory; every head the kernel took before still runs."""
    p = KO.slice_plan(28 * 28, 10, n_logistic, 256)
    assert p["weights"] == where
    assert KO.slice_plan(H * W, 3, n_logistic)["weights"] == "shared"
    assert KO.slice_plan(1024, 16, 64)["weights"] == "device"


@pytest.mark.cuda
def test_fused_kernel_image_alone_equals_batch_on_card(heads):
    """An image's logits are the same bits alone, inside its batch and in
    a second call: the slices and every sum's order do not depend on B."""
    dev = _card()
    s = heads
    mod = _module(s["tree"], s["tspec"]).to(dev)
    theta0 = KO.theta0_of(torch.from_numpy(s["x"]).to(dev), H, W)
    head = TK.head_operands(mod.head)
    packed = KO.pack_head(*head)
    lat = s["tspec"].lattice
    with torch.no_grad():
        big = theta0.repeat(40, 1)               # 240 images, 15 rounds
        got = KO.kuramoto_logits(mod.omega, mod.K, big, *head, lat,
                                 packed=packed)
        again = KO.kuramoto_logits(mod.omega, mod.K, big, *head, lat,
                                   packed=packed)
        alone = [KO.kuramoto_logits(mod.omega, mod.K, theta0[r:r + 1], *head,
                                    lat, packed=packed) for r in range(B)]
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for r in range(B):
        assert torch.equal(alone[r], got[r:r + 1])
        assert torch.equal(got[r::B], got[r:r + 1].expand(40, -1))


# ------------------------------------------------ B.10's launch plan (CPU)


@pytest.mark.parametrize("B", [1, 8, 128, 132, 133, 256, 1024])
@pytest.mark.parametrize("HW", [16, 28 * 28, 1024])
def test_rollout_plan_covers_every_image_and_site_once(HW, B):
    side = int(HW ** 0.5)                       # 4 x 4, 28 x 28, 32 x 32
    """``rollout_plan``: the CTAs own disjoint image ranges that cover the
    batch, the threads of an image disjoint sites that cover the lattice;
    1, 2 or 4 sites a thread, a thread a site while the batch is within
    the SM count (132), more sites a thread past it at MNIST's lattice;
    a CTA within 1,024 threads and 227 KB; the backward records sin and
    cos where they fit."""
    for bwd in (False, True):
        p = KO.rollout_plan(B, side, side, 10, 132, bwd)
        assert [i for rg in p["cta_images"] for i in rg] == list(range(B))
        assert len(p["cta_images"]) == p["ctas"]
        assert sorted(s for ss in p["sites"] for s in ss) == list(range(HW))
        assert all(len(ss) <= p["k"] for ss in p["sites"])
        assert p["k"] in (1, 2, 4) and p["threads"] == p["images"] * p["tpi"]
        assert p["tpi"] % 32 == 0 and p["threads"] <= 1024
        assert p["smem_bytes"] + bwd * KO.BWD_STATIC <= KO.ROLL_SMEM
        if B <= 132:
            assert p["k"] == 1
        elif HW == 28 * 28:
            assert p["k"] > 1
        assert p["form"] == ("sincos" if bwd else None)
        assert p["reduce_ctas"] * KO.REDUCE_COLS >= HW + 1


def test_rollout_plan_records_form_and_refusal():
    """The backward keeps theta_t alone where sin and cos of every step do
    not fit a CTA (40 steps at MNIST: 263 KB against 138 KB), and refuses a
    lattice whose records fit neither form, naming the sizes."""
    p = KO.rollout_plan(128, 28, 28, 40, 132, bwd=True)
    assert p["form"] == "theta" and p["smem_bytes"] == 44 * 784 * 4
    assert KO.rollout_plan(128, 28, 28, 40, 132)["form"] is None
    with pytest.raises(ValueError, match=r"514304 bytes as sin and cos, "
                                         r"263424 as theta"):
        KO.rollout_plan(8, 28, 28, 80, 132, bwd=True)
    with pytest.raises(ValueError, match="rollout_plan"):
        KO.rollout_plan(0, 28, 28, 10)


@pytest.mark.parametrize("side, steps, fits", [
    (28, 70, True), (28, 71, False), (32, 52, True), (32, 53, False)])
def test_rollout_plan_theta_form_keeps_the_envelope(side, steps, fits):
    """The theta-records form takes (steps + 4) H W floats and the static
    128 bytes, as the records of the form before the sin / cos one did, so
    the backward refuses no lattice that form ran: 70 steps at 28 x 28 (a
    ``kuramoto_steps`` the MNIST config accepts) and 52 at 32 x 32 fit, one
    step more does not."""
    if not fits:
        with pytest.raises(ValueError, match="kuramoto_bwd"):
            KO.rollout_plan(128, side, side, steps, 132, bwd=True)
        return
    p = KO.rollout_plan(128, side, side, steps, 132, bwd=True)
    assert p["form"] == "theta" and p["images"] == 1
    assert p["smem_bytes"] == (steps + 4) * side * side * 4
    assert p["smem_bytes"] + KO.BWD_STATIC <= KO.ROLL_SMEM


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 128, 133, 256, 1024])
def test_rollout_plan_matches_library_on_card(B):
    """The library's ``kuramoto_rollout_plan`` is ``rollout_plan``'s at the
    card's SM count (the wrappers check it before a launch), in both
    records forms and where images are packed."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bwd in (False, True):
        for side, steps in ((28, 10), (28, 40), (8, 10)):
            KO._check_rollout_plan(B, side, side, steps, sms, bwd)
