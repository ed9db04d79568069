"""The Kuramoto phase lattice of the MNIST classifier: the whole Euler
rollout, its replay adjoint and the rollout fused with the KANLinear head,
as CUDA kernels with their plain PyTorch versions.

Counterpart of ``fetode_tpu/ops/pallas_kuramoto.py`` (the TPU kernels
``make_kuramoto_rollout`` :179 and ``make_kuramoto_fused_classifier``
:388).  The CUDA source is ``fetode_tpu_torch/csrc/kuramoto.cu``; its
header gives the design and what bounds it.

The lattice: each of B images is H x W oscillators with phases theta
(B, H*W).  ``steps`` Euler steps of size ``dt``

    theta <- theta + dt * (omega + K * (cos theta * S(sin theta)
                                        - sin theta * S(cos theta)))

with S the 4-neighbour sum, zero outside the lattice, give the features
[cos theta_T | sin theta_T], (B, 2*H*W).  ``omega`` is (H, W), ``K`` a
scalar tensor.

* ``kuramoto_fwd`` / ``kuramoto_bwd`` — the kernel wrappers of the
  rollout and its replay adjoint, each with a launch counter
  (``.launches``); ``kuramoto_rollout`` — the differentiable rollout over
  the two (a ``torch.autograd.Function`` on CUDA); ``rollout_plan`` —
  their launch (sites a thread, images a CTA, the backward's records),
  checked against the library's ``kuramoto_rollout_plan`` once a shape.
* ``kuramoto_logits`` — the fused classifier (rollout + head -> logits),
  with a launch counter; on CUDA its gradient recomputes the features
  through the rollout kernels and differentiates the plain head, as the
  JAX VJP does (:516-530); ``pack_head`` lays the head out for it once,
  so that serving does not repack weights that do not change, and
  ``unpack_head`` reads a packing back; ``slice_plan`` says how the
  kernel's thread-block clusters split the head's features and where a
  CTA holds its slice's weights (the CUDA ``head_plan``, checked against
  it once a head shape).
* The plain versions: ``kuramoto_rollout_reference`` (the scan,
  differentiated by autograd), ``kuramoto_rollout_bwd_reference`` (the
  replay and the reverse walk written out as the kernel runs them) and
  ``kuramoto_logits_reference`` (the plain rollout and the head math of
  ``_head_ref``, :496-512).

Each wrapper takes its plain version for CPU tensors and launches its
kernel, or raises, for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.bsplines import bspline_basis

_KERNEL_NAME = "kuramoto"
# The fused head is built for the KANLinear default grid (grid_size 5,
# spline order 3: 12 knots) and at most 16 classes; the lattice for H*W
# <= 1024 (4 sites on each of at most 256 threads).
HEAD_KNOTS, HEAD_ORDER, MAX_CLASSES, MAX_SITES = 12, 3, 16, 1024
# The fused kernel's clusters: 8 CTAs, each holding a fixed slice of the
# features; two images rolled out at once a CTA; at most 16 clusters.
CLUSTER, HALVES, MAX_CLUSTERS, SITES_A_THREAD = 8, 2, 16, 4
LOGITS_SMEM = 232448        # dynamic shared-memory bytes a CTA may take
# The rollout pair's plan (``csrc/kuramoto.cu: roll_geo``): 1, 2 or 4
# sites a thread by the waves of CTAs an SM of SM_THREADS threads, SM_REGS
# registers (ROLL_REGS a thread) and SM_SMEM bytes (CTA_RESERVED of them a
# CTA) runs at once, at most ROLL_BLOCKS_SM; a small lattice packs up to
# ROLL_MAX_IMAGES images into a CTA of at most ROLL_PACK threads;
# ROLL_SMEM bytes of shared memory a CTA, BWD_STATIC of them the
# backward's static red[32]; the batch sums REDUCE_COLS columns a CTA.
ROLL_BLOCKS_SM, ROLL_MAX_IMAGES, ROLL_PACK = 32, 8, 256
SM_THREADS, SM_REGS, SM_SMEM, CTA_RESERVED = 2048, 65536, 233472, 1024
ROLL_SMEM, BWD_STATIC, REDUCE_COLS = 232448, 128, 32
ROLL_REGS = 64      # registers a thread: launch bounds 1024 / k, k CTAs
ROLL_FORMS = ("sincos", "theta")

class Lattice(NamedTuple):
    """The rollout's static shape: H x W sites, ``steps`` steps of ``dt``."""

    H: int
    W: int
    steps: int
    dt: float


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kuramoto_fwd.argtypes = [P] * 4 + [I] * 4 + [Fl, P]
    lib.kuramoto_bwd.argtypes = [P] * 9 + [I] * 4 + [Fl, P]
    lib.kuramoto_logits.argtypes = [P] * 8 + [I] * 4 + [Fl] + [I] * 2 + [P]
    for fn in (lib.kuramoto_fwd, lib.kuramoto_bwd, lib.kuramoto_logits):
        fn.restype = ctypes.c_int
    lib.kuramoto_logits_plan.argtypes = [I] * 3 + [P]
    lib.kuramoto_logits_plan.restype = None
    lib.kuramoto_rollout_plan.argtypes = [I] * 6 + [P]
    lib.kuramoto_rollout_plan.restype = None
    return lib


def _roll_floats(H: int, W: int, k: int, steps: int, bwd: bool,
                 form: int) -> int:
    """Shared-memory floats an image takes (``roll_floats``): the forward's
    two sin | cos buffers (at k = 4 sites a thread each lattice inside a
    zero halo); the backward's records (sin and cos of every theta_t, or
    theta_t alone) and its buffers (two of g cos | g sin, or one of sin |
    cos | g cos | g sin)."""
    if not bwd:
        return 4 * (H + 2) * (W + 2) if k == 4 else 4 * H * W
    return (2 * steps + 4) * H * W if form == 0 else (steps + 4) * H * W


def rollout_plan(B: int, H: int, W: int, steps: int, sms: int = 132,
                 bwd: bool = False) -> Dict[str, object]:
    """The rollout pair's launch at batch ``B``, an ``H`` x ``W`` lattice,
    ``steps`` Euler steps on a card of ``sms`` SMs (``csrc/kuramoto.cu:
    roll_geo``).
    ``k`` sites a thread (thread ``tl`` of an image owns the sites
    ``sites[tl]``, ``tl + j tpi`` for j < k), ``tpi`` threads an image,
    ``images`` a CTA (CTA c owns the images ``cta_images[c]``).  Of k = 1,
    2, 4 the one whose ``ctas`` the card runs in the fewest ``waves`` (the
    CTAs an SM holds by threads, registers at the kernel's launch bounds
    and shared memory), the least k of a tie: below the SM count an image
    takes a thread a site.  A small lattice packs images into CTAs of at
    most ``ROLL_PACK`` threads while the CTAs still cover the SMs.
    Backward: ``form`` ``"sincos"`` (sin and cos of every theta_t recorded
    in shared memory) where an image's fit ``ROLL_SMEM`` less
    ``BWD_STATIC`` bytes, else ``"theta"`` (theta_t alone), with fewer
    images a CTA where need be; ``ValueError`` if one image's fit
    neither.
    ``reduce_ctas``: the CTAs of the batch sums, ``REDUCE_COLS`` columns
    of [omegabar | Kbar] each."""
    HW = H * W
    if B < 1 or HW < 1 or steps < 0:
        raise ValueError(f"rollout_plan: B >= 1, H, W >= 1, steps >= 0, "
                         f"got {B}, {H}, {W}, {steps}")
    forms = (0, 1) if bwd else (None,)
    fixed = BWD_STATIC if bwd else 0
    budget = ROLL_SMEM - fixed
    best = None
    for f in forms:
        if best is not None:
            break
        for k in (1, 2, 4):
            per = 4 * _roll_floats(H, W, k, steps, bwd, f or 0)
            tpi = -(-(-(-HW // k)) // 32) * 32
            m = 1
            while (m < ROLL_MAX_IMAGES and 2 * m <= B
                   and 2 * m * tpi <= ROLL_PACK
                   and -(-B // (2 * m)) >= min(B, sms)):
                m *= 2
            while m > 1 and m * per > budget:
                m //= 2
            if per > budget:
                continue
            ctas = -(-B // m)
            held = sms * min(ROLL_BLOCKS_SM, SM_THREADS // (m * tpi),
                             SM_REGS // (m * tpi * ROLL_REGS),
                             SM_SMEM // (m * per + fixed + CTA_RESERVED))
            waves = -(-ctas // held)
            if best is None or waves < best["waves"]:
                best = dict(k=k, tpi=tpi, images=m, threads=m * tpi,
                            ctas=ctas, waves=waves,
                            form=None if f is None else ROLL_FORMS[f],
                            smem_bytes=m * per)
    if best is None:
        raise ValueError(
            f"kuramoto_bwd: an image's records of {steps} steps of {HW} "
            f"sites take {4 * _roll_floats(H, W, 1, steps, True, 0)} bytes as "
            f"sin and cos, {4 * _roll_floats(H, W, 1, steps, True, 1)} as "
            f"theta, above the {budget} bytes of a CTA's shared memory")
    m, tpi, k = best["images"], best["tpi"], best["k"]
    best.update(reduce_ctas=(HW + REDUCE_COLS) // REDUCE_COLS,
                cta_images=[range(c * m, min(B, (c + 1) * m))
                            for c in range(best["ctas"])],
                sites=[[tl + j * tpi for j in range(k) if tl + j * tpi < HW]
                       for tl in range(tpi)])
    return best


@functools.lru_cache(maxsize=None)
def _check_rollout_plan(B: int, H: int, W: int, steps: int, sms: int,
                        bwd: bool) -> Dict[str, object]:
    """``rollout_plan``'s plan, raising unless the library's is the same
    (once a shape)."""
    p = rollout_plan(B, H, W, steps, sms, bwd)
    got = (ctypes.c_longlong * 9)()
    _lib().kuramoto_rollout_plan(B, H, W, steps, sms, int(bwd),
                                 ctypes.addressof(got))
    form = -1 if p["form"] is None else ROLL_FORMS.index(p["form"])
    want = [p["k"], p["images"], p["tpi"], p["threads"], p["ctas"], form,
            p["smem_bytes"], 1, p["reduce_ctas"]]
    if list(got) != want:
        raise RuntimeError(f"kuramoto: the library's rollout plan {list(got)}"
                           f" differs from rollout_plan's {want} at B={B}, "
                           f"H={H}, W={W}, steps={steps}, sms={sms}, "
                           f"bwd={bwd}")
    return p


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def slice_plan(HW: int, C: int, n_logistic: int, B: int = 1,
               clusters_held: int = MAX_CLUSTERS) -> Dict[str, object]:
    """The fused classifier's launch for H*W = ``HW`` sites, ``C`` classes
    and ``n_logistic`` logistic terms (``csrc/kuramoto.cu: head_plan``).
    Whatever the batch, CTA r of every cluster of ``CLUSTER`` owns the
    features ``slices[r]`` (S = ceil(F / 8) each, F = 2 HW) and adds
    their head terms for every image of its cluster; ``weights`` says
    where it holds their logistic a, b and packed weights: ``"shared"``
    while they fit one CTA's shared memory beside its rollouts, else
    ``"device"`` (read through L2); their knots and the spans'
    reciprocals always in shared memory.  At batch ``B`` the launch
    takes ``clusters`` (at most 16, ceil(B / 8), and ``clusters_held``,
    the clusters the card holds at once), each ``images[q]`` in rounds of
    ``CLUSTER * HALVES``."""
    F = 2 * HW
    S = -(-F // CLUSTER)
    tpi = -(-(-(-HW // SITES_A_THREAD)) // 32) * 32
    T = 1 + (HEAD_KNOTS - 1 - HEAD_ORDER) + n_logistic
    n_rcp = sum(HEAD_KNOTS - k for k in range(1, HEAD_ORDER + 1))
    NI = CLUSTER * HALVES

    def floats(head_smem):
        return ((HEAD_KNOTS + n_rcp) * S
                + ((2 * n_logistic + C * T) * S if head_smem else 0)
                + HALVES * 2 * HW
                + NI * (tpi // 32) * MAX_CLASSES + NI * MAX_CLASSES)
    head_smem = 4 * floats(True) <= LOGITS_SMEM
    clusters = min(-(-B // CLUSTER), MAX_CLUSTERS, clusters_held)
    per = -(-B // clusters)
    clusters = -(-B // per)
    return dict(S=S, slices=[range(r * S, min(F, (r + 1) * S))
                             for r in range(CLUSTER)],
                threads=HALVES * tpi, smem_bytes=4 * floats(head_smem),
                weights="shared" if head_smem else "device",
                cluster=CLUSTER, clusters=clusters,
                images=[range(q * per, min(B, (q + 1) * per))
                        for q in range(clusters)],
                round=NI)


@functools.lru_cache(maxsize=None)
def _check_slice_plan(HW: int, C: int, n_logistic: int) -> None:
    """Raise unless the library's head plan is ``slice_plan``'s (once a
    head shape)."""
    got = (ctypes.c_longlong * 5)()
    _lib().kuramoto_logits_plan(HW, C, n_logistic, ctypes.addressof(got))
    p = slice_plan(HW, C, n_logistic)
    want = [p["S"], p["threads"], p["smem_bytes"],
            int(p["weights"] == "shared"), p["cluster"]]
    if list(got) != want:
        raise RuntimeError(f"kuramoto_logits: the library's plan {list(got)}"
                           f" differs from slice_plan's {want} at HW={HW}, "
                           f"C={C}, n_logistic={n_logistic}")


# ------------------------------------------------------------ plain versions


def neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> the 4-neighbour sums with zero boundaries, summed
    left + right + up + down."""
    xp = F.pad(x, (1, 1, 1, 1))
    return (xp[:, 1:-1, :-2] + xp[:, 1:-1, 2:]) + xp[:, :-2, 1:-1] \
        + xp[:, 2:, 1:-1]


def _step(theta, omega, K, dt):
    """One Euler step of (B, H, W) phases."""
    s, c = torch.sin(theta), torch.cos(theta)
    coup = c * neighbor_sum(s) - s * neighbor_sum(c)
    return theta + dt * (omega + K * coup)


def kuramoto_rollout_reference(omega: torch.Tensor, K: torch.Tensor,
                               theta0: torch.Tensor, lat: Lattice
                               ) -> torch.Tensor:
    """The plain rollout (the scan path of ``kuramoto_features``):
    theta0 (B, H*W) -> features (B, 2*H*W); differentiable by autograd."""
    B = theta0.shape[0]
    theta = theta0.reshape(B, lat.H, lat.W)
    for _ in range(lat.steps):
        theta = _step(theta, omega, K, lat.dt)
    theta = theta.reshape(B, -1)
    return torch.cat([torch.cos(theta), torch.sin(theta)], dim=1)


def kuramoto_rollout_bwd_reference(omega: torch.Tensor, K: torch.Tensor,
                                   theta0: torch.Tensor, ct: torch.Tensor,
                                   lat: Lattice
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The plain backward, step for step the kernel's: replay the rollout
    keeping every theta_t, then walk back with the coupling VJP.  ``ct``
    (B, 2*H*W) is the features' cotangent.  Returns (theta0bar (B, H*W),
    omegabar (H, W), Kbar ())."""
    B, HW = theta0.shape
    shape = (B, lat.H, lat.W)
    with torch.no_grad():
        theta, rec = theta0.reshape(shape), []
        for _ in range(lat.steps):
            rec.append(theta)
            theta = _step(theta, omega, K, lat.dt)
        g = (-torch.sin(theta) * ct[:, :HW].reshape(shape)
             + torch.cos(theta) * ct[:, HW:].reshape(shape))
        gom = torch.zeros_like(g)
        gk = torch.zeros(B, dtype=g.dtype, device=g.device)
        for th in reversed(rec):
            s, c = torch.sin(th), torch.cos(th)
            ss, sc = neighbor_sum(s), neighbor_sum(c)
            coup = c * ss - s * sc
            gom = gom + lat.dt * g
            gk = gk + lat.dt * (g * coup).sum((1, 2))
            tb = (c * neighbor_sum(g * c) + s * neighbor_sum(g * s)
                  - g * (c * sc + s * ss))
            g = g + (lat.dt * K) * tb
    return g.reshape(B, HW), gom.sum(0), gk.sum()


def head_reference(feat: torch.Tensor, grid: torch.Tensor, wb: torch.Tensor,
                   sw: torch.Tensor, la: Optional[torch.Tensor],
                   lb: Optional[torch.Tensor], lw: Optional[torch.Tensor],
                   spline_order: int = HEAD_ORDER) -> torch.Tensor:
    """The KANLinear head on the features (B, F): ``grid`` (F, n_knots),
    ``wb`` (C, F), ``sw`` (C, F, n_coeff) pre-scaled, ``la`` / ``lb`` (F,
    n_logistic) and ``lw`` (C, F, n_logistic) pre-scaled, or None without
    the logistic branch -> logits (B, C)."""
    B = feat.shape[0]
    y = F.silu(feat) @ wb.T
    bases = bspline_basis(feat, grid, spline_order)
    y = y + bases.reshape(B, -1) @ sw.reshape(sw.shape[0], -1).T
    if la is not None:
        phi = 2.0 * torch.sigmoid(la * (feat[..., None] - lb))
        y = y + phi.reshape(B, -1) @ lw.reshape(lw.shape[0], -1).T
    return y


def kuramoto_logits_reference(omega, K, theta0, grid, wb, sw, la, lb, lw,
                              lat: Lattice) -> torch.Tensor:
    """The plain classifier: ``kuramoto_rollout_reference``, then
    ``head_reference`` -> logits (B, C); differentiable by autograd."""
    return head_reference(kuramoto_rollout_reference(omega, K, theta0, lat),
                          grid, wb, sw, la, lb, lw)


# ------------------------------------------------------------ kernel wrappers


def _check(omega, K, theta0, lat: Lattice, name: str) -> None:
    HW = lat.H * lat.W
    if theta0.ndim != 2 or theta0.shape[1] != HW:
        raise ValueError(f"{name}: theta0 must be (B, {HW}), got "
                         f"{tuple(theta0.shape)}")
    if tuple(omega.shape) != (lat.H, lat.W) or K.numel() != 1:
        raise ValueError(f"{name}: omega must be ({lat.H}, {lat.W}) and K a "
                         f"scalar, got {tuple(omega.shape)}, "
                         f"{tuple(K.shape)}")


def _kernel_args(omega, K, theta0, lat: Lattice, name: str):
    NC.check_cuda(theta0, name)
    if lat.H * lat.W > MAX_SITES:
        raise ValueError(f"{name} kernel: at most {MAX_SITES} sites, got "
                         f"{lat.H} x {lat.W}")
    dev = theta0.device
    return dev, [NC.kernel_operand(t, dev, f"{name} operand {i}")
                 for i, t in enumerate((theta0, omega.reshape(-1),
                                        K.reshape(1)))]


def kuramoto_fwd(omega: torch.Tensor, K: torch.Tensor, theta0: torch.Tensor,
                 lat: Lattice) -> torch.Tensor:
    """The rollout of ``kuramoto_rollout_reference`` as one kernel launch on
    CUDA; the plain version for CPU tensors.  No autograd."""
    _check(omega, K, theta0, lat, "kuramoto_fwd")
    if theta0.device.type == "cpu":
        with torch.no_grad():
            return kuramoto_rollout_reference(omega, K, theta0, lat)
    dev, ops = _kernel_args(omega, K, theta0, lat, "kuramoto_fwd")
    B, HW = theta0.shape
    if B:
        _check_rollout_plan(B, lat.H, lat.W, lat.steps, _sms(dev), False)
    feat = torch.empty((B, 2 * HW), dtype=torch.float32, device=dev)
    NC.launch(_lib().kuramoto_fwd, *(NC.ptr(t) for t in ops), NC.ptr(feat),
              B, lat.H, lat.W, lat.steps, lat.dt, name="kuramoto_fwd",
              device=dev)
    kuramoto_fwd.launches += 1
    return feat


kuramoto_fwd.launches = 0


def kuramoto_bwd(omega: torch.Tensor, K: torch.Tensor, theta0: torch.Tensor,
                 ct: torch.Tensor, lat: Lattice
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The replay adjoint of ``kuramoto_rollout_bwd_reference`` on CUDA
    (the replay kernel and the batch sums over the card in a fixed order;
    ``rollout_plan`` raises for a lattice whose records fit a CTA in
    neither form); the plain version for CPU tensors.  Returns (theta0bar
    (B, H*W), omegabar (H, W), Kbar ())."""
    _check(omega, K, theta0, lat, "kuramoto_bwd")
    if tuple(ct.shape) != (theta0.shape[0], 2 * lat.H * lat.W):
        raise ValueError(f"kuramoto_bwd: ct must be (B, {2 * lat.H * lat.W})"
                         f", got {tuple(ct.shape)}")
    if theta0.device.type == "cpu":
        return kuramoto_rollout_bwd_reference(omega, K, theta0, ct, lat)
    dev, ops = _kernel_args(omega, K, theta0, lat, "kuramoto_bwd")
    ct = NC.kernel_operand(ct, dev, "kuramoto_bwd ct")
    B, HW = theta0.shape
    if B:
        _check_rollout_plan(B, lat.H, lat.W, lat.steps, _sms(dev), True)
    kw = dict(dtype=torch.float32, device=dev)
    th0bar, pom = torch.empty((B, HW), **kw), torch.empty((B, HW), **kw)
    pk, gom, gk = torch.empty(B, **kw), torch.empty(HW, **kw), \
        torch.empty(1, **kw)
    NC.launch(_lib().kuramoto_bwd, *(NC.ptr(t) for t in ops), NC.ptr(ct),
              *(NC.ptr(t) for t in (th0bar, pom, pk, gom, gk)), B, lat.H,
              lat.W, lat.steps, lat.dt, name="kuramoto_bwd", device=dev)
    kuramoto_bwd.launches += 1
    return th0bar, gom.reshape(lat.H, lat.W), gk.reshape(())


kuramoto_bwd.launches = 0


class _Rollout(torch.autograd.Function):
    """The rollout kernel with the replay-adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, omega, K, theta0, lat):
        ctx.save_for_backward(omega, K, theta0)
        ctx.lat = lat
        return kuramoto_fwd(omega, K, theta0, lat)

    @staticmethod
    def backward(ctx, ct):
        omega, K, theta0 = ctx.saved_tensors
        th0bar, gom, gk = kuramoto_bwd(omega, K, theta0, ct.contiguous(),
                                       ctx.lat)
        return gom.to(omega.dtype), gk.to(K.dtype), th0bar, None


def kuramoto_rollout(omega: torch.Tensor, K: torch.Tensor,
                     theta0: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Differentiable rollout: theta0 (B, H*W) -> features (B, 2*H*W).  On
    CUDA the forward and backward kernels; on the CPU the plain scan under
    autograd."""
    if theta0.device.type == "cpu":
        return kuramoto_rollout_reference(omega, K, theta0, lat)
    return _Rollout.apply(omega, K, theta0, lat)


def _check_head(grid, wb, sw, la, lw, F_: int) -> None:
    C = wb.shape[0]
    if tuple(grid.shape) != (F_, HEAD_KNOTS) or sw.shape[2] != \
            HEAD_KNOTS - 1 - HEAD_ORDER:
        raise ValueError(f"kuramoto_logits kernel: the head must have grid "
                         f"(F, {HEAD_KNOTS}) (grid_size 5, order 3), got grid"
                         f" {tuple(grid.shape)}, spline weight "
                         f"{tuple(sw.shape)}")
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"kuramoto_logits kernel: 1 to {MAX_CLASSES} "
                         f"classes, got {C}")
    if tuple(wb.shape) != (C, F_) or tuple(sw.shape[:2]) != (C, F_) or (
            la is not None and (la.shape[0] != F_ or lw.shape[:2] != (C, F_))):
        raise ValueError("kuramoto_logits: head weights do not match the "
                         f"features ({F_}) and classes ({C})")


class PackedHead(NamedTuple):
    """The fused kernel's head operands: knots (n_knots, F), la / lb
    (n_logistic, F) and the weights wp (C, 1 + n_coeff + n_logistic, F),
    feature-minor so that a warp reads contiguous floats."""

    knots: torch.Tensor
    la: torch.Tensor
    lb: torch.Tensor
    wp: torch.Tensor

    @property
    def n_logistic(self) -> int:
        return self.la.shape[0]

    @property
    def n_classes(self) -> int:
        return self.wp.shape[0]


def pack_head(grid, wb, sw, la, lb, lw) -> PackedHead:
    """The head operands of ``kuramoto_logits`` packed for the fused kernel
    (no autograd).  Serving packs once and passes the result to every call
    while the weights stay the same."""
    _check_head(grid, wb, sw, la, lw, grid.shape[0])
    with torch.no_grad():
        terms = [wb[:, None, :], sw.transpose(1, 2)]
        if la is not None:
            terms.append(lw.transpose(1, 2))
            la, lb = la.T, lb.T
        else:
            la = lb = grid.new_zeros((0, grid.shape[0]))
        return PackedHead(*(NC.kernel_operand(t, wb.device,
                                              "kuramoto_logits head operand")
                            for t in (grid.T, la, lb,
                                      torch.cat(terms, dim=1))))


def unpack_head(packed: PackedHead):
    """The inverse of ``pack_head``: (grid, wb, sw, la, lb, lw) as
    ``head_reference`` takes them, la / lb / lw None without the logistic
    branch."""
    n_coeff = packed.knots.shape[0] - 1 - HEAD_ORDER
    wp = packed.wp
    grid, wb = packed.knots.T, wp[:, 0]
    sw = wp[:, 1:1 + n_coeff].transpose(1, 2)
    if not packed.n_logistic:
        return grid, wb, sw, None, None, None
    return (grid, wb, sw, packed.la.T, packed.lb.T,
            wp[:, 1 + n_coeff:].transpose(1, 2))


def _fused_launch(omega, K, theta0, packed: PackedHead,
                  lat: Lattice) -> torch.Tensor:
    """One launch of the fused classifier kernel; counted on
    ``kuramoto_logits``."""
    F_ = 2 * lat.H * lat.W
    if packed.knots.shape[1] != F_:
        raise ValueError(f"kuramoto_logits: the head takes "
                         f"{packed.knots.shape[1]} features, the lattice "
                         f"gives {F_}")
    dev, ops = _kernel_args(omega, K, theta0, lat, "kuramoto_logits")
    if packed.wp.device != dev:
        raise ValueError(f"kuramoto_logits: the packed head on "
                         f"{packed.wp.device}, the phases on {dev}")
    B, C = theta0.shape[0], packed.n_classes
    _check_slice_plan(lat.H * lat.W, C, packed.n_logistic)
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    NC.launch(_lib().kuramoto_logits, *(NC.ptr(t) for t in ops + [*packed]),
              NC.ptr(out), B, lat.H, lat.W, lat.steps, lat.dt,
              packed.n_logistic, C, name="kuramoto_logits", device=dev)
    kuramoto_logits.launches += 1
    return out


class _Logits(torch.autograd.Function):
    """The fused classifier kernel; the backward recomputes the features
    through the rollout kernels and differentiates the plain head."""

    @staticmethod
    def forward(ctx, lat, packed, omega, K, theta0, grid, wb, sw, la, lb,
                lw):
        ctx.lat = lat
        ctx.save_for_backward(omega, K, theta0, grid, wb, sw, la, lb, lw)
        if packed is None:
            packed = pack_head(grid, wb, sw, la, lb, lw)
        return _fused_launch(omega, K, theta0, packed, lat)

    @staticmethod
    def backward(ctx, gout):
        omega, K, theta0, grid, *head = ctx.saved_tensors
        lattice = [t.detach().requires_grad_() for t in (omega, K, theta0)]
        head = [None if t is None else t.detach().requires_grad_()
                for t in head]
        with torch.enable_grad():
            feat = _Rollout.apply(*lattice, ctx.lat)
            y = head_reference(feat, grid, *head)
        grads = iter(torch.autograd.grad(
            y, lattice + [t for t in head if t is not None], gout))
        return (None, None, *(next(grads) for _ in lattice), None,
                *(None if t is None else next(grads) for t in head))


def kuramoto_logits(omega: torch.Tensor, K: torch.Tensor,
                    theta0: torch.Tensor, grid: torch.Tensor,
                    wb: torch.Tensor, sw: torch.Tensor,
                    la: Optional[torch.Tensor], lb: Optional[torch.Tensor],
                    lw: Optional[torch.Tensor], lat: Lattice,
                    packed: Optional[PackedHead] = None) -> torch.Tensor:
    """The whole classifier, rollout and KANLinear head, as one kernel
    launch on CUDA (differentiable: see ``_Logits``); the plain version for
    CPU tensors.  Operands as ``head_reference`` takes them; ``la``, ``lb``
    and ``lw`` are None without the logistic branch.  The knot grid gets no
    gradient.  ``packed`` is ``pack_head`` of the same head operands, made
    once while they stay the same; without it the call packs them.  On
    the CPU a given packing is what the plain version reads (through
    ``unpack_head``), as the kernel reads it."""
    _check(omega, K, theta0, lat, "kuramoto_logits")
    if theta0.device.type == "cpu":
        if packed is not None:
            grid, wb, sw, la, lb, lw = unpack_head(packed)
        return kuramoto_logits_reference(omega, K, theta0, grid, wb, sw, la,
                                         lb, lw, lat)
    return _Logits.apply(lat, packed, omega, K, theta0, grid, wb, sw, la, lb,
                         lw)


kuramoto_logits.launches = 0


def theta0_of(x_img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Images (B, H, W) or (B, 1, H, W) in [0, 1] -> initial phases
    pi (2x - 1), (B, H*W)."""
    if x_img.ndim == 4:
        x_img = x_img[:, 0]
    return (math.pi * (2.0 * x_img - 1.0)).reshape(x_img.shape[0], H * W)
