"""Kuramoto-oscillator image front-end and KAN classifier (the MNIST
workload; counterpart of ``fetode_tpu/models/kuramoto.py``).

Each pixel is an oscillator with phase ``theta = pi (2x - 1)``; a
4-neighbour lattice couples the phases through

    dtheta/dt = omega + K (cos theta sum sin theta_n
                           - sin theta sum cos theta_n)

integrated with ``steps`` Euler steps of size ``dt``.  The features are
``[cos theta, sin theta]`` flattened, classified by one ``KANLinear`` with
the logistic branch.  The parameters are an ``nn.Module``
(``KuramotoKAN``) named as the JAX dict keys: ``K``, ``omega`` and
``head``.

Rollout dispatch (``KuramotoSpec.rollout``): ``"pallas"``, and ``"auto"``
on a CUDA tensor, take the rollout kernels of ``ops/kuramoto.py``
(``kuramoto_rollout``) and the plain head; ``"pallas_fused"`` takes the
fused classifier kernel in ``kuramoto_kan_apply`` and the rollout kernels
in ``kuramoto_features``; ``"auto"`` on the CPU and ``"scan"`` take the
plain rollout (``kuramoto_rollout_reference``).  ``"pallas"`` and
``"pallas_fused"`` raise for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from fetode_tpu_torch.nn.kan import (
    KANLinear,
    KANLinearConfig,
    _scaled_spline_weight,
    kan_linear_apply,
    kan_linear_init,
)
from fetode_tpu_torch.ops import kuramoto as KO

ROLLOUTS = ("scan", "pallas", "pallas_fused", "auto")


class KuramotoSpec(NamedTuple):
    H: int = 28
    W: int = 28
    steps: int = 10
    dt: float = 0.15
    num_classes: int = 10
    num_basis: int = 8
    grid_size: int = 5
    # "auto" (the kernels on CUDA, the scan on the CPU), "scan" (the plain
    # rollout), "pallas" (the rollout kernels of ops/kuramoto.py) or
    # "pallas_fused" (the fused rollout + head kernel in kuramoto_kan_apply)
    rollout: str = "auto"

    @property
    def head_cfg(self) -> KANLinearConfig:
        return KANLinearConfig(2 * self.H * self.W, self.num_classes,
                               grid_size=self.grid_size,
                               logistic_num_basis=self.num_basis)

    @property
    def lattice(self) -> KO.Lattice:
        return KO.Lattice(self.H, self.W, self.steps, self.dt)


class KuramotoKAN(nn.Module):
    """The coupling ``K`` (a scalar), the natural frequencies ``omega`` (H,
    W) and the ``head`` KANLinear(2 H W -> num_classes): ``head`` if given,
    else an uninitialised skeleton for ``load_state_dict``."""

    def __init__(self, spec: KuramotoSpec, *, head: KANLinear | None = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.K = nn.Parameter(torch.full((), 0.5, **kw))
        self.omega = nn.Parameter(torch.zeros((spec.H, spec.W), **kw))
        self.head = KANLinear(spec.head_cfg, **kw) if head is None else head


def kuramoto_init(generator: torch.Generator, spec: KuramotoSpec, *,
                  device=None, dtype=torch.float32) -> KuramotoKAN:
    """K = 0.5, omega = 0 and a freshly initialised head."""
    return KuramotoKAN(spec, head=kan_linear_init(
        generator, spec.head_cfg, device=device, dtype=dtype),
        device=device, dtype=dtype)


def _uses_kernel(spec: KuramotoSpec, x: torch.Tensor) -> bool:
    if spec.rollout not in ROLLOUTS:
        # A typo must not silently run the scan.
        raise ValueError(f"KuramotoSpec.rollout={spec.rollout!r}: expected "
                         "'scan', 'pallas', 'pallas_fused' or 'auto'")
    if spec.rollout in ("pallas", "pallas_fused") and x.device.type != "cuda":
        raise ValueError(f"rollout={spec.rollout!r} is the CUDA kernels and "
                         f"takes CUDA tensors, got one on {x.device}; use "
                         "'auto' or 'scan' for the plain rollout")
    return spec.rollout != "scan" and x.device.type == "cuda"


def kuramoto_features(params: KuramotoKAN, spec: KuramotoSpec,
                      x_img: torch.Tensor) -> torch.Tensor:
    """x_img (B, H, W) or (B, 1, H, W) in [0, 1] -> (B, 2 H W) features."""
    kernel = _uses_kernel(spec, x_img)
    theta0 = KO.theta0_of(x_img, spec.H, spec.W)
    rollout = KO.kuramoto_rollout if kernel else KO.kuramoto_rollout_reference
    return rollout(params.omega, params.K, theta0, spec.lattice)


def head_operands(head: KANLinear):
    """The head as the fused kernel takes it: (grid, base weight, scaled
    spline weight, logistic a, b and scaled weight (C, F, n_logistic)),
    the last three None without the logistic branch."""
    cfg = head.cfg
    sw = _scaled_spline_weight(head)
    if not cfg.logistic_num_basis:
        return head.grid, head.base_weight, sw, None, None, None
    lg = head.logistic
    lw = lg.weight * cfg.scale_logistic
    if cfg.standalone_logistic_scaler:
        lw = lw * lg.scaler[:, None]
    lw = lw.reshape(cfg.out_features, cfg.in_features, cfg.logistic_num_basis)
    return head.grid, head.base_weight, sw, lg.a, lg.b, lw


def packed_head(head: KANLinear) -> KO.PackedHead:
    """The head's current weights packed for the fused kernel
    (``ops/kuramoto.py: pack_head``), no autograd.  A packing is a copy:
    a caller that packs once (serving) keeps it only while the weights
    stay as they were."""
    with torch.no_grad():
        return KO.pack_head(*head_operands(head))


def kuramoto_kan_apply(params: KuramotoKAN, spec: KuramotoSpec,
                       x_img: torch.Tensor,
                       packed: KO.PackedHead | None = None) -> torch.Tensor:
    """The classifier: features -> KANLinear logits (B, num_classes).
    ``rollout="pallas_fused"`` runs rollout and head in one kernel, its
    gradient through the rollout kernels and the plain head.  ``packed``
    is ``packed_head(params.head)``, made by the caller while the weights
    stay the same (the serving function packs once); without it a call
    packs the head's current weights."""
    if spec.rollout == "pallas_fused" and _uses_kernel(spec, x_img):
        theta0 = KO.theta0_of(x_img, spec.H, spec.W)
        return KO.kuramoto_logits(params.omega, params.K, theta0,
                                  *head_operands(params.head), spec.lattice,
                                  packed=packed)
    feat = kuramoto_features(params, spec, x_img)
    logits, _ = kan_linear_apply(params.head, feat)
    return logits
