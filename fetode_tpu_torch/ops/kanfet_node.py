"""Whole-solve KANFET NODE: a full adaptive dopri5 integration of a KANFET
vector field in one CUDA kernel launch, per-trajectory step control.

Counterpart of ``fetode_tpu/ops/pallas_node.py: pallas_kanfet_solve``
(the TPU kernel ``_make_kernel`` :125 with its field ``_field_factory``
:67).  The CUDA source is ``fetode_tpu_torch/csrc/kanfet_node.cu``; its
header comment gives the kernel's design and what bounds it on the card.

* ``kanfet_solve`` — the wrapper: validates, packs the parameters, and
  launches the kernel on the current CUDA stream for CUDA tensors.  For
  CPU tensors it returns ``kanfet_solve_reference``; it never falls back
  from a CUDA tensor.  ``kanfet_solve.launches`` counts kernel launches.
* ``kanfet_solve_reference`` — the plain eager twin: the per-row dopri5
  of ``solvers/dopri5.py`` around ``kan_apply`` with a fresh frozen
  hysteresis state.
* ``pack_params`` — the parameter layout the kernel reads
  (``pallas_node.py:302-318``).

Forward only: the result carries no gradient.  The differentiable solve
is ``ops/kanfet_adjoint.py: kanfet_solve_train``, which shares this
kernel's solve (``csrc/kanfet_field.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from fetode_tpu_torch.nn.kan import KAN, KANConfig, kan_apply, kan_state_init
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5

# Shapes the kernel is compiled for, as (state dim D, spline order, knots
# per feature); csrc/kanfet_node.cu instantiates one template for each.
# The hidden width H and ferro basis count K are runtime values, bounded
# by the shared memory the packed parameters and output times take.
KERNEL_SHAPES = frozenset({(2, 3, 12)})
SMEM_LIMIT_BYTES = 48 * 1024

_KERNEL_NAME = "kanfet_node"


def _check_stack(cfg: KANConfig) -> int:
    """The KANFET contract of ``pallas_kanfet_solve``; returns D."""
    cfgs = cfg.layers
    if any(c.ferro_num_basis == 0 or c.logistic_num_basis > 0 for c in cfgs):
        raise ValueError("kanfet_solve supports pure KANFET stacks "
                         "(ferro branch on, logistic off) only")
    D = cfgs[0].in_features
    if cfgs[-1].out_features != D:
        raise ValueError("NODE field must map D -> D")
    return D


def _check_inputs(x0s: torch.Tensor, ts: torch.Tensor, D: int) -> None:
    if x0s.ndim != 2 or x0s.shape[1] != D or x0s.shape[0] == 0:
        raise ValueError(f"x0s must be (B, {D}) with B >= 1, got "
                         f"{tuple(x0s.shape)}")
    if ts.ndim != 1 or ts.shape[0] == 0:
        raise ValueError(f"ts must be (T,) with T >= 1, got {tuple(ts.shape)}")
    if ts.device != x0s.device:
        raise ValueError(f"x0s on {x0s.device} but ts on {ts.device}")


def kanfet_solve_reference(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                           ts: torch.Tensor, *, rtol: float = 1e-7,
                           atol: float = 1e-9,
                           max_steps: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``(B, D)`` initial conditions
    -> ``(B, T, D)`` trajectories, each row with its own step control —
    the contract of ``vmap(predict)`` in while mode.  Works in the dtype
    of ``x0s`` (the kernel is float32 only)."""
    D = _check_stack(cfg)
    _check_inputs(x0s, ts, D)
    state = kan_state_init((x0s.shape[0],), cfg, device=x0s.device,
                           dtype=x0s.dtype)

    # The plain spline product (not B.12) on every device: this is the
    # version the kernel is held against and timed beside.
    def rhs(t, z):
        return kan_apply(params, z, state, plain=True)[0]

    return odeint_dopri5(rhs, x0s, ts, rtol=rtol, atol=atol,
                         max_steps=max_steps, mode="while", per_row=True)


def pack_params(params: KAN, cfg: KANConfig) -> torch.Tensor:
    """All layers' parameters as one float32 vector, per layer in the
    order base_weight (out, in), spline_weight pre-scaled by
    spline_scaler and reshaped to (out, in*C), grid (in, n_knots), then
    the ferro k, ec, ps, bias, coef each flattened in (i, o, k) row-major
    order."""
    parts = []
    with torch.no_grad():
        for layer, c in zip(params.layers, cfg.layers):
            sw = layer.spline_weight
            if c.standalone_spline_scaler:
                sw = sw * layer.spline_scaler[..., None]
            fe = layer.ferro
            parts += [layer.base_weight, sw.reshape(c.out_features, -1),
                      layer.grid, fe.k, fe.ec, fe.ps, fe.bias, fe.coef]
        return torch.cat([p.reshape(-1).to(torch.float32) for p in parts])


def _kernel_geometry(cfg: KANConfig, T: int) -> dict:
    """Check that the stack fits the compiled kernel; raise ValueError if
    not (a stack the kernel cannot take is never routed elsewhere)."""
    cfgs = cfg.layers
    if len(cfgs) != 2:
        raise ValueError(f"the kanfet_node kernel takes two-layer [D, H, D] "
                         f"stacks, got {len(cfgs)} layers")
    l1, l2 = cfgs
    D, H, K = l1.in_features, l1.out_features, l1.ferro_num_basis
    n_knots = l1.grid_size + 2 * l1.spline_order + 1
    if (l2.ferro_num_basis, l2.grid_size, l2.spline_order) != \
            (K, l1.grid_size, l1.spline_order):
        raise ValueError("the kanfet_node kernel needs the same ferro basis "
                         "count, grid size and spline order in both layers")
    if (l2.ferro_gate_slope, l2.ferro_alpha) != (l1.ferro_gate_slope,
                                                 l1.ferro_alpha):
        raise ValueError("the kanfet_node kernel needs one ferro gate slope "
                         "and alpha across layers")
    if (D, l1.spline_order, n_knots) not in KERNEL_SHAPES:
        raise ValueError(
            f"the kanfet_node kernel is compiled for (D, spline_order, "
            f"n_knots) in {sorted(KERNEL_SHAPES)}, got "
            f"{(D, l1.spline_order, n_knots)}")
    C = n_knots - 1 - l1.spline_order
    n_params = 2 * (H * D) + 2 * (H * D * C) + (D + H) * n_knots \
        + 5 * 2 * (D * H * K)
    smem = 4 * (n_params + T)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"parameters plus output times take {smem} bytes of "
                         f"shared memory, beyond the kernel's bound of "
                         f"{SMEM_LIMIT_BYTES} (H={H}, K={K}, T={T})")
    return dict(D=D, H=H, K=K, order=l1.spline_order, n_knots=n_knots,
                n_params=n_params, gate=float(l1.ferro_gate_slope),
                alpha=float(l1.ferro_alpha))


def _check_cuda(x0s: torch.Tensor, ts: torch.Tensor, name: str) -> None:
    """What a kernel takes: float32, contiguous, on CUDA."""
    if x0s.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA (or CPU, through its "
                         f"reference), got a tensor on {x0s.device}")
    if x0s.dtype != torch.float32 or ts.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 x0s and ts, got {x0s.dtype} "
                        f"and {ts.dtype}")
    if not (x0s.is_contiguous() and ts.is_contiguous()):
        raise ValueError(f"{name} takes contiguous x0s and ts")


def _pack_for(params: KAN, cfg: KANConfig, geo: dict,
              device: torch.device) -> torch.Tensor:
    """``pack_params``, checked against the kernel's geometry and device."""
    packed = pack_params(params, cfg)
    if packed.device != device:
        raise ValueError(f"parameters on {packed.device} but x0s on {device}")
    if packed.numel() != geo["n_params"]:    # the kernel reads n_params floats
        raise RuntimeError(f"packed {packed.numel()} parameters, the kernel "
                           f"expects {geo['n_params']}")
    return packed


def _launcher():
    from fetode_tpu_torch.ops._build import load_library

    fn = load_library(_KERNEL_NAME).kanfet_node_solve
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, F, F, F, F, F, P]
    fn.restype = ctypes.c_int
    return fn


def kanfet_solve(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                 ts: torch.Tensor, *, rtol: float = 1e-7, atol: float = 1e-9,
                 max_steps: int = 512) -> torch.Tensor:
    """Solve the autonomous KANFET NODE for a batch of initial conditions.

    Args:
      params/cfg: a ``KAN`` whose every layer has the ferro branch and no
        logistic branch (the KANFET contract), and its config.
      x0s: (B, D) float32 initial conditions; ts: (T,) float32 output
        times, ts[0] the start (any order after it: every accepted step
        tests all T times).

    Returns:
      (B, T, D) trajectories — the contract of
      ``vmap(lambda x0: predict(params, spec, x0, ts))`` in while mode.
      ``max_steps`` counts attempts, accepted and rejected; a trajectory
      that runs out holds its last state at every later output time.
    """
    D = _check_stack(cfg)
    _check_inputs(x0s, ts, D)
    if x0s.dtype != torch.float32 or ts.dtype != torch.float32:
        raise TypeError(f"kanfet_solve takes float32 x0s and ts, got "
                        f"{x0s.dtype} and {ts.dtype}")
    if x0s.device.type == "cpu":
        return kanfet_solve_reference(params, cfg, x0s, ts, rtol=rtol,
                                      atol=atol, max_steps=max_steps)
    _check_cuda(x0s, ts, "kanfet_solve")
    B, T = x0s.shape[0], ts.shape[0]
    geo = _kernel_geometry(cfg, T)
    packed = _pack_for(params, cfg, geo, x0s.device)
    out = torch.empty((B, T, D), dtype=torch.float32, device=x0s.device)
    stream = torch.cuda.current_stream(x0s.device).cuda_stream
    rc = _launcher()(
        x0s.data_ptr(), ts.data_ptr(), packed.data_ptr(), out.data_ptr(),
        B, T, D, geo["H"], geo["K"], geo["order"], geo["n_knots"],
        int(max_steps), float(rtol), float(atol), geo["gate"], geo["alpha"],
        1.0 - geo["alpha"], stream)
    if rc != 0:
        raise RuntimeError(f"kanfet_node kernel launch failed: CUDA error "
                           f"{rc}")
    kanfet_solve.launches += 1
    return out


kanfet_solve.launches = 0
