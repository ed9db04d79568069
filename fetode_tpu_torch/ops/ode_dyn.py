"""Whole-solve trajectory of the forecasters' latent ODE field: dopri5
over [ts[0], ts[-1]] with batch-shared step control, CONTD5 dense output
at every requested time, and its discrete adjoint, as two CUDA kernels.

Counterpart of ``fetode_tpu/ops/pallas_ode_dyn.py: make_ode_dyn_solver``
(the TPU kernels ``_make_fwd_kernel`` :50 and ``_make_bwd_kernel`` :78).
The CUDA source is ``fetode_tpu_torch/csrc/ode_dyn.cu`` on the scaffold
``csrc/node_common.cuh`` (its trajectory pair under the row policy: one
thread-block cluster, each CTA owning a tile of batch rows); its header
gives the design and what bounds it.  The field is ``ODEDynamicsConfig``'s MLP
``[D+1, H, H, D]`` with tanh hidden layers, on ``[z, t]``:

    dz/dt = W2 tanh(W1 tanh(W0 [z, t] + b0) + b1) + b2

* ``ode_dyn_solve`` — the public solve of the MLP's layers (an
  ``nn.ModuleList`` of ``Dense``).  On CUDA, under autograd, a
  ``torch.autograd.Function`` launches ``ode_dyn_fwd`` (which records
  every attempt) and, in its backward, ``ode_dyn_bwd``; without
  autograd the forward kernel alone, recording nothing.  On the CPU it
  takes the plain version.
* ``row_plan`` — how a launch cuts the batch into the cluster's row
  tiles and where each CTA keeps its data (the CUDA ``make_geo``,
  checked against it once a shape).
* ``ode_dyn_fwd`` / ``ode_dyn_bwd`` — the kernel wrappers, each with a
  launch counter (``.launches``).  For CPU tensors they take the plain
  versions ``record_solve_traj_reference`` and
  ``replay_traj_vjp_reference`` of ``ops/node_common.py`` around
  ``ode_dyn_field``; they never fall back from a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.solvers.dopri5 import _under_autograd

_KERNEL_NAME = "ode_dyn"

MAX_CLUSTER = 16            # CTAs, the non-portable cluster size
ROW_THREADS = 512           # threads a CTA
TILE_SLOTS = 5              # gradient tiles a thread holds in registers
OUTS_A_LANE = 2             # outputs a lane of a VJP product holds
SMEM_BUDGET = 232448 - 2048  # dynamic shared-memory bytes a CTA may take


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _row_stride(k: int) -> int:
    s = _round4(k)
    while s % 32 != 4:
        s += 4
    return s


def row_plan(B: int, D: int, H: int, bwd: bool = False) -> Dict[str, object]:
    """The kernels' launch at batch B and widths D, H (``csrc/ode_dyn.cu:
    make_geo``): ``C`` CTAs of one cluster, CTA c owning the rows
    ``rows[c]`` (R = ceil(B / 16) each, the last the rest); the bytes of
    shared memory a CTA takes; whether the rows and the padded weights
    sit there (else in device memory the CTA owns); the device scratch
    floats; and the gradient tiles (4 x 4, ``TILE_SLOTS`` a thread in
    registers)."""
    if B < 1:
        raise ValueError(f"row_plan: B must be >= 1, got {B}")
    R = -(-B // MAX_CLUSTER)
    C = -(-B // R)
    K0, Q1, H4, D4 = _round4(D + 2), _round4(H + 1), _round4(H), _round4(D)
    rec = K0 + 2 * Q1 + ((D4 + 2 * H4) if bwd else 0)
    w = H4 * _row_stride(K0) + H4 * _row_stride(Q1) + D4 * _row_stride(Q1) \
        + 2 * H4 + D4
    p = 4 * max(H, D, ROW_THREADS // 32 * 32 * OUTS_A_LANE) if bwd else 0
    rows = _round4((10 if bwd else 9) * R * D) + R * rec
    budget = SMEM_BUDGET // 4
    rows_smem = w + p + rows <= budget
    w_smem = rows_smem or w + p <= budget
    qh, ph = -(-(H + 1) // 4), -(-H // 4)
    tiles = -(-D // 4) * qh + ph * qh + ph * (-(-(D + 2) // 4))
    smem = p + (w if w_smem else 0) + (rows if rows_smem else 0)
    work = C * ((0 if w_smem else w) + (0 if rows_smem else rows)
                + (16 * tiles if bwd else 0))
    return dict(C=C, R=R, rows=[range(c * R, min(B, (c + 1) * R))
                                for c in range(C)],
                smem_bytes=4 * smem, rows_smem=rows_smem, weights_smem=w_smem,
                work_floats=work, tiles=tiles, threads=ROW_THREADS,
                tile_slots=TILE_SLOTS)


def layer_weights(layers) -> List[torch.Tensor]:
    """The field MLP's tensors in kernel order: W0, b0, W1, b1, W2, b2."""
    return [t for layer in layers for t in (layer.w, layer.b)]


def ode_dyn_field(w0, b0, w1, b1, w2, b2) -> NC.TrajField:
    """The field as a callable ``field(t, z)`` on (B, D)
    (``models/forecasting.py: ode_dynamics_apply``), the first layer's
    weight split into its state block and time column as the kernel
    takes it (``pallas_ode_dyn.py:61-69``)."""
    D = w2.shape[0]
    w0z, w0t = w0[:, :D], w0[:, D]

    def field(t, z):
        h = torch.tanh(z @ w0z.T + t * w0t + b0)
        h = torch.tanh(h @ w1.T + b1)
        return h @ w2.T + b2
    return field


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ode_dyn_fwd.argtypes = [P] * 14 + [I] * 5 + [F] * 2 + [I, P]
    lib.ode_dyn_bwd.argtypes = [P] * 20 + [I] * 4 + [P]
    lib.ode_dyn_fwd.restype = lib.ode_dyn_bwd.restype = ctypes.c_int
    lib.ode_dyn_work_floats.argtypes = [I] * 3
    lib.ode_dyn_work_floats.restype = ctypes.c_longlong
    lib.ode_dyn_plan.argtypes = [I] * 4 + [P]
    lib.ode_dyn_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _check_plan(B: int, D: int, H: int) -> None:
    """Raise unless the library's plan is ``row_plan``'s, forward and
    backward (once a shape)."""
    for bwd in (False, True):
        got = (ctypes.c_longlong * 9)()
        _lib().ode_dyn_plan(B, D, H, int(bwd), ctypes.addressof(got))
        p = row_plan(B, D, H, bwd)
        want = [p["C"], p["R"], p["smem_bytes"], int(p["rows_smem"]),
                int(p["weights_smem"]), p["work_floats"], p["tiles"],
                p["threads"], p["tile_slots"]]
        if list(got) != want:
            raise RuntimeError(f"ode_dyn: the library's plan {list(got)} at "
                               f"B={B}, D={D}, H={H}, bwd={bwd} is not "
                               f"row_plan's {want}")


def _check_shapes(weights: Sequence[torch.Tensor], z0: torch.Tensor,
                  ts: torch.Tensor, name: str) -> None:
    if len(weights) != 6:
        raise ValueError(f"{name}: the kernel takes the [D+1, H, H, D] field "
                         f"MLP (6 tensors), got {len(weights)}")
    w0, b0, w1, b1, w2, b2 = weights
    H, D = w1.shape[0], w2.shape[0]
    NC.check_state(z0, D, name)
    if (w0.shape != (H, D + 1) or b0.shape != (H,) or w1.shape != (H, H)
            or b1.shape != (H,) or w2.shape != (D, H) or b2.shape != (D,)):
        raise ValueError(f"{name}: expected W0 (H, D+1), W1 (H, H), W2 "
                         f"(D, H) and their biases, with D = {D}, H = {H}")
    if ts.ndim != 1 or ts.shape[0] < 1:
        raise ValueError(f"{name}: ts must be (T,) with T >= 1")


def _operands(weights, z0, ts, name) -> List[torch.Tensor]:
    """The kernels' float32 operands (the six weights, then ts), checked."""
    _check_shapes(weights, z0, ts, name)
    return [NC.kernel_operand(t, z0.device, f"{name} operand {i}")
            for i, t in enumerate(list(weights) + [ts])]


def _work(B, D, H, device):
    _check_plan(B, D, H)
    n = _lib().ode_dyn_work_floats(B, D, H)
    return torch.empty(n, dtype=torch.float32, device=device)


def _launch_fwd(ops, z0, rtol, atol, max_steps, record):
    *w, ts = ops
    B, D = z0.shape
    H, T = w[2].shape[0], ts.shape[0]
    dev = z0.device
    z0 = z0.detach().contiguous()
    out = torch.empty((T, B, D), dtype=torch.float32, device=dev)
    recs = NC.new_records(max_steps, B, D, dev) if record else None
    r = recs if record else (None,) * 4
    NC.launch(_lib().ode_dyn_fwd, NC.ptr(z0), NC.ptr(ts),
              *(NC.ptr(t) for t in w), NC.ptr(out), *(NC.ptr(t) for t in r),
              NC.ptr(_work(B, D, H, dev)), B, D, H, T, int(max_steps),
              float(rtol), float(atol), int(record),
              name="ode_dyn_fwd", device=dev)
    ode_dyn_fwd.launches += 1
    return out, recs


def _launch_bwd(ops, records, ct):
    *w, ts = ops
    T, B, D = ct.shape
    H = w[2].shape[0]
    dev = ct.device
    NC.check_records(records, B, D, dev, "ode_dyn_bwd")
    ct = ct.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in w]
    z0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    NC.launch(_lib().ode_dyn_bwd, NC.ptr(ct), NC.ptr(ts),
              *(NC.ptr(t) for t in records), *(NC.ptr(t) for t in w),
              *(NC.ptr(g) for g in grads), NC.ptr(z0bar),
              NC.ptr(_work(B, D, H, dev)), B, D, H, T,
              name="ode_dyn_bwd", device=dev)
    ode_dyn_bwd.launches += 1
    return grads, z0bar


def ode_dyn_fwd(weights: Sequence[torch.Tensor], z0: torch.Tensor,
                ts: torch.Tensor, *, rtol: float = 1e-3, atol: float = 1e-4,
                max_steps: int = 32, record: bool = True
                ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel: ``(trajectory (T, B, D), records or None)``,
    no autograd.  ``weights`` = (W0, b0, W1, b1, W2, b2).  A CPU tensor
    gets ``record_solve_traj_reference``."""
    if z0.device.type == "cpu":
        _check_shapes(weights, z0, ts, "ode_dyn_fwd")
        traj, recs = NC.record_solve_traj_reference(
            ode_dyn_field(*weights), z0, ts, rtol=rtol, atol=atol,
            max_steps=max_steps)
        return traj, recs if record else None
    NC.check_cuda(z0, "ode_dyn_fwd")
    ops = _operands(weights, z0, ts, "ode_dyn_fwd")
    return _launch_fwd(ops, z0, rtol, atol, max_steps, record)


def ode_dyn_bwd(weights: Sequence[torch.Tensor], z0: torch.Tensor,
                ts: torch.Tensor, records: NC.SolveRecords, ct: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reverse-replay kernel: the trajectory's cotangent ``ct`` (T, B,
    D) -> (gradients of W0, b0, W1, b1, W2, b2; z0bar).  The kernel reads
    the recorded states and does not need ``z0``; a CPU tensor gets
    ``replay_traj_vjp_reference``, which does."""
    if z0.device.type == "cpu":
        _check_shapes(weights, z0, ts, "ode_dyn_bwd")
        return NC.replay_traj_vjp_reference(ode_dyn_field(*weights), weights,
                                            z0, ts, records, ct)
    NC.check_cuda(z0, "ode_dyn_bwd")
    ops = _operands(weights, z0, ts, "ode_dyn_bwd")
    return _launch_bwd(ops, records, ct)


ode_dyn_fwd.launches = 0
ode_dyn_bwd.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel.
    The parameters are saved as given, so autograd refuses a backward
    after they changed in place."""

    @staticmethod
    def forward(ctx, opts, z0, ts, *weights):
        ops = _operands(weights, z0, ts, "ode_dyn_solve")
        out, recs = _launch_fwd(ops, z0, *opts, record=True)
        ctx.save_for_backward(*ops, *recs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        saved = ctx.saved_tensors
        grads, z0bar = _launch_bwd(saved[:7], NC.SolveRecords(*saved[7:]),
                                   ct)
        need = ctx.needs_input_grad
        return (None, z0bar if need[1] else None, None,
                *(g if need[3 + i] else None for i, g in enumerate(grads)))


def ode_dyn_solve(layers, z0: torch.Tensor, ts: torch.Tensor, *,
                  rtol: float = 1e-3, atol: float = 1e-4,
                  max_steps: int = 32) -> torch.Tensor:
    """Solve the latent ODE of the field MLP ``layers`` from ``z0`` (B, D)
    -> the trajectory (T, B, D) at ``ts``.  Autograd gives the gradients
    of the layers' tensors and of ``z0`` (not of ``ts``): on CUDA through
    the kernel pair, on the CPU through the plain replay."""
    w = layer_weights(layers)
    opts = dict(rtol=rtol, atol=atol, max_steps=max_steps)
    grad = _under_autograd(z0, *w)
    if z0.device.type == "cpu":
        _check_shapes(w, z0, ts, "ode_dyn_solve")
        field = ode_dyn_field(*w)
        if grad:
            return NC.solve_traj_reference(field, z0, ts, **opts)
        return NC.record_solve_traj_reference(field, z0, ts, **opts)[0]
    NC.check_cuda(z0, "ode_dyn_solve")
    if grad:
        return _SolveTrain.apply((rtol, atol, max_steps), z0, ts, *w)
    return ode_dyn_fwd(w, z0, ts, record=False, **opts)[0]
