"""Differentiable whole-solve KANFET NODE: the discrete adjoint on the
frozen step mesh, as two CUDA kernels.

Counterpart of ``fetode_tpu/ops/pallas_adjoint.py: make_train_solver``
(the TPU kernels ``_make_fwd_kernel`` :195 and ``_make_bwd_kernel``
:478).  The CUDA source is ``fetode_tpu_torch/csrc/kanfet_adjoint.cu``;
its header comment gives the kernels' design and what bounds them.

Gradients are exact for the realised discrete map holding the step mesh
fixed: the recorded t, dt and accept decisions are constants, and the
step-size controller is not differentiated.

* ``kanfet_solve_train`` — the public solve, ``(B, T, D)`` trajectories
  that autograd differentiates.  For CUDA tensors a
  ``torch.autograd.Function`` launches ``kanfet_adjoint_fwd`` (which
  records every attempt) and, in its backward, ``kanfet_adjoint_bwd``
  (the reverse replay).  For CPU tensors it returns
  ``kanfet_solve_train_reference``; it never falls back from a CUDA
  tensor.
* ``kanfet_adjoint_fwd`` / ``kanfet_adjoint_bwd`` — the two kernel
  wrappers, each with a launch counter (``.launches``).
* The plain version: ``record_attempts_reference`` (the per-row eager
  solve that also returns the records, in the kernel's layout) and
  ``replay_reference`` (a differentiable eager replay of recorded
  attempts; ``replay_vjp_reference`` is its autograd);
  ``kanfet_solve_train_reference`` chains the two.  The replay
  recomputes every stage from the parameters, so autograd of it is an
  oracle independent of the kernel's hand-written VJP.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.nn.kan import KAN, KANConfig, kan_apply, kan_state_init
from fetode_tpu_torch.ops.kanfet_node import (
    WARPS,
    _check_cuda,
    _check_inputs,
    _check_stack,
    ts_stride,
    _dims_tensor,
    _geo_ints,
    _pack_for,
    _warp_scratch,
    check_layout,
    stack_geometry,
)
from fetode_tpu_torch.solvers.dopri5 import (
    _dense_coeffs,
    _dense_eval,
    odeint_dopri5,
)
from fetode_tpu_torch.solvers.rk_common import rk_stage_loop
from fetode_tpu_torch.solvers.tableaux import DOPRI5

_KERNEL_NAME = "kanfet_adjoint"


class AttemptRecords(NamedTuple):
    """Every dopri5 attempt of a batch of trajectories.

    rec: (max_steps, 3 + 8D, B) — per attempt m and trajectory b: t, dt,
      the accepted flag (0/1), the state y (D) and the stages k1..k7
      (7D).  Attempts m >= n_att[b] hold no data.
    n_att: (B,) int32 — attempts each trajectory made.
    t_end: (B,) — the time each trajectory reached.
    """

    rec: torch.Tensor
    n_att: torch.Tensor
    t_end: torch.Tensor


def record_width(D: int) -> int:
    return 3 + 8 * D


def _field(params: KAN, cfg: KANConfig, B: int, like: torch.Tensor):
    state = kan_state_init((B,), cfg, device=like.device, dtype=like.dtype)

    # The plain spline product (not B.12) on every device: the plain
    # versions built on this field are what the kernels are held against.
    def rhs(t, z):
        return kan_apply(params, z, state, plain=True)[0]
    return rhs


def record_attempts_reference(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                              ts: torch.Tensor, *, rtol: float = 1e-7,
                              atol: float = 1e-9, max_steps: int = 256
                              ) -> Tuple[torch.Tensor, AttemptRecords]:
    """Plain version of ``kanfet_adjoint_fwd``: the per-row while solve of
    ``kanfet_solve_reference`` -> ``((B, T, D) output, records)``, the
    records in the kernel's layout (zeros past each row's attempts)."""
    D = _check_stack(cfg)
    _check_inputs(x0s, ts, D)
    B = x0s.shape[0]
    rec = torch.zeros((max_steps, record_width(D), B), dtype=x0s.dtype,
                      device=x0s.device)
    n_att = torch.zeros(B, dtype=torch.int32, device=x0s.device)
    t_end = ts[..., 0].to(x0s.dtype).expand(B).clone()

    def record(m, active, t, dt, adv, y, ks):
        row = torch.cat([t[:, None], dt[:, None], adv[:, None].to(y.dtype),
                         y] + list(ks), dim=1)             # (B, 3 + 8D)
        rec[m] = torch.where(active[:, None], row, 0.0).T
        n_att.add_(active.to(n_att.dtype))
        t_end.copy_(torch.where(adv, t + dt, t_end))

    with torch.no_grad():
        out = odeint_dopri5(_field(params, cfg, B, x0s), x0s, ts, rtol=rtol,
                            atol=atol, max_steps=max_steps, mode="while",
                            per_row=True, record=record)
    return out, AttemptRecords(rec, n_att, t_end)


def replay_reference(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                     ts: torch.Tensor, records: AttemptRecords
                     ) -> torch.Tensor:
    """Differentiable eager replay of recorded attempts: the solve of
    ``x0s`` on the recorded mesh, t, dt and accept held constant, every
    stage recomputed from the parameters -> ``(B, T, D)``.  Autograd of it
    is the frozen-mesh gradient (the oracle of
    ``tests/test_pallas_adjoint.py: _replay_loss``).  Works in the dtype of
    ``x0s``."""
    D = _check_stack(cfg)
    _check_inputs(x0s, ts, D)
    B, T = x0s.shape[0], ts.shape[-1]
    rec = records.rec.to(x0s.dtype)
    n_att = records.n_att
    t_end = records.t_end.to(x0s.dtype)
    ts = ts.to(x0s.dtype).expand(B, T)
    tiny = torch.tensor(1e-12, dtype=x0s.dtype, device=x0s.device)
    rhs = _field(params, cfg, B, x0s)
    y = x0s
    out = x0s[:, None, :].expand(B, T, D)
    for m in range(int(n_att.max()) if B else 0):
        # Past a row's own attempts: a no-op attempt (dt = 0, rejected),
        # so no unrecorded value enters the arithmetic.
        valid = m < n_att
        t = torch.where(valid, rec[m, 0], t_end)
        dt = torch.where(valid, rec[m, 1], 0.0)
        adv = valid & (rec[m, 2] > 0.5)
        dt_safe = torch.where(dt == 0.0, 1.0, dt)
        y1, _, ks = rk_stage_loop(rhs, t[:, None], y, dt[:, None], DOPRI5)
        dy, r3, r4, r5 = _dense_coeffs(y, y1, ks, dt[:, None])
        theta = torch.clamp((ts - t[:, None]) / dt_safe[:, None], 0.0, 1.0)
        write = (adv[:, None] & (ts > t[:, None])
                 & (ts <= (t + dt + tiny)[:, None]))
        out = torch.where(write[..., None],
                          _dense_eval(y, dy, r3, r4, r5, theta), out)
        y = torch.where(adv[:, None], y1, y)
    unreached = ts > (t_end + tiny)[:, None]
    return torch.where(unreached[..., None], y[:, None, :], out)


def replay_vjp_reference(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                         ts: torch.Tensor, records: AttemptRecords,
                         ybar: torch.Tensor
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain version of ``kanfet_adjoint_bwd``: autograd of
    ``replay_reference`` with the output cotangent ``ybar`` -> (gradients
    aligned with ``train_weights(params)``, x0bar)."""
    weights = train_weights(params)
    x0 = x0s.detach().requires_grad_(True)
    with torch.enable_grad():
        out = replay_reference(params, cfg, x0, ts, records)
        *grads, x0bar = torch.autograd.grad(out, weights + [x0], ybar)
    return grads, x0bar


def kanfet_solve_train_reference(params: KAN, cfg: KANConfig,
                                 x0s: torch.Tensor, ts: torch.Tensor, *,
                                 rtol: float = 1e-7, atol: float = 1e-9,
                                 max_steps: int = 256) -> torch.Tensor:
    """Plain version of ``kanfet_solve_train``: record the mesh with the
    eager while solve, then replay it under autograd."""
    _, records = record_attempts_reference(params, cfg, x0s, ts, rtol=rtol,
                                           atol=atol, max_steps=max_steps)
    return replay_reference(params, cfg, x0s, ts, records)


# ------------------------------------------------------------ parameters


def train_weights(params: KAN) -> List[torch.Tensor]:
    """The trainable tensors the kernels give gradients for, layer by
    layer: base_weight, spline_weight, spline_scaler (when standalone),
    then the ferro k, ec, ps, bias, coef.  The knot grid is a buffer."""
    out = []
    for layer in params.layers:
        out += [layer.base_weight, layer.spline_weight]
        if layer.cfg.standalone_spline_scaler:
            out.append(layer.spline_scaler)
        fe = layer.ferro
        out += [fe.k, fe.ec, fe.ps, fe.bias, fe.coef]
    return out


def n_grad(cfg: KANConfig) -> int:
    """Length of the kernel's gradient vector: the packed parameters
    without the knot grids."""
    return sum(c.out_features * c.in_features * (1 + c.n_coeff)
               + 5 * c.in_features * c.out_features * c.ferro_num_basis
               for c in cfg.layers)


def unflatten_grads(params: KAN, flat: torch.Tensor) -> List[torch.Tensor]:
    """The kernel's gradient vector (per layer: base_weight, the scaled
    spline weight, the five flat ferro arrays) -> gradients aligned with
    ``train_weights``, chaining through the spline_scaler fusion
    ``sw * scaler``: g_sw = g_sw3 * scaler, g_scaler = sum(g_sw3 * sw)
    (``pallas_adjoint.py: _unflatten_grads``)."""
    out, i = [], 0
    for layer in params.layers:
        c = layer.cfg
        N = c.in_features * c.out_features * c.ferro_num_basis
        sizes = [c.out_features * c.in_features,
                 c.out_features * c.in_features * c.n_coeff] + [N] * 5
        g_bw, g_sw2, *g_fe = torch.split(flat[i:i + sum(sizes)], sizes)
        i += sum(sizes)
        g_sw3 = g_sw2.reshape(c.out_features, c.in_features, c.n_coeff)
        out.append(g_bw.reshape(c.out_features, c.in_features))
        if c.standalone_spline_scaler:
            out += [g_sw3 * layer.spline_scaler.detach()[..., None],
                    (g_sw3 * layer.spline_weight.detach()).sum(-1)]
        else:
            out.append(g_sw3)
        shape3 = (c.in_features, c.out_features, c.ferro_num_basis)
        out += [g.reshape(shape3) for g in g_fe]
    return out


# --------------------------------------------------------------- kernels


def _launchers():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    G = ctypes.POINTER(I)
    fwd, bwd = lib.kanfet_adjoint_fwd, lib.kanfet_adjoint_bwd
    fwd.argtypes = [P] * 9 + [G] + [I] * 4 + [F] * 5 + [P]
    bwd.argtypes = [P] * 11 + [G] + [I] * 3 + [F] * 3 + [P]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _launch_fwd(packed, geo, x0s, ts, rtol, atol, max_steps):
    B, T, D = x0s.shape[0], ts.shape[-1], geo["D"]
    dev = x0s.device
    check_layout(_KERNEL_NAME, geo)
    dims = _dims_tensor(geo, dev)
    scratch = _warp_scratch(geo, "fwd", B, dev)
    out = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    rec = torch.empty((max_steps, record_width(D), B), dtype=torch.float32,
                      device=dev)
    n_att = torch.empty(B, dtype=torch.int32, device=dev)
    t_end = torch.empty(B, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launchers()[0](
        x0s.data_ptr(), ts.data_ptr(), packed.data_ptr(), dims.data_ptr(),
        out.data_ptr(), rec.data_ptr(), n_att.data_ptr(), t_end.data_ptr(),
        scratch.data_ptr(), _geo_ints(geo, "fwd"), B, T, ts_stride(ts),
        int(max_steps), float(rtol), float(atol), geo["gate"], geo["alpha"],
        1.0 - geo["alpha"], stream)
    if rc != 0:
        raise RuntimeError(f"kanfet_adjoint_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    kanfet_adjoint_fwd.launches += 1
    return out, AttemptRecords(rec, n_att, t_end)


def grad_rows(geo: dict, B: int) -> int:
    """Rows of the backward's (rows, n_grad) partial-sum array: one per
    block when the warps' gradient vectors sit in shared memory (no
    per-trajectory scratch), else one per warp."""
    blocks = -(-B // WARPS)
    return blocks if geo["bwd"]["grads"] else blocks * WARPS


def _launch_bwd(packed, geo, ts, records, ybar):
    rec, n_att, t_end = records
    B, T, D = rec.shape[-1], ts.shape[-1], geo["D"]
    if ts.ndim == 2 and ts.shape[0] != B:
        raise ValueError(f"ts must be (T,) or ({B}, T), got "
                         f"{tuple(ts.shape)}")
    if ybar.shape != (B, T, D):
        raise ValueError(f"ybar must be {(B, T, D)}, got {tuple(ybar.shape)}")
    if (rec.ndim != 3 or rec.shape[1] != record_width(D)
            or n_att.shape != (B,) or t_end.shape != (B,)):
        raise ValueError("records do not match the batch and state size")
    if (rec.dtype, n_att.dtype, t_end.dtype) != (torch.float32, torch.int32,
                                                  torch.float32):
        raise TypeError("kanfet_adjoint_bwd takes the forward kernel's "
                        "records: float32 rec and t_end, int32 n_att")
    if {rec.device, n_att.device, t_end.device, ybar.device} != {ts.device}:
        raise ValueError("records, ybar and ts must be on one device")
    if not (rec.is_contiguous() and n_att.is_contiguous()
            and t_end.is_contiguous()):
        raise ValueError("kanfet_adjoint_bwd takes contiguous records")
    dev = ts.device
    ybar = ybar.to(torch.float32).contiguous()
    n_g = geo["n_grad"]
    check_layout(_KERNEL_NAME, geo)
    dims = _dims_tensor(geo, dev)
    scratch = _warp_scratch(geo, "bwd", B, dev)
    part = torch.empty((grad_rows(geo, B), n_g), dtype=torch.float32,
                       device=dev)
    grads = torch.empty(n_g, dtype=torch.float32, device=dev)
    x0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launchers()[1](
        ts.data_ptr(), ybar.data_ptr(), rec.data_ptr(), n_att.data_ptr(),
        t_end.data_ptr(), packed.data_ptr(), dims.data_ptr(), part.data_ptr(),
        scratch.data_ptr(), grads.data_ptr(), x0bar.data_ptr(),
        _geo_ints(geo, "bwd"), B, T, ts_stride(ts), geo["gate"],
        geo["alpha"], 1.0 - geo["alpha"], stream)
    if rc != 0:
        raise RuntimeError(f"kanfet_adjoint_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    kanfet_adjoint_bwd.launches += 1
    return grads, x0bar


def kanfet_adjoint_fwd(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                       ts: torch.Tensor, *, rtol: float = 1e-7,
                       atol: float = 1e-9, max_steps: int = 256
                       ) -> Tuple[torch.Tensor, AttemptRecords]:
    """The forward kernel: ``((B, T, D) output, records)``, no autograd.
    A CPU tensor gets ``record_attempts_reference``."""
    D = _check_stack(cfg)
    _check_inputs(x0s, ts, D)
    if x0s.device.type == "cpu":
        return record_attempts_reference(params, cfg, x0s, ts, rtol=rtol,
                                         atol=atol, max_steps=max_steps)
    _check_cuda(x0s, ts, "kanfet_adjoint_fwd")
    geo = stack_geometry(cfg)
    return _launch_fwd(_pack_for(params, cfg, geo, x0s.device), geo, x0s, ts,
                       rtol, atol, max_steps)


def kanfet_adjoint_bwd(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                       ts: torch.Tensor, records: AttemptRecords,
                       ybar: torch.Tensor
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reverse-replay kernel: the cotangent ``ybar`` (B, T, D) of the
    output -> (gradients aligned with ``train_weights(params)``, x0bar
    (B, D)).  The kernel reads the recorded states and does not need
    ``x0s``; a CPU tensor gets ``replay_vjp_reference``, which does."""
    D = _check_stack(cfg)
    _check_inputs(x0s, ts, D)
    if x0s.device.type == "cpu":
        return replay_vjp_reference(params, cfg, x0s, ts, records, ybar)
    _check_cuda(x0s, ts, "kanfet_adjoint_bwd")
    geo = stack_geometry(cfg)
    flat, x0bar = _launch_bwd(_pack_for(params, cfg, geo, x0s.device), geo, ts,
                              records, ybar)
    return unflatten_grads(params, flat), x0bar


kanfet_adjoint_fwd.launches = 0
kanfet_adjoint_bwd.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel.
    Inputs: the module and its config (no gradient), x0s, ts (no
    gradient), then ``train_weights(params)``.  The weights are saved
    too, so autograd refuses a backward after they changed in place (the
    gradient map reads the spline weights and scalers)."""

    @staticmethod
    def forward(ctx, params, cfg, geo, opts, x0s, ts, *weights):
        packed = _pack_for(params, cfg, geo, x0s.device)
        out, records = _launch_fwd(packed, geo, x0s, ts, *opts)
        ctx.params, ctx.geo = params, geo
        ctx.save_for_backward(packed, ts, *records, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ybar):
        packed, ts, rec, n_att, t_end, *_ = ctx.saved_tensors
        flat, x0bar = _launch_bwd(packed, ctx.geo, ts,
                                  AttemptRecords(rec, n_att, t_end), ybar)
        grads = unflatten_grads(ctx.params, flat)
        need = ctx.needs_input_grad
        grads = [g if need[6 + i] else None for i, g in enumerate(grads)]
        return (None, None, None, None, x0bar if need[4] else None, None,
                *grads)


def kanfet_solve_train(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                       ts: torch.Tensor, *, rtol: float = 1e-7,
                       atol: float = 1e-9, max_steps: int = 256
                       ) -> torch.Tensor:
    """Solve the autonomous KANFET NODE for a batch of initial conditions,
    differentiably: ``(B, D)`` float32 ``x0s``, ``(T,)`` or ``(B, T)``
    float32 ``ts`` (a row of times a trajectory) -> ``(B, T, D)`` — the
    forward of ``kanfet_solve``.  Autograd gives the
    gradients of every trainable parameter of ``params`` (none for the knot
    grid) and of ``x0s`` when it requires grad; none for ``ts``."""
    D = _check_stack(cfg)
    _check_inputs(x0s, ts, D)
    if x0s.dtype != torch.float32 or ts.dtype != torch.float32:
        raise TypeError(f"kanfet_solve_train takes float32 x0s and ts, got "
                        f"{x0s.dtype} and {ts.dtype}")
    if x0s.device.type == "cpu":
        return kanfet_solve_train_reference(params, cfg, x0s, ts, rtol=rtol,
                                            atol=atol, max_steps=max_steps)
    _check_cuda(x0s, ts, "kanfet_solve_train")
    geo = stack_geometry(cfg)
    return _SolveTrain.apply(params, cfg, geo, (rtol, atol, max_steps), x0s,
                             ts, *train_weights(params))


def kanfet_solve_train_sharded(params: KAN, cfg: KANConfig,
                               x0s: torch.Tensor, ts: torch.Tensor, mesh, *,
                               axis: str = "data", rtol: float = 1e-7,
                               atol: float = 1e-9, max_steps: int = 256
                               ) -> torch.Tensor:
    """``kanfet_solve_train`` over a mesh (counterpart of
    ``pallas_kanfet_solve_train_sharded``): every rank takes the global
    ``x0s`` (and ``ts``), solves its block of rows over ``axis`` (B.2 on
    the card, each trajectory with its own step control, so the result is
    the single-device one) and returns the global ``(B, T, D)`` output.
    Under autograd the parameters' gradients are summed over the ranks
    (``parallel.shard_map_rows``).  ``x0s``' batch must divide the axis
    size.  A ``(B, T)`` ``ts`` is sharded with ``x0s``."""
    from fetode_tpu_torch.parallel.collectives import shard_map_rows

    opts = dict(rtol=rtol, atol=atol, max_steps=max_steps)
    if ts.ndim == 2:
        return shard_map_rows(
            lambda p, x, t: kanfet_solve_train(p, cfg, x, t, **opts),
            mesh, params, x0s, ts, axis=axis)
    return shard_map_rows(
        lambda p, x: kanfet_solve_train(p, cfg, x, ts, **opts),
        mesh, params, x0s, axis=axis)
