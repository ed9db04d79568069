"""Whole-solve of the conditional-diffusion node encoder's latent ODE:
dopri5 over [0, 1] with batch-shared step control, the past signal
interpolated inside the field, and its discrete adjoint, as two CUDA
kernels.

Counterpart of ``fetode_tpu/ops/pallas_node_enc.py: make_node_enc_solver``
(the TPU kernels ``_make_fwd_kernel`` :75 and ``_make_bwd_kernel`` :95).
The CUDA source is ``fetode_tpu_torch/csrc/node_enc.cu`` on the scaffold
``csrc/node_common.cuh`` (its trajectory pair at the output times [0, 1]
under the row policy: each CTA of one thread-block cluster, or of a
cooperative grid past 64 rows, owning a tile of batch rows; only z(1) is
returned) and B.7's products
(``csrc/row_products.cuh``); its header gives the design and what bounds
it.
The field, with the first layer's weight (H, C+P) split into its LN(z)
block ``w1z`` (H, C) and its x(t) block ``w1x`` (H, P):

    x(t) = x_seq[:, i0] + w (x_seq[:, i0 + 1] - x_seq[:, i0])
    dz/dt = W3 silu(W2 silu(w1z LN(z) + w1x x(t) + b1) + b2) + b3

with ``tf = clip(t, 0, 1) (L - 1)``, ``i0 = clip(floor(tf), 0, L - 2)``,
``w = tf - i0`` (``pallas_node_enc.py:56-64``; ``ops/interp.py:
linear_interp`` on ``linspace(0, 1, L)``).

* ``node_enc_solve(params, cfg, z0, x_seq)`` — z(1) of the encoder module
  ``params`` (``models/cond_diffusion.py: NodeEncoder``).  On CUDA, under
  autograd, a ``torch.autograd.Function`` launches ``node_enc_fwd``
  (which records every attempt) and, in its backward, ``node_enc_bwd``,
  which returns the gradients of the nine field / LN tensors, of ``z0``
  and of ``x_seq``; without autograd the forward kernel alone, recording
  nothing.  On the CPU it takes the plain version.
* ``row_plan`` — how a launch cuts the batch into row tiles (one
  cluster, or past 64 rows a cooperative grid of CTAs) and where each
  CTA keeps the weights and its rows (the CUDA ``make_geo``, checked
  against it once a shape).
* ``node_enc_fwd`` / ``node_enc_bwd`` — the kernel wrappers, each with a
  launch counter (``.launches``).  For CPU tensors they take the plain
  versions ``record_solve_traj_reference`` and
  ``replay_traj_vjp_reference`` of ``ops/node_common.py`` around
  ``node_enc_field``; they never fall back from a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.nn.mlp import layer_norm
from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.solvers.dopri5 import _under_autograd

_KERNEL_NAME = "node_enc"
N_WEIGHTS = 9
MAX_CLUSTER = 16            # CTAs, the non-portable cluster size
CLUSTER_ROWS = 4            # rows a CTA owns, at most, in the cluster form
MAX_GRID = 128              # CTAs of the grid form, at most
FWD_CHUNKS = 2              # chunks of the forward's x(t) product
ROW_THREADS = 512           # threads a CTA
TILE_SLOTS = 5              # gradient tiles a thread holds in registers
SMEM_BUDGET = 232448 - 2048  # dynamic shared-memory bytes a CTA may take
PART_FLOATS = 2 * 2 * 1024  # the grid form's error-norm partials


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def row_plan(B: int, C: int, P: int, H: int,
             bwd: bool = False) -> Dict[str, object]:
    """The kernels' launch at batch B and widths C (the state), P (the
    signal) and H (the hidden layers) (``csrc/node_enc.cu: make_geo``).
    Up to 16 x 4 rows, one cluster of ``G`` <= 16 CTAs, R = ceil(B / 16)
    rows each; past them (``grid``), a cooperative grid of G = ceil(B / R)
    CTAs, R = max(4, ceil(B / 128)).  CTA g owns the rows ``rows[g]``.
    The placement: w1z, W2 and the biases (``weights_smem``), W3
    (``w3_smem``) and the rows (the scaffold's state and stages and the
    row records of ``record_floats`` each; ``rows_smem``) in each CTA's
    shared memory, the first of: all three; W3 in device memory;
    everything in device memory.  w1x and its
    transpose are always the CTA's padded copies in device memory
    (``wx_floats`` each).  ``work_floats`` is the device scratch,
    ``tiles`` the 4 x 4 gradient tiles (``TILE_SLOTS`` a thread in
    registers, the rest in the CTA's partial array)."""
    if B < 1:
        raise ValueError(f"row_plan: B must be >= 1, got {B}")
    grid = B > MAX_CLUSTER * CLUSTER_ROWS
    R = max(CLUSTER_ROWS, -(-B // MAX_GRID)) if grid else -(-B // MAX_CLUSTER)
    G = -(-B // R)
    C4, P4, H4, Q = _round(C, 4), _round(P, 4), _round(H, 4), _round(H + 1, 4)
    SC, SH = _round(C, 32), _round(H, 32)
    rec = C4 + _round(P + 1, 4) + 2 * Q + (4 * H4 + 3 * C4 if bwd else 0) + 4
    w = H4 * SC + H4 * SH + 2 * H4 + 3 * C4
    w3 = C4 * SH
    wx = H4 * P4
    p = 4 * max(C, P, H, ROW_THREADS // 32 * 32 * 2) if bwd \
        else 4 * FWD_CHUNKS * H4
    rows = _round((10 if bwd else 9) * R * C, 4) + R * rec
    tiles = (-(-C // 4) + -(-H // 4)) * -(-(H + 1) // 4) \
        + -(-H // 4) * -(-(C4 + P + 1) // 4)
    mine = 16 * tiles + 2 * C4 if bwd else 0
    budget = SMEM_BUDGET // 4
    w_smem = w3_smem = rows_smem = True
    if w + w3 + p + rows > budget:
        w3_smem = False
        if w + p + rows > budget:
            w_smem = rows_smem = False
    smem = p + (w if w_smem else 0) + (w3 if w3_smem else 0) \
        + (rows if rows_smem else 0)
    work = G * (2 * wx + (0 if w_smem else w) + (0 if w3_smem else w3)
                + (0 if rows_smem else rows) + mine) \
        + (PART_FLOATS if grid else 0)
    return dict(G=G, R=R, grid=grid,
                rows=[range(g * R, min(B, (g + 1) * R)) for g in range(G)],
                smem_bytes=4 * smem, rows_smem=rows_smem, weights_smem=w_smem,
                w3_smem=w3_smem, work_floats=work, tiles=tiles,
                threads=ROW_THREADS, tile_slots=TILE_SLOTS,
                record_floats=rec, wx_floats=wx)


def field_weights(params) -> List[torch.Tensor]:
    """The encoder's field / LN tensors in kernel order: ln_scale, ln_bias,
    w1z, w1x, b1, W2, b2, W3, b3 (``pallas_node_enc.py:146-156``); w1z
    and w1x are views of the first layer's weight."""
    l1, l2, l3 = params.field
    C = params.ln_scale.shape[0]
    return [params.ln_scale, params.ln_bias, l1.w[:, :C], l1.w[:, C:], l1.b,
            l2.w, l2.b, l3.w, l3.b]


def signal_rows(t, L: int) -> Tuple[int, torch.Tensor]:
    """The first of the two signal rows that bracket ``t`` and the lerp
    weight, in float32 as the kernel takes them."""
    tf = torch.as_tensor(t, dtype=torch.float32).clamp(0.0, 1.0) * (L - 1)
    i0 = int(torch.floor(tf).clamp(0, L - 2))
    return i0, tf - i0


def node_enc_field(weights: Sequence[torch.Tensor],
                   x_seq: torch.Tensor) -> NC.TrajField:
    """The field as a callable ``field(t, z)`` on (B, C), closing over the
    nine tensors and the projected past signal ``x_seq`` (B, L, P)."""
    lns, lnb, w1z, w1x, b1, w2, b2, w3, b3 = weights
    L = x_seq.shape[1]

    def field(t, z):
        i0, w = signal_rows(t, L)
        x0, x1 = x_seq[:, i0], x_seq[:, i0 + 1]
        xt = x0 + w.to(x_seq.dtype) * (x1 - x0)
        zn = layer_norm(z, lns, lnb)
        h = F.silu(zn @ w1z.T + xt @ w1x.T + b1)
        h = F.silu(h @ w2.T + b2)
        return h @ w3.T + b3
    return field


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.node_enc_fwd.argtypes = [P] * 18 + [I] * 6 + [F_] * 2 + [I, P]
    lib.node_enc_bwd.argtypes = [P] * 28 + [I] * 5 + [P]
    lib.node_enc_fwd.restype = lib.node_enc_bwd.restype = ctypes.c_int
    lib.node_enc_work_floats.argtypes = [I] * 4
    lib.node_enc_work_floats.restype = ctypes.c_longlong
    lib.node_enc_plan.argtypes = [I] * 5 + [P]
    lib.node_enc_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _check_plan(B: int, C: int, P: int, H: int) -> None:
    """Raise unless the library's plan is ``row_plan``'s, forward and
    backward (once a shape)."""
    for bwd in (False, True):
        got = (ctypes.c_longlong * 13)()
        _lib().node_enc_plan(B, C, P, H, int(bwd), ctypes.addressof(got))
        p = row_plan(B, C, P, H, bwd)
        want = [p["G"], p["R"], p["smem_bytes"], int(p["rows_smem"]),
                int(p["weights_smem"]), p["work_floats"], p["tiles"],
                p["threads"], p["tile_slots"], p["record_floats"],
                p["wx_floats"], int(p["w3_smem"]), int(p["grid"])]
        if list(got) != want:
            raise RuntimeError(f"node_enc: the library's plan {list(got)} at "
                               f"B={B}, C={C}, P={P}, H={H}, bwd={bwd} is not "
                               f"row_plan's {want}")


@functools.lru_cache(maxsize=None)
def _ts(device: torch.device) -> torch.Tensor:
    """The output times [0, 1] on ``device``."""
    return torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)


def _check_shapes(weights: Sequence[torch.Tensor], z0: torch.Tensor,
                  x_seq: torch.Tensor, name: str) -> None:
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"{name}: the kernel takes the field / LN tensors "
                         f"({N_WEIGHTS}), got {len(weights)}")
    lns, lnb, w1z, w1x, b1, w2, b2, w3, b3 = weights
    C, H = lns.shape[0], w2.shape[0]
    NC.check_state(z0, C, name)
    if x_seq.ndim != 3 or x_seq.shape[0] != z0.shape[0] or x_seq.shape[1] < 2:
        raise ValueError(f"{name}: x_seq must be (B, L, P) with the state's "
                         f"B and L >= 2, got {tuple(x_seq.shape)}")
    P = x_seq.shape[2]
    want = [(C,), (C,), (H, C), (H, P), (H,), (H, H), (H,), (C, H), (C,)]
    if [tuple(w.shape) for w in weights] != want:
        raise ValueError(f"{name}: expected ln_scale, ln_bias (C), w1z (H, "
                         f"C), w1x (H, P), b1, W2 (H, H), b2, W3 (C, H), b3 "
                         f"with C = {C}, P = {P}, H = {H}")


def _operands(weights, z0, x_seq, name) -> List[torch.Tensor]:
    """The kernels' float32 operands (the nine tensors, then the signal
    table (L*B, P): row block l*B..l*B+B is x(t_l)), checked."""
    _check_shapes(weights, z0, x_seq, name)
    ops = [NC.kernel_operand(t, z0.device, f"{name} operand {i}")
           for i, t in enumerate(weights)]
    xs = NC.kernel_operand(x_seq, z0.device, f"{name} x_seq")
    return ops + [xs.transpose(0, 1).reshape(-1, xs.shape[2]).contiguous()]


def _work(B, C, P, H, device):
    _check_plan(B, C, P, H)
    n = _lib().node_enc_work_floats(B, C, P, H)
    return torch.empty(n, dtype=torch.float32, device=device)


def _launch_fwd(ops, z0, rtol, atol, max_steps, record):
    *w, table = ops
    B, C = z0.shape
    P, H = table.shape[1], w[5].shape[0]
    L = table.shape[0] // B
    dev = z0.device
    z0 = z0.detach().contiguous()
    out = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    recs = NC.new_records(max_steps, B, C, dev) if record else None
    r = recs if record else (None,) * 4
    NC.launch(_lib().node_enc_fwd, NC.ptr(z0), NC.ptr(table),
              NC.ptr(_ts(dev)), *(NC.ptr(t) for t in w), NC.ptr(out),
              *(NC.ptr(t) for t in r), NC.ptr(_work(B, C, P, H, dev)),
              B, C, P, H, L, int(max_steps), float(rtol), float(atol),
              int(record), name="node_enc_fwd", device=dev)
    node_enc_fwd.launches += 1
    return out[1], recs


def _launch_bwd(ops, records, ct):
    *w, table = ops
    B, C = ct.shape
    P, H = table.shape[1], w[5].shape[0]
    L = table.shape[0] // B
    dev = ct.device
    NC.check_records(records, B, C, dev, "node_enc_bwd")
    ybar = torch.zeros((2, B, C), dtype=torch.float32, device=dev)
    ybar[1] = ct.detach()
    grads = [torch.empty_like(t) for t in w]
    g_table = torch.empty_like(table)
    z0bar = torch.empty((B, C), dtype=torch.float32, device=dev)
    NC.launch(_lib().node_enc_bwd, NC.ptr(ybar), NC.ptr(_ts(dev)),
              *(NC.ptr(t) for t in records), NC.ptr(table),
              *(NC.ptr(t) for t in w), *(NC.ptr(g) for g in grads),
              NC.ptr(g_table), NC.ptr(z0bar),
              NC.ptr(_work(B, C, P, H, dev)), B, C, P, H, L,
              name="node_enc_bwd", device=dev)
    node_enc_bwd.launches += 1
    return grads, z0bar, g_table.reshape(L, B, P).transpose(0, 1)


def node_enc_fwd(weights: Sequence[torch.Tensor], z0: torch.Tensor,
                 x_seq: torch.Tensor, *, rtol: float = 1e-3,
                 atol: float = 1e-4, max_steps: int = 24,
                 record: bool = True
                 ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel: ``(z(1) (B, C), records or None)``, no
    autograd.  ``weights`` = the nine tensors of ``field_weights``; a CPU
    tensor gets ``record_solve_traj_reference``."""
    if z0.device.type == "cpu":
        _check_shapes(weights, z0, x_seq, "node_enc_fwd")
        traj, recs = NC.record_solve_traj_reference(
            node_enc_field(weights, x_seq), z0, _ts(z0.device), rtol=rtol,
            atol=atol, max_steps=max_steps)
        return traj[1], recs if record else None
    NC.check_cuda(z0, "node_enc_fwd")
    ops = _operands(weights, z0, x_seq, "node_enc_fwd")
    return _launch_fwd(ops, z0, rtol, atol, max_steps, record)


def node_enc_bwd(weights: Sequence[torch.Tensor], z0: torch.Tensor,
                 x_seq: torch.Tensor, records: NC.SolveRecords,
                 ct: torch.Tensor
                 ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The reverse-replay kernel: z(1)'s cotangent ``ct`` (B, C) -> (the
    nine tensors' gradients, z0bar, the x_seq cotangent (B, L, P)).  The
    kernel reads the recorded states and does not need ``z0``; a CPU
    tensor gets ``replay_traj_vjp_reference``, which does."""
    if z0.device.type == "cpu":
        _check_shapes(weights, z0, x_seq, "node_enc_bwd")
        leaves = [t.detach().requires_grad_(True)
                  for t in list(weights) + [x_seq]]
        ybar = torch.stack([torch.zeros_like(ct), ct])
        grads, z0bar = NC.replay_traj_vjp_reference(
            node_enc_field(leaves[:-1], leaves[-1]), leaves, z0,
            _ts(z0.device), records, ybar)
        return grads[:-1], z0bar, grads[-1]
    NC.check_cuda(z0, "node_enc_bwd")
    ops = _operands(weights, z0, x_seq, "node_enc_bwd")
    return _launch_bwd(ops, records, ct)


node_enc_fwd.launches = 0
node_enc_bwd.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel.
    The tensors are saved as given, so autograd refuses a backward after
    they changed in place."""

    @staticmethod
    def forward(ctx, opts, z0, x_seq, *weights):
        ops = _operands(weights, z0, x_seq, "node_enc_solve")
        out, recs = _launch_fwd(ops, z0, *opts, record=True)
        ctx.save_for_backward(*ops, *recs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        saved = ctx.saved_tensors
        n = N_WEIGHTS + 1
        grads, z0bar, xbar = _launch_bwd(saved[:n],
                                         NC.SolveRecords(*saved[n:]), ct)
        need = ctx.needs_input_grad
        return (None, z0bar if need[1] else None, xbar if need[2] else None,
                *(g if need[3 + i] else None for i, g in enumerate(grads)))


def node_enc_solve(params, cfg, z0: torch.Tensor,
                   x_seq: torch.Tensor) -> torch.Tensor:
    """z(1) (B, C) of the node encoder's latent ODE from ``z0`` (B, C)
    with the projected past signal ``x_seq`` (B, L, P); ``params`` is
    the encoder module, ``cfg`` its ``NodeEncoderCfg`` (rtol, atol,
    max_steps).  Autograd gives the gradients of the field / LN tensors,
    of ``z0`` and of ``x_seq``: on CUDA through the kernel pair, on the
    CPU through the plain replay."""
    w = field_weights(params)
    opts = dict(rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps)
    grad = _under_autograd(z0, x_seq, *w)
    if z0.device.type == "cpu":
        _check_shapes(w, z0, x_seq, "node_enc_solve")
        field = node_enc_field(w, x_seq)
        if grad:
            return NC.solve_traj_reference(field, z0, _ts(z0.device),
                                           **opts)[1]
        return NC.record_solve_traj_reference(field, z0, _ts(z0.device),
                                              **opts)[0][1]
    NC.check_cuda(z0, "node_enc_solve")
    if grad:
        return _SolveTrain.apply((cfg.rtol, cfg.atol, cfg.max_steps), z0,
                                 x_seq, *w)
    return node_enc_fwd(w, z0, x_seq, record=False, **opts)[0]
