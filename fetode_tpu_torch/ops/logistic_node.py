"""Whole-solve ECG KanFetNODE 'plain' latent field: dopri5 over [0, 1]
with batch-shared step control and its discrete adjoint, as two CUDA
kernels.

Counterpart of ``fetode_tpu/ops/pallas_logistic_node.py:
make_logistic_node_solver`` (the TPU kernels ``_make_fwd_kernel`` :39 and
``_make_bwd_kernel`` :58).  The CUDA source is
``fetode_tpu_torch/csrc/logistic_node.cu`` on the shared scaffold
``csrc/node_common.cuh`` (its final-state pair under the row policy: one
thread-block cluster, or past ``GRID_PAST`` rows a cooperative grid, each
CTA owning a tile of batch rows and holding the parameters); its header
gives the design and what bounds it.  The field, with the mixer
parameters a, b of shape (D, K), L = D*K:

    phi = sigmoid(2 * sigmoid(a * (h - b)))    flattened to (B, L)
    dh  = phi @ proj_w^T + proj_b              proj_w (D, L)

* ``logistic_node_solve`` — the public solve of the model's parameters.
  On CUDA, under autograd, a ``torch.autograd.Function`` launches
  ``logistic_node_fwd`` (which records every attempt) and, in its
  backward, ``logistic_node_bwd``; without autograd the forward kernel
  alone, recording nothing.  On the CPU it takes the plain version.
* ``row_plan`` — how a launch cuts the batch into row tiles, where each
  CTA keeps the parameters, its rows and the backward's deferred gW
  records (the CUDA ``make_geo``, checked against it once a shape).
* ``logistic_node_fwd`` / ``logistic_node_bwd`` — the kernel wrappers,
  each with a launch counter (``.launches``).  For CPU tensors they take
  the plain versions ``record_solve_reference`` and
  ``replay_vjp_reference`` of ``ops/node_common.py`` around
  ``logistic_field``; they never fall back from a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.logistic import LogisticParams, logistic_basis
from fetode_tpu_torch.solvers.dopri5 import _under_autograd

_KERNEL_NAME = "logistic_node"

MAX_CLUSTER = 16             # CTAs, the non-portable cluster size
CLUSTER_ROWS = 4             # rows a CTA owns, at most, in the cluster form
MAX_GRID = 128               # CTAs of the grid form, at most
ROW_THREADS = 512            # threads a CTA
ROW_WARPS = ROW_THREADS // 32
GROUP_ROWS = 4               # rows of a pass, at most
CHUNK = 128                  # (VJP, row) records a stage of the gW pass
PART_FLOATS = 2 * 2 * 1024   # node_common.cuh's kPartFloats
SMEM_BUDGET = 232448 - 2048  # dynamic shared-memory bytes a CTA may take
# The largest batch one cluster takes; past it a cooperative grid of
# CLUSTER_ROWS-row CTAs (a tool may move it to time the other form).
GRID_PAST = MAX_CLUSTER * CLUSTER_ROWS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def row_plan(B: int, D: int, K: int, M: int = 16, bwd: bool = False,
             grid_past: int | None = None) -> Dict[str, object]:
    """The kernels' launch at batch B, widths D, K and a record of M
    attempts (``csrc/logistic_node.cu: make_geo``).  Up to ``grid_past``
    (``GRID_PAST``) rows one cluster of ``C`` <= 16 CTAs, R = ceil(B / 16)
    rows each; past them a cooperative grid (``grid``) of C = ceil(B / R)
    CTAs, R = max(4, ceil(B / 128)).  CTA c owns the rows ``rows[c]``.
    ``weights``: where a CTA holds W (its rows 4 mod 32 floats apart), a,
    b and bp, ``rows_at``: its rows' state, stages and scratch, each
    ``"shared"`` or ``"device"`` (a copy the CTA owns), the first of all in
    shared memory, the rows in device memory, both there; ``group_rows``
    rows a pass of the field, the most that fits.  The backward's gW is deferred: each VJP
    records its rows' (w, phi), ``rec_row`` = D + L floats a row, in
    device memory (``gw_records``), and after the replay CTA c owns the
    columns ``gw_cols[c]`` of [gW | gbp] (L + 1 columns), its 4 x 4 tiles
    summed over ``gw_splits`` interleaved splits of the records,
    ``gw_chunk`` records a stage; ga / gb are each CTA's partials, in
    ``gw_partials`` (device memory), added in rank order."""
    if B < 1:
        raise ValueError(f"row_plan: B must be >= 1, got {B}")
    grid_past = GRID_PAST if grid_past is None else grid_past
    L = D * K
    grid = B > grid_past
    R = max(CLUSTER_ROWS, _cdiv(B, MAX_GRID)) if grid else _cdiv(B, MAX_CLUSTER)
    C = _cdiv(B, R)
    DP = _round(D, 32)
    NO = DP // 32
    LC = _round(_cdiv(L, ROW_WARPS), 4)
    LP = ROW_WARPS * LC
    PB = max(LC, DP) if NO <= 2 else LC + DP
    WSL = _round(LP, 4)                # W's rows: the smallest stride >= LP
    while WSL % 32 != 4:               # that is 4 mod 32 floats
        WSL += 4
    w = DP * WSL + 2 * LP + DP         # W's rows, then a, b and bp
    scaf = _round(9 * R * D, 4)
    budget = SMEM_BUDGET // 4

    def buf(gr):
        return gr * (DP + L) if bwd else ROW_WARPS * gr * PB
    GR, rows_smem, w_smem = 0, False, False
    for form in range(3):
        for gr in (GROUP_ROWS, 2, 1):
            if GR == 0 and buf(gr) + (w if form < 2 else 0) \
                    + (scaf if form == 0 else 0) <= budget:
                GR, rows_smem, w_smem = gr, form == 0, form < 2
    GR = GR or 1
    buf_f = _round(buf(GR), 4)
    smem = buf_f + (w if w_smem else 0) + (scaf if rows_smem else 0)
    work = PART_FLOATS + C * ((0 if w_smem else w) + (0 if rows_smem else scaf))
    plan = dict(grid=grid, C=C, R=R,
                rows=[range(c * R, min(B, (c + 1) * R)) for c in range(C)],
                group_rows=GR, weights="shared" if w_smem else "device",
                rows_at="shared" if rows_smem else "device",
                threads=ROW_THREADS)
    if bwd:
        LS = _round(_cdiv(L + 1, C), 4)
        NOG = _cdiv(D, 4)
        T = NOG * (LS // 4)
        TT = min(T, ROW_THREADS)
        KS = 1 if T >= ROW_THREADS else ROW_THREADS // T
        parts = 16 * KS * TT if KS > 1 else 0
        room = max(smem, budget) - parts
        MC = max(1, min(CHUNK, room // (2 * (4 * NOG + LS))))
        smem = max(smem, 2 * MC * (4 * NOG + LS) + parts)
        rec_row = D + L
        work += C * 2 * L + 6 * M * B * rec_row
        plan.update(gw_slice=LS,
                    gw_cols=[range(c * LS, min(L + 1, (c + 1) * LS))
                             for c in range(C)],
                    gw_tiles=T, gw_splits=KS, gw_chunk=MC, rec_row=rec_row,
                    gw_records="device", gw_partials="device")
    plan.update(smem_bytes=4 * smem, work_floats=work)
    return plan


def logistic_field(a: torch.Tensor, b: torch.Tensor, proj_w: torch.Tensor,
                   proj_b: torch.Tensor) -> NC.Field:
    """The 'plain' field as a callable on (B, D) (``models/ecg.py:
    kanfet_node_field``): ``mixer(h) @ proj_w^T + proj_b``."""
    mixer = LogisticParams(a, b)

    def field(y):
        phi = torch.sigmoid(logistic_basis(mixer, y)).reshape(y.shape[0], -1)
        return phi @ proj_w.T + proj_b
    return field


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.logistic_node_fwd.argtypes = [P] * 11 + [I] * 4 + [F] * 2 \
        + [I, I, P]
    lib.logistic_node_bwd.argtypes = [P] * 15 + [I] * 5 + [P]
    lib.logistic_node_fwd.restype = lib.logistic_node_bwd.restype = \
        ctypes.c_int
    lib.logistic_node_plan.argtypes = [I] * 6 + [P]
    lib.logistic_node_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _check_plan(B: int, D: int, K: int, M: int, grid_past: int) -> None:
    """Raise unless the library's plan is ``row_plan``'s, forward and
    backward (once a shape)."""
    for bwd in (False, True):
        got = (ctypes.c_longlong * 14)()
        _lib().logistic_node_plan(B, D, K, M, int(bwd), grid_past,
                                  ctypes.addressof(got))
        p = row_plan(B, D, K, M, bwd, grid_past)
        want = [int(p["grid"]), p["C"], p["R"], p["group_rows"],
                p["smem_bytes"], int(p["rows_at"] == "shared"),
                int(p["weights"] == "shared"), p["work_floats"],
                p["threads"]] + [p.get(k, 0) for k in (
                    "gw_slice", "gw_tiles", "gw_splits", "gw_chunk",
                    "rec_row")]
        if list(got) != want:
            raise RuntimeError(f"logistic_node: the library's plan {list(got)}"
                               f" differs from row_plan's {want} at B={B}, "
                               f"D={D}, K={K}, M={M}, bwd={bwd}")


def _check_shapes(a, b, proj_w, proj_b, h0, name) -> None:
    D, K = a.shape
    NC.check_state(h0, D, name)
    if b.shape != (D, K) or proj_w.shape != (D, D * K) \
            or proj_b.shape != (D,):
        raise ValueError(f"{name}: mixer a, b must be (D, K) = {(D, K)}, "
                         f"proj_w (D, D*K), proj_b (D,)")


def _operands(a, b, proj_w, proj_b, h0, name) -> List[torch.Tensor]:
    """The kernels' float32 operands, checked."""
    _check_shapes(a, b, proj_w, proj_b, h0, name)
    return [NC.kernel_operand(t, h0.device, f"{name} {n}")
            for t, n in ((a, "a"), (b, "b"), (proj_w, "proj_w"),
                         (proj_b, "proj_b"))]


@functools.lru_cache(maxsize=None)
def _work_floats(B: int, D: int, K: int, M: int, bwd: bool,
                 grid_past: int) -> int:
    """The launch's device scratch (``row_plan``), the library's plan
    checked against it, once a shape."""
    _check_plan(B, D, K, M, grid_past)
    return row_plan(B, D, K, M, bwd, grid_past)["work_floats"]


def _work(B, D, K, M, bwd, device):
    grid_past = GRID_PAST
    n = _work_floats(B, D, K, M, bwd, grid_past)
    return torch.empty(n, dtype=torch.float32, device=device), grid_past


def _launch_fwd(ops, h0, rtol, atol, max_steps, record):
    B, D = h0.shape
    K = ops[0].shape[1]
    dev = h0.device
    h0 = h0.detach().contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    recs = NC.new_records(max_steps, B, D, dev) if record else None
    r = recs if record else (None,) * 4
    work, grid_past = _work(B, D, K, int(max_steps), False, dev)
    NC.launch(_lib().logistic_node_fwd, NC.ptr(h0),
              *(NC.ptr(t) for t in ops), NC.ptr(out), *(NC.ptr(t) for t in r),
              NC.ptr(work), B, D, K, int(max_steps),
              float(rtol), float(atol), int(record), grid_past,
              name="logistic_node_fwd", device=dev)
    logistic_node_fwd.launches += 1
    return out, recs


def _launch_bwd(ops, records, hbar):
    B, D = hbar.shape
    K = ops[0].shape[1]
    dev = hbar.device
    NC.check_records(records, B, D, dev, "logistic_node_bwd")
    M = records.tda.shape[0]
    hbar = hbar.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in ops]
    h0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    work, grid_past = _work(B, D, K, M, True, dev)
    NC.launch(_lib().logistic_node_bwd, NC.ptr(hbar),
              *(NC.ptr(t) for t in records), *(NC.ptr(t) for t in ops),
              *(NC.ptr(g) for g in grads), NC.ptr(h0bar),
              NC.ptr(work), B, D, K, M, grid_past,
              name="logistic_node_bwd", device=dev)
    logistic_node_bwd.launches += 1
    return grads, h0bar


def logistic_node_fwd(a: torch.Tensor, b: torch.Tensor, proj_w: torch.Tensor,
                      proj_b: torch.Tensor, h0: torch.Tensor, *,
                      rtol: float = 1e-2, atol: float = 1e-3,
                      max_steps: int = 16, record: bool = True
                      ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel: ``(final state (B, D), records or None)``, no
    autograd.  A CPU tensor gets ``record_solve_reference``."""
    if h0.device.type == "cpu":
        _check_shapes(a, b, proj_w, proj_b, h0, "logistic_node_fwd")
        hT, recs = NC.record_solve_reference(
            logistic_field(a, b, proj_w, proj_b), h0, rtol=rtol, atol=atol,
            max_steps=max_steps)
        return hT, recs if record else None
    NC.check_cuda(h0, "logistic_node_fwd")
    ops = _operands(a, b, proj_w, proj_b, h0, "logistic_node_fwd")
    return _launch_fwd(ops, h0, rtol, atol, max_steps, record)


def logistic_node_bwd(a: torch.Tensor, b: torch.Tensor, proj_w: torch.Tensor,
                      proj_b: torch.Tensor, h0: torch.Tensor,
                      records: NC.SolveRecords, hbar: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reverse-replay kernel: the final-state cotangent ``hbar`` ->
    (gradients of a, b, proj_w, proj_b; h0bar).  The kernel reads the
    recorded states and does not need ``h0``; a CPU tensor gets
    ``replay_vjp_reference``, which does."""
    if h0.device.type == "cpu":
        _check_shapes(a, b, proj_w, proj_b, h0, "logistic_node_bwd")
        return NC.replay_vjp_reference(logistic_field(a, b, proj_w, proj_b),
                                       (a, b, proj_w, proj_b), h0, records,
                                       hbar)
    NC.check_cuda(h0, "logistic_node_bwd")
    ops = _operands(a, b, proj_w, proj_b, h0, "logistic_node_bwd")
    return _launch_bwd(ops, records, hbar)


logistic_node_fwd.launches = 0
logistic_node_bwd.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel.
    The parameters are saved as given, so autograd refuses a backward
    after they changed in place."""

    @staticmethod
    def forward(ctx, opts, h0, a, b, proj_w, proj_b):
        ops = _operands(a, b, proj_w, proj_b, h0, "logistic_node_solve")
        out, recs = _launch_fwd(ops, h0, *opts, record=True)
        ctx.save_for_backward(a, b, proj_w, proj_b, *recs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, hbar):
        a, b, proj_w, proj_b, *recs = ctx.saved_tensors
        ops = [t.detach().contiguous() for t in (a, b, proj_w, proj_b)]
        grads, h0bar = _launch_bwd(ops, NC.SolveRecords(*recs), hbar)
        need = ctx.needs_input_grad
        return (None, h0bar if need[1] else None,
                *(g if need[2 + i] else None for i, g in enumerate(grads)))


def logistic_node_solve(params, h0: torch.Tensor, spec) -> torch.Tensor:
    """Solve the ``KanFetNODESpec`` (field='plain') latent ODE over [0, 1]
    from ``h0`` (B, D) -> the final state.  ``params`` is the model's
    parameter module (``field_mixer.a``, ``field_mixer.b``, ``proj_w``,
    ``proj_b``).  Autograd gives the gradients of those four and of
    ``h0``: on CUDA through the kernel pair, on the CPU through the plain
    replay."""
    w = (params.field_mixer.a, params.field_mixer.b, params.proj_w,
         params.proj_b)
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    grad = _under_autograd(h0, *w)
    if h0.device.type == "cpu":
        _check_shapes(*w, h0, "logistic_node_solve")
        if grad:
            return NC.solve_reference(logistic_field(*w), h0, **opts)
        return NC.record_solve_reference(logistic_field(*w), h0, **opts)[0]
    NC.check_cuda(h0, "logistic_node_solve")
    if grad:
        return _SolveTrain.apply(
            (opts["rtol"], opts["atol"], opts["max_steps"]), h0, *w)
    return logistic_node_fwd(*w, h0, record=False, **opts)[0]


def logistic_node_solve_sharded(params, h0: torch.Tensor, spec, mesh, *,
                                axis: str = "data") -> torch.Tensor:
    """``logistic_node_solve`` over a mesh (counterpart of
    ``pallas_logistic_node_solve_sharded``): every rank solves its block
    of ``h0``'s rows over ``axis`` with that block's own step control and
    returns the global final states; the parameters' gradients are summed
    over the ranks (``parallel.shard_map_rows``).  ``h0``'s batch must
    divide the axis size."""
    from fetode_tpu_torch.parallel.collectives import shard_map_rows

    return shard_map_rows(lambda p, h: logistic_node_solve(p, h, spec),
                          mesh, params, h0, axis=axis)
