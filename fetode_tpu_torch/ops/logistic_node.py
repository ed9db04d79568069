"""Whole-solve ECG KanFetNODE 'plain' latent field: dopri5 over [0, 1]
with batch-shared step control and its discrete adjoint, as two CUDA
kernels.

Counterpart of ``fetode_tpu/ops/pallas_logistic_node.py:
make_logistic_node_solver`` (the TPU kernels ``_make_fwd_kernel`` :39 and
``_make_bwd_kernel`` :58).  The CUDA source is
``fetode_tpu_torch/csrc/logistic_node.cu`` on the shared scaffold
``csrc/node_common.cuh``; its header gives the design and what bounds it.
The field, with the mixer parameters a, b of shape (D, K), L = D*K:

    phi = sigmoid(2 * sigmoid(a * (h - b)))    flattened to (B, L)
    dh  = phi @ proj_w^T + proj_b              proj_w (D, L)

* ``logistic_node_solve`` — the public solve of the model's parameters.
  On CUDA, under autograd, a ``torch.autograd.Function`` launches
  ``logistic_node_fwd`` (which records every attempt) and, in its
  backward, ``logistic_node_bwd``; without autograd the forward kernel
  alone, recording nothing.  On the CPU it takes the plain version.
* ``logistic_node_fwd`` / ``logistic_node_bwd`` — the kernel wrappers,
  each with a launch counter (``.launches``).  For CPU tensors they take
  the plain versions ``record_solve_reference`` and
  ``replay_vjp_reference`` of ``ops/node_common.py`` around
  ``logistic_field``; they never fall back from a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.logistic import LogisticParams, logistic_basis
from fetode_tpu_torch.solvers.dopri5 import _under_autograd

_KERNEL_NAME = "logistic_node"


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
    lib.logistic_node_fwd.argtypes = [P] * 11 + [I] * 4 + [F] * 2 + [I, P]
    lib.logistic_node_bwd.argtypes = [P] * 15 + [I] * 3 + [P]
    lib.logistic_node_fwd.restype = lib.logistic_node_bwd.restype = \
        ctypes.c_int
    lib.logistic_node_work_floats.argtypes = [I] * 3
    lib.logistic_node_work_floats.restype = ctypes.c_longlong
    return lib


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


def _work(B, D, K, device):
    n = _lib().logistic_node_work_floats(B, D, K)
    return torch.empty(n, dtype=torch.float32, device=device)


def _launch_fwd(ops, h0, rtol, atol, max_steps, record):
    B, D = h0.shape
    K = ops[0].shape[1]
    dev = h0.device
    h0 = h0.detach().contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    recs = NC.new_records(max_steps, B, D, dev) if record else None
    r = recs if record else (None,) * 4
    work = _work(B, D, K, dev)
    NC.launch(_lib().logistic_node_fwd, NC.ptr(h0),
              *(NC.ptr(t) for t in ops), NC.ptr(out), *(NC.ptr(t) for t in r),
              NC.ptr(work), B, D, K, int(max_steps),
              float(rtol), float(atol), int(record),
              name="logistic_node_fwd", device=dev)
    logistic_node_fwd.launches += 1
    return out, recs


def _launch_bwd(ops, records, hbar):
    B, D = hbar.shape
    K = ops[0].shape[1]
    dev = hbar.device
    NC.check_records(records, B, D, dev, "logistic_node_bwd")
    hbar = hbar.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in ops]
    h0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    work = _work(B, D, K, dev)
    NC.launch(_lib().logistic_node_bwd, NC.ptr(hbar),
              *(NC.ptr(t) for t in records), *(NC.ptr(t) for t in ops),
              *(NC.ptr(g) for g in grads), NC.ptr(h0bar),
              NC.ptr(work), B, D, K,
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
