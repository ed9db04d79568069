"""Plug your own vector field into the whole-solve kernel scaffold.

The port's counterpart of ``examples/02_custom_field_kernel.py``.
``fetode_tpu_torch/csrc/node_common.cuh`` is the port's most reusable
asset: an adaptive dopri5 solve (Hairer's initial step, the PI
controller, FSAL) that runs entirely inside one CUDA kernel launch,
records every step attempt, and replays the frozen step mesh backwards
for a discrete adjoint.  A field supplies two device methods:

    eval(u, out)        out = f(u)                 rows -> rows
    vjp(u, w, ubar)     ubar = w^T df/du(u), parameter cotangents
                        added into buffers the field holds

``csrc/custom_field.cu`` instantiates it for a tiny custom field, dh =
tanh(h w1^T) w2^T (a one-hidden-layer MLP), and this module wraps it and
checks both the solution and the gradients against the eager solver
(``solvers/dopri5.py``) on the same math.  The production fields follow
the same shape: ``csrc/logistic_node.cu``, ``ferro_node.cu``,
``mlp_node.cu``, ``ode_dyn.cu``, ``node_enc.cu``.

The field never mixes rows, so it runs under the scaffold's row policy
(``RowSync``): each CTA owns a block of batch rows and holds w1 and w2
in its shared memory for the launch, and ``eval`` / ``vjp`` take that
CTA's rows only, (nrows, D) and synchronise only the CTA; the one
exchange between CTAs is the error norm's sum, once an attempt.  A field
that mixes rows (a batch norm, attention over the batch) takes the grid
policy (``GridSync``) instead, where both methods see all B rows and
synchronise the cooperative grid (``csrc/ferro_node.cu``).  The header
of ``csrc/custom_field.cu`` says what a field supplies under each.

* ``row_plan(B, D, H, bwd)`` — the launch: up to 64 rows one
  thread-block cluster of at most 16 CTAs, past them a cooperative grid
  of 4-row CTAs; where each CTA holds w1, w2 and its rows (its shared
  memory while they fit 227 KB, else device memory).  The library's
  ``custom_field_plan`` is checked against it once a shape.
* ``custom_field_fwd`` / ``custom_field_bwd`` — the kernel wrappers, each
  with a launch counter (``.launches``).  For CPU tensors they take the
  plain versions ``record_solve_reference`` / ``replay_vjp_reference`` of
  ``ops/node_common.py`` around ``tanh_mlp_field``; they never fall back
  from a CUDA tensor.
* ``make_my_solver(D, H, ...)`` — ``solve(w1, w2, h0) -> h(t=1)``, a
  ``torch.autograd.Function``: the recording forward kernel and, in its
  backward, the replay kernel.  w1 is (H, D) and w2 (D, H), the JAX
  example's layouts, so its weights carry over one to one.

Run:  python -m fetode_tpu_torch.examples.custom_field_kernel [--device cpu]
(the card by default; ``--device cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from typing import Dict, List, Tuple

import torch

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.solvers.dopri5 import _under_autograd, odeint_dopri5

_KERNEL_NAME = "custom_field"
# The launch (``csrc/custom_field.cu: make_geo``): one cluster of at most
# MAX_CLUSTER CTAs up to MAX_CLUSTER * CLUSTER_ROWS rows, past them a
# cooperative grid of at most MAX_GRID CTAs of >= CLUSTER_ROWS rows;
# ROW_THREADS threads a CTA, TILE_SLOTS gradient tiles a thread in
# registers, SMEM_BUDGET bytes of dynamic shared memory a CTA.
MAX_CLUSTER, CLUSTER_ROWS, MAX_GRID = 16, 4, 128
ROW_THREADS, TILE_SLOTS = 512, 4
SMEM_BUDGET = 232448 - 2048
_PART_FLOATS = 4096            # node_common.cuh: kPartFloats


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _row_stride(k: int) -> int:
    """The smallest stride >= k that is 4 mod 32 floats."""
    s = _round4(k)
    while s % 32 != 4:
        s += 4
    return s


def row_plan(B: int, D: int, H: int, bwd: bool = False) -> Dict[str, object]:
    """The kernels' launch at batch B and widths D, H (``csrc/
    custom_field.cu: make_geo``).  Up to 64 rows one cluster of ``C`` <= 16
    CTAs, R = ceil(B / 16) rows each; past them a cooperative grid
    (``grid``) of C = ceil(B / R) CTAs, R = max(4, ceil(B / 128)).  CTA c
    owns the rows ``rows[c]``.  ``smem``: whether w1 and w2 (padded, rows
    4 mod 32 floats apart) and the rows' state, stages and records sit in
    the CTA's shared memory (``smem_bytes``), else both in device memory
    the CTA owns (``work_floats`` of scratch, which also holds the grid
    form's partials and, backward, every CTA's gradient tiles);
    ``tiles``: the 4 x 4 gradient tiles, ``tile_slots`` of them a thread
    in registers; ``record``: the row record's floats."""
    if B < 1:
        raise ValueError(f"row_plan: B must be >= 1, got {B}")
    grid = B > MAX_CLUSTER * CLUSTER_ROWS
    R = max(CLUSTER_ROWS, -(-B // MAX_GRID)) if grid else -(-B // MAX_CLUSTER)
    C = -(-B // R)
    D4, H4 = _round4(D), _round4(H)
    rec = 2 * (D4 + H4) if bwd else D4 + H4
    w = H4 * _row_stride(D) + D4 * _row_stride(H)
    p = 4 * max(H, D, ROW_THREADS // 32 * 64) if bwd else 0
    rows = _round4(9 * R * D) + R * rec
    in_smem = w + p + rows <= SMEM_BUDGET // 4
    tiles = 2 * (-(-D // 4)) * (-(-H // 4))
    work = (_PART_FLOATS if grid else 0) + C * (
        (0 if in_smem else w + rows) + (16 * tiles if bwd else 0))
    return dict(grid=grid, C=C, R=R,
                rows=[range(c * R, min(B, (c + 1) * R)) for c in range(C)],
                smem_bytes=4 * (p + (w + rows if in_smem else 0)),
                smem=in_smem, work_floats=work, tiles=tiles,
                threads=ROW_THREADS, tile_slots=TILE_SLOTS, record=rec)


def tanh_mlp_field(w1: torch.Tensor, w2: torch.Tensor) -> NC.Field:
    """The custom field as a callable on (B, D): ``tanh(h w1^T) w2^T``."""
    def field(y):
        return torch.tanh(y @ w1.T) @ w2.T
    return field


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.custom_field_fwd.argtypes = [P] * 9 + [I] * 4 + [F] * 2 + [I, P]
    lib.custom_field_bwd.argtypes = [P] * 11 + [I] * 3 + [P]
    lib.custom_field_fwd.restype = lib.custom_field_bwd.restype = \
        ctypes.c_int
    lib.custom_field_work_floats.argtypes = [I] * 3
    lib.custom_field_work_floats.restype = ctypes.c_longlong
    lib.custom_field_plan.argtypes = [I] * 4 + [P]
    lib.custom_field_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _check_plan(B: int, D: int, H: int) -> None:
    """Raise unless the library's plan is ``row_plan``'s, forward and
    backward (once a shape)."""
    for bwd in (False, True):
        got = (ctypes.c_longlong * 10)()
        _lib().custom_field_plan(B, D, H, int(bwd), ctypes.addressof(got))
        p = row_plan(B, D, H, bwd)
        want = [p["C"], p["R"], p["smem_bytes"], int(p["smem"]),
                p["work_floats"], p["tiles"], p["threads"], p["tile_slots"],
                int(p["grid"]), p["record"]]
        if list(got) != want:
            raise RuntimeError(f"custom_field: the library's plan {list(got)}"
                               f" at B={B}, D={D}, H={H}, bwd={bwd} is not "
                               f"row_plan's {want}")


def _check_shapes(w1, w2, h0, name) -> None:
    H, D = w1.shape
    NC.check_state(h0, D, name)
    if w1.ndim != 2 or tuple(w2.shape) != (D, H):
        raise ValueError(f"{name}: w1 must be (H, D) and w2 (D, H), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")


def _operands(w1, w2, h0, name) -> List[torch.Tensor]:
    _check_shapes(w1, w2, h0, name)
    return [NC.kernel_operand(w, h0.device, f"{name} {n}")
            for w, n in ((w1, "w1"), (w2, "w2"))]


def _work(B, D, H, device):
    _check_plan(B, D, H)
    n = _lib().custom_field_work_floats(B, D, H)
    return torch.empty(n, dtype=torch.float32, device=device)


def _launch_fwd(ops, h0, rtol, atol, max_steps, record):
    B, D = h0.shape
    H = ops[0].shape[0]
    dev = h0.device
    h0 = h0.detach().contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    recs = NC.new_records(max_steps, B, D, dev) if record else None
    r = recs if record else (None,) * 4
    NC.launch(_lib().custom_field_fwd, NC.ptr(h0), *(NC.ptr(t) for t in ops),
              NC.ptr(out), *(NC.ptr(t) for t in r),
              NC.ptr(_work(B, D, H, dev)), B, D, H, int(max_steps),
              float(rtol), float(atol), int(record),
              name="custom_field_fwd", device=dev)
    custom_field_fwd.launches += 1
    return out, recs


def _launch_bwd(ops, records, hbar):
    B, D = hbar.shape
    H = ops[0].shape[0]
    dev = hbar.device
    NC.check_records(records, B, D, dev, "custom_field_bwd")
    hbar = hbar.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in ops]
    h0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    NC.launch(_lib().custom_field_bwd, NC.ptr(hbar),
              *(NC.ptr(t) for t in records), *(NC.ptr(t) for t in ops),
              *(NC.ptr(g) for g in grads), NC.ptr(h0bar),
              NC.ptr(_work(B, D, H, dev)), B, D, H,
              name="custom_field_bwd", device=dev)
    custom_field_bwd.launches += 1
    return grads, h0bar


def custom_field_fwd(w1: torch.Tensor, w2: torch.Tensor, h0: torch.Tensor, *,
                     rtol: float = 1e-4, atol: float = 1e-6,
                     max_steps: int = 32, record: bool = True
                     ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel: ``(h(t=1) (B, D), records or None)``, no
    autograd.  A CPU tensor gets ``record_solve_reference``."""
    if h0.device.type == "cpu":
        _check_shapes(w1, w2, h0, "custom_field_fwd")
        hT, recs = NC.record_solve_reference(
            tanh_mlp_field(w1, w2), h0, rtol=rtol, atol=atol,
            max_steps=max_steps)
        return hT, recs if record else None
    NC.check_cuda(h0, "custom_field_fwd")
    ops = _operands(w1, w2, h0, "custom_field_fwd")
    return _launch_fwd(ops, h0, rtol, atol, max_steps, record)


def custom_field_bwd(w1: torch.Tensor, w2: torch.Tensor, h0: torch.Tensor,
                     records: NC.SolveRecords, hbar: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reverse-replay kernel: the final-state cotangent ``hbar`` ->
    ([gw1, gw2], h0bar).  The kernel reads the recorded states and does
    not need ``h0``; a CPU tensor gets ``replay_vjp_reference``, which
    does."""
    if h0.device.type == "cpu":
        _check_shapes(w1, w2, h0, "custom_field_bwd")
        w = [t.detach().requires_grad_(True) for t in (w1, w2)]
        return NC.replay_vjp_reference(tanh_mlp_field(*w), w, h0, records,
                                       hbar)
    NC.check_cuda(h0, "custom_field_bwd")
    ops = _operands(w1, w2, h0, "custom_field_bwd")
    return _launch_bwd(ops, records, hbar)


custom_field_fwd.launches = 0
custom_field_bwd.launches = 0


class _Solve(torch.autograd.Function):
    """The recording forward and the replay backward, on either device
    (the wrappers dispatch by the state's device)."""

    @staticmethod
    def forward(ctx, opts, w1, w2, h0):
        hT, recs = custom_field_fwd(w1, w2, h0, record=True, **opts)
        ctx.save_for_backward(w1, w2, h0, *recs)
        return hT

    @staticmethod
    def backward(ctx, hbar):
        w1, w2, h0, *recs = ctx.saved_tensors
        (gw1, gw2), h0bar = custom_field_bwd(w1, w2, h0,
                                             NC.SolveRecords(*recs), hbar)
        need = ctx.needs_input_grad
        return (None, gw1 if need[1] else None, gw2 if need[2] else None,
                h0bar if need[3] else None)


def make_my_solver(D: int, H: int, rtol: float = 1e-4, atol: float = 1e-6,
                   max_steps: int = 32, *, device: str = "cuda"):
    """``solve(w1, w2, h0) -> h(t=1)``, differentiable through the in-kernel
    discrete adjoint; w1 (H, D) [used as h @ w1^T], w2 (D, H), h0 (B, D),
    all on ``device`` (the kernels on CUDA, their plain versions on the
    CPU)."""
    want = torch.device(device).type
    opts = dict(rtol=rtol, atol=atol, max_steps=max_steps)

    def solve(w1, w2, h0):
        if h0.device.type != want:
            raise ValueError(f"this solver was made for {device!r}, got h0 "
                             f"on {h0.device}")
        if tuple(w1.shape) != (H, D):
            raise ValueError(f"w1 must be ({H}, {D}), got {tuple(w1.shape)}")
        if _under_autograd(w1, w2, h0):
            return _Solve.apply(opts, w1, w2, h0)
        return custom_field_fwd(w1, w2, h0, record=False, **opts)[0]
    return solve


def main(argv=None) -> int:
    """The JAX example's check (``examples/02_custom_field_kernel.py``
    :132-168) on the same shapes."""
    from fetode_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    D, H, B = 4, 8, 3
    g = torch.Generator().manual_seed(0)
    w1 = (0.5 * torch.randn((H, D), generator=g)).to(dev)
    w2 = (0.5 * torch.randn((D, H), generator=g)).to(dev)
    h0 = torch.randn((B, D), generator=g).to(dev)
    ts = torch.tensor([0.0, 1.0], device=dev)
    opts = dict(rtol=1e-4, atol=1e-6, max_steps=32)

    solve = make_my_solver(D, H, device=args.device)
    with torch.no_grad():
        hT = solve(w1, w2, h0)
        # the eager reference: the same field through the while dopri5
        ref = odeint_dopri5(lambda t, h: tanh_mlp_field(w1, w2)(h), h0, ts,
                            mode="while", **opts)[-1]
    err = float((hT - ref).abs().max())
    print(f"forward max|kernel - eager| = {err:.2e}")
    if not err < 1e-4:
        print("forward check failed", file=sys.stderr)
        return 1

    leaves = [t.clone().requires_grad_(True) for t in (w1, w2, h0)]
    gk = torch.autograd.grad(torch.sum(solve(*leaves) ** 2), leaves)
    hx = odeint_dopri5(lambda t, h: tanh_mlp_field(leaves[0], leaves[1])(h),
                       leaves[2], ts, mode="scan", **opts)[-1]
    gx = torch.autograd.grad(torch.sum(hx ** 2), leaves)
    for name, a, b in zip(("w1", "w2", "h0"), gk, gx):
        cos = float(torch.sum(a * b) / (a.norm() * b.norm()))
        print(f"grad[{name}] cosine vs eager autodiff: {cos:.7f}")
        if not cos > 0.9999:
            print("gradient check failed", file=sys.stderr)
            return 1
    print("custom-field whole-solve kernel: forward + adjoint verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
