"""Whole-solve of a wide KANFET NODE stack: dopri5 over [ts[0], ts[-1]]
with batch-shared step control, CONTD5 dense output at every requested
time, and its discrete adjoint on the frozen step mesh, as two CUDA
kernels.

Counterpart of ``fetode_tpu/ops/pallas_kanfet_wide.py:
make_wide_train_solver`` (the TPU kernels ``_make_fwd_kernel`` :101 and
``_make_bwd_kernel`` :286, called at :632 and :663), which the JAX
package's ``predict`` takes in 'pallas' mode for stacks whose largest
in·out·K reaches ``models/predprey.py: WIDE_DISPATCH_FERRO_N``.  The CUDA
source is ``fetode_tpu_torch/csrc/kanfet_wide.cu`` on the trajectory pair
of ``csrc/node_common.cuh`` under its cluster policy; its header gives the
design and what bounds it.  Each kernel is one thread-block cluster whose
CTAs hold the stack's parameters (and, backward, its gradients) in shared
memory; ``cluster_plan`` picks its size.  The field is the KANFET stack
itself with the hysteresis state fresh and frozen (``kan_apply`` at
``kan_state_init``), autonomous: it ignores t.

Step control is batch-shared: one t and one dt over all B rows, the RMS
error over all B·D elements (at B = 1, the same as per-trajectory
control).  Gradients are exact for the realised discrete map holding the
step mesh fixed (the controller is not differentiated).

* ``kanfet_wide_solve_train`` — the public solve, ``(B, D)`` -> ``(B,
  T, D)``.  On CUDA, under autograd, a ``torch.autograd.Function``
  launches ``kanfet_wide_fwd`` (which records every attempt) and, in its
  backward, ``kanfet_wide_bwd``; without autograd the forward kernel
  alone, recording nothing.  On the CPU it takes the plain version,
  ``kanfet_wide_solve_train_reference``.
* ``cluster_plan`` / ``max_batch`` — the cluster both kernels take at a
  batch (the fewest CTAs, at most ``MAX_CLUSTER``, whose shared memory
  holds the backward's bytes, the larger: ``smem_floats``, which the CUDA
  source lays out too) and the largest batch such a cluster holds (0 for
  a stack too wide or deep for 16 CTAs: [2, 80, 80, 2] or [2, 64, 64, 64,
  2] at K = 8, [2, 64, 64, 2] at K = 16); past it the CUDA wrappers raise
  ``ValueError``.  ``holds`` says whether a stack fits at a batch:
  ``models/predprey.py: predict`` sends a wide stack that does not to the
  per-trajectory kernels (``ops/kanfet_adjoint.py``), which take any
  width.
* ``kanfet_wide_fwd`` / ``kanfet_wide_bwd`` — the kernel wrappers on the
  operands of ``wide_weights``, each with a launch counter
  (``.launches``).  For CPU tensors they take the plain versions
  ``record_solve_traj_reference`` and ``replay_traj_vjp_reference`` of
  ``ops/node_common.py`` around ``wide_field``; they never fall back
  from a CUDA tensor.

The kernels take per layer eight operands: base_weight (O, I), the scaled
spline weight ``sw = spline_weight * spline_scaler`` (O, I, 8), formed
per call outside them so that autograd carries the scaler's chain, the
knot grid (I, 12) and the ferro k, ec, ps, bias, coef (I, O, K).  The
grid is a buffer and gets no gradient.  Only grid 5 / order 3 layers
with one gate slope and alpha are compiled; other stacks raise
``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.nn.kan import KAN, KANConfig, _scaled_spline_weight
from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.bsplines import bspline_basis
from fetode_tpu_torch.ops.kanfet_node import _check_inputs, _check_stack
from fetode_tpu_torch.solvers.dopri5 import _under_autograd

_KERNEL_NAME = "kanfet_wide"
GRID_SIZE, ORDER = 5, 3
N_COEFF = GRID_SIZE + ORDER               # 8 basis columns
N_KNOTS = GRID_SIZE + 2 * ORDER + 1       # 12 knots a feature
MAX_LAYERS = 8                            # csrc/kanfet_wide.cu: kMaxLayers
N_OPS = 8                                 # operands a layer
_GRID = 2                                 # the grid's place among them
# The cluster (csrc/kanfet_wide.cu): at most kMaxCluster CTAs, kMaxSmem
# bytes of dynamic shared memory a CTA (227 KB less 1 KB for the static
# arrays), the input-prep slots kPrepFwd / kPrepBwd and kRed floats of
# group-sum scratch (a warp's sum each, up to 32 warps).
MAX_CLUSTER = 16
SMEM_LIMIT = 227 * 1024 - 1024
_PREP_FWD, _PREP_BWD = 3 + ORDER + 1, 3 + ORDER + 1 + 1 + ORDER + 1
_RED = 32


def check_stack(cfg: KANConfig) -> int:
    """The stacks the kernels take (``make_wide_train_solver``'s contract
    and the compiled geometry); returns D."""
    D = _check_stack(cfg)
    cfgs = cfg.layers
    if len(cfgs) > MAX_LAYERS:
        raise ValueError(f"the kanfet_wide kernels take at most {MAX_LAYERS} "
                         f"layers, got {len(cfgs)}")
    l0 = cfgs[0]
    for c in cfgs:
        if (c.grid_size, c.spline_order) != (GRID_SIZE, ORDER):
            raise ValueError(
                f"the kanfet_wide kernels are compiled for grid "
                f"{GRID_SIZE}, order {ORDER}, got grid {c.grid_size}, order "
                f"{c.spline_order}")
        if (c.ferro_gate_slope, c.ferro_alpha) != (l0.ferro_gate_slope,
                                                   l0.ferro_alpha):
            raise ValueError("the kanfet_wide kernels need one ferro gate "
                             "slope and alpha across layers")
    return D


# --------------------------------------------------------------- the plan


def owned_outputs(O: int, C: int, c: int) -> range:
    """The outputs of an O-wide layer that CTA c of a C-CTA cluster owns:
    its edges (i, o) for every input i, their parameters and gradients."""
    return range(c * O // C, (c + 1) * O // C)


def smem_floats(B: int, dims: Sequence[Tuple[int, int, int]], C: int,
                rank: int, bwd: bool) -> int:
    """Floats of CTA ``rank``'s shared memory (``csrc/kanfet_wide.cu:
    smem_layout``): the scaffold's 10 N state floats, the layers' inputs
    (and, backward, their cotangents), every layer's input prep, the
    backward's two partial-sum buffers (C, B, max I), the group-sum
    scratch, every layer's knots, the CTA's edges' parameters (and
    gradients), 9 + 5 K floats an edge, and the forward's terms and spline
    partials, K + 1 floats an edge and row of its widest layer."""
    I = [d[0] for d in dims]
    n = 10 * B * I[0] + (2 if bwd else 1) * B * sum(I[1:])
    n += (_PREP_BWD if bwd else _PREP_FWD) * B * sum(I)
    n += (2 * C * B * max(I) if bwd else 0) + _RED + N_KNOTS * sum(I)
    fbuf = 0
    for i, o, k in dims:
        n_e = len(owned_outputs(o, C, rank)) * i
        n += (2 if bwd else 1) * n_e * (1 + N_COEFF + 5 * k)
        fbuf = max(fbuf, B * n_e * (k + 1))
    return n + fbuf


def cluster_floats(B, dims, C, bwd) -> int:
    """The most floats any CTA of the cluster takes."""
    return max(smem_floats(B, dims, C, c, bwd) for c in range(C))


@functools.lru_cache(maxsize=None)
def cluster_plan(B: int, dims: Tuple[Tuple[int, int, int], ...]) -> int:
    """The CTAs of both kernels' cluster at batch ``B`` for the stack
    ``dims`` ((in, out, K) a layer): the fewest whose shared memory holds
    the backward's bytes, and so the forward's, which are fewer (the
    forward alone would fit fewer CTAs, but then runs its layers on fewer
    SMs, and was slower on the H100).
    ``ValueError`` if no cluster of ``MAX_CLUSTER`` does (past
    ``max_batch``)."""
    for C in range(1, MAX_CLUSTER + 1):
        if 4 * cluster_floats(B, dims, C, True) <= SMEM_LIMIT:
            return C
    raise ValueError(
        f"the kanfet_wide kernels hold a {[d[0] for d in dims] + [dims[-1][1]]}"
        f" stack in one cluster of at most {MAX_CLUSTER} CTAs up to B = "
        f"{max_batch(dims)} trajectories, got B = {B}")


@functools.lru_cache(maxsize=None)
def max_batch(dims: Tuple[Tuple[int, int, int], ...]) -> int:
    """The largest batch whose backward cluster (the larger) fits in some
    cluster of at most ``MAX_CLUSTER`` CTAs: the CUDA wrappers take B up to
    this and raise past it (0: none fits)."""
    def fits(b):
        return any(4 * cluster_floats(b, dims, C, True) <= SMEM_LIMIT
                   for C in range(1, MAX_CLUSTER + 1))
    lo, hi = 0, 1
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def holds(cfg: KANConfig, B: int) -> bool:
    """Whether the kernels' cluster holds the stack ``cfg`` at batch ``B``
    (``B <= max_batch``); the kernels raise for a stack it does not."""
    return B <= max_batch(tuple((c.in_features, c.out_features,
                                 c.ferro_num_basis) for c in cfg.layers))


# ------------------------------------------------------------ operands


def wide_weights(params: KAN) -> List[torch.Tensor]:
    """The kernels' operands, ``N_OPS`` a layer: base_weight, the scaled
    spline weight (a new tensor on every call, differentiable in
    spline_weight and spline_scaler), grid, then the ferro k, ec, ps,
    bias, coef."""
    out = []
    for layer in params.layers:
        fe = layer.ferro
        out += [layer.base_weight, _scaled_spline_weight(layer), layer.grid,
                fe.k, fe.ec, fe.ps, fe.bias, fe.coef]
    return out


def grad_weights(weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The operands the backward kernel gives gradients of: all but the
    knot grids, 7 a layer."""
    return [w for i, w in enumerate(weights) if i % N_OPS != _GRID]


def _gate(cfg: KANConfig) -> Tuple[float, float, float]:
    """(gate slope, alpha, 1 - alpha) of layer 0, 1 - alpha rounded from
    double as ``ops/ferro.py`` forms it."""
    c = cfg.layers[0]
    return float(c.ferro_gate_slope), float(c.ferro_alpha), \
        1.0 - float(c.ferro_alpha)


def wide_field(weights: Sequence[torch.Tensor], cfg: KANConfig
               ) -> NC.TrajField:
    """The stack as a callable ``field(t, y)`` on (B, D) over the operands
    of ``wide_weights``: ``kan_apply`` at the fresh frozen hysteresis state
    (``ops/ferro.py: ferro_basis`` with prev_x = 0 and branch = +1), where
    the up branch cancels, target = up - dn + (1 - up - dn) = 1 - 2 (1 -
    mu) cn, and a term takes one sigmoid and one tanh: the form the TPU
    kernel (``_ferro_rows``) and the CUDA kernels evaluate."""
    gate, alpha, oma = _gate(cfg)

    def layer(x, bw, sw, grid, k, ec, ps, bias, coef):
        y = F.silu(x) @ bw.T
        bases = bspline_basis(x, grid, ORDER).reshape(x.shape[0], -1)
        y = y + bases @ sw.reshape(sw.shape[0], -1).T
        xe = x[:, :, None, None]                       # (B, I, 1, 1)
        omu = 1.0 - torch.sigmoid(gate * xe)
        cn = torch.sigmoid(gate * (-xe - ec))
        beta = alpha + oma * (1.0 - 2.0 * omu * cn)
        fb = ps * torch.tanh(k * (xe + ec * beta)) + bias
        return y + torch.einsum("biok,iok->bo", fb, coef)

    def field(t, y):
        for i in range(0, len(weights), N_OPS):
            y = layer(y, *weights[i:i + N_OPS])
        return y
    return field


def kanfet_wide_solve_train_reference(params: KAN, cfg: KANConfig,
                                      x0s: torch.Tensor, ts: torch.Tensor,
                                      *, rtol: float = 1e-7,
                                      atol: float = 1e-9,
                                      max_steps: int = 256) -> torch.Tensor:
    """Plain version of ``kanfet_wide_solve_train``: the eager batch-shared
    solve of ``wide_field`` (``kan_apply`` at the fresh state), recorded
    and, under autograd, replayed on its mesh -> ``(B, T, D)``.  Works in
    the dtype of ``x0s``."""
    D = check_stack(cfg)
    _check_inputs(x0s, ts, D)
    field = wide_field(wide_weights(params), cfg)
    opts = dict(rtol=rtol, atol=atol, max_steps=max_steps)
    if _under_autograd(x0s, *params.parameters()):
        traj = NC.solve_traj_reference(field, x0s, ts, **opts)
    else:
        traj = NC.record_solve_traj_reference(field, x0s, ts, **opts)[0]
    return traj.transpose(0, 1)


# --------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kanfet_wide_fwd.argtypes = ([P] * 4 + [I] + [P] * 5 + [I] * 3
                                    + [F32] * 5 + [I, I, P])
    lib.kanfet_wide_bwd.argtypes = ([P] * 9 + [I] + [P] + [I] * 2
                                    + [F32] * 3 + [I, P])
    lib.kanfet_wide_fwd.restype = lib.kanfet_wide_bwd.restype = ctypes.c_int
    lib.kanfet_wide_smem_bytes.argtypes = [I, P, I, I, I]
    lib.kanfet_wide_smem_bytes.restype = ctypes.c_longlong
    return lib


def _dims(weights, cfg: KANConfig, x0s, ts, name) -> List[int]:
    """(I, O, K) a layer, flattened, checked against every operand."""
    D = check_stack(cfg)
    _check_inputs(x0s, ts, D)
    if len(weights) != N_OPS * len(cfg.layers):
        raise ValueError(f"{name}: expected the {N_OPS} operands a layer of "
                         f"wide_weights, got {len(weights)}")
    dims = []
    for li, c in enumerate(cfg.layers):
        I, O, K = c.in_features, c.out_features, c.ferro_num_basis
        want = [(O, I), (O, I, N_COEFF), (I, N_KNOTS)] + [(I, O, K)] * 5
        got = [tuple(w.shape) for w in weights[N_OPS * li:N_OPS * (li + 1)]]
        if got != want:
            raise ValueError(f"{name}: layer {li} operand shapes {got}, "
                             f"expected {want}")
        dims += [I, O, K]
    return dims


def _operands(weights, x0s, ts, name) -> List[torch.Tensor]:
    return [NC.kernel_operand(t, x0s.device, f"{name} operand {i}")
            for i, t in enumerate(list(weights) + [ts])]


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


@functools.lru_cache(maxsize=None)
def _cluster(B: int, dims: Tuple[int, ...], bwd: bool) -> int:
    """``cluster_plan`` for a kernel launch, its bytes checked once against
    the CUDA source's own layout."""
    layers = tuple(tuple(dims[i:i + 3]) for i in range(0, len(dims), 3))
    C = cluster_plan(B, layers)
    cdims = (ctypes.c_int * len(dims))(*dims)
    got = _lib().kanfet_wide_smem_bytes(B, ctypes.addressof(cdims),
                                        len(layers), C, int(bwd))
    want = 4 * cluster_floats(B, layers, C, bwd)
    if got != want:
        raise RuntimeError(f"kanfet_wide: the kernel lays out {got} bytes a "
                           f"CTA, the plan {want} (csrc/kanfet_wide.cu and "
                           "ops/kanfet_wide.py disagree)")
    return C


def _launch_fwd(ops, dims, gate, x0s, rtol, atol, max_steps, record):
    *w, ts = ops
    B, D = x0s.shape
    T, L = ts.shape[0], len(dims) // 3
    dev = x0s.device
    x0s = x0s.detach().contiguous()
    out = torch.empty((T, B, D), dtype=torch.float32, device=dev)
    recs = NC.new_records(max_steps, B, D, dev) if record else None
    r = recs if record else (None,) * 4
    C = _cluster(B, tuple(dims), False)
    cdims = (ctypes.c_int * len(dims))(*dims)
    wp = _pointers(w)
    NC.launch(_lib().kanfet_wide_fwd, NC.ptr(x0s), NC.ptr(ts),
              ctypes.addressof(wp), ctypes.addressof(cdims), L, NC.ptr(out),
              *(NC.ptr(t) for t in r), B, T, int(max_steps), float(rtol),
              float(atol), *gate, int(record), C, name="kanfet_wide_fwd",
              device=dev)
    kanfet_wide_fwd.launches += 1
    return out, recs


def _launch_bwd(ops, dims, gate, records, ct):
    *w, ts = ops
    T, B, D = ct.shape
    L = len(dims) // 3
    dev = ct.device
    if ts.shape[0] != T:
        raise ValueError(f"kanfet_wide_bwd: ct has {T} times, ts "
                         f"{ts.shape[0]}")
    NC.check_records(records, B, D, dev, "kanfet_wide_bwd")
    ct = ct.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in grad_weights(w)]
    x0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    C = _cluster(B, tuple(dims), True)
    cdims = (ctypes.c_int * len(dims))(*dims)
    wp, gp = _pointers(w), _pointers(grads)
    NC.launch(_lib().kanfet_wide_bwd, NC.ptr(ct), NC.ptr(ts),
              *(NC.ptr(t) for t in records), ctypes.addressof(wp),
              ctypes.addressof(gp), ctypes.addressof(cdims), L, NC.ptr(x0bar),
              B, T, *gate, C, name="kanfet_wide_bwd", device=dev)
    kanfet_wide_bwd.launches += 1
    return grads, x0bar


def kanfet_wide_fwd(weights: Sequence[torch.Tensor], cfg: KANConfig,
                    x0s: torch.Tensor, ts: torch.Tensor, *,
                    rtol: float = 1e-7, atol: float = 1e-9,
                    max_steps: int = 256, record: bool = True
                    ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel on the operands of ``wide_weights``:
    ``(trajectory (T, B, D), records or None)``, no autograd.  A CPU
    tensor gets ``record_solve_traj_reference`` of ``wide_field``."""
    dims = _dims(weights, cfg, x0s, ts, "kanfet_wide_fwd")
    if x0s.device.type == "cpu":
        traj, recs = NC.record_solve_traj_reference(
            wide_field(weights, cfg), x0s, ts, rtol=rtol, atol=atol,
            max_steps=max_steps)
        return traj, recs if record else None
    NC.check_cuda(x0s, "kanfet_wide_fwd")
    ops = _operands(weights, x0s, ts, "kanfet_wide_fwd")
    return _launch_fwd(ops, dims, _gate(cfg), x0s, rtol, atol, max_steps,
                       record)


def kanfet_wide_bwd(weights: Sequence[torch.Tensor], cfg: KANConfig,
                    x0s: torch.Tensor, ts: torch.Tensor,
                    records: NC.SolveRecords, ct: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reverse-replay kernel: the trajectory's cotangent ``ct`` (T, B,
    D) -> (gradients of the operands of ``grad_weights``; x0bar (B, D)).
    The kernel reads the recorded states and does not need ``x0s``; a CPU
    tensor gets ``replay_traj_vjp_reference``, which does."""
    dims = _dims(weights, cfg, x0s, ts, "kanfet_wide_bwd")
    if x0s.device.type == "cpu":
        return NC.replay_traj_vjp_reference(
            wide_field(weights, cfg), grad_weights(weights), x0s, ts,
            records, ct)
    NC.check_cuda(x0s, "kanfet_wide_bwd")
    ops = _operands(weights, x0s, ts, "kanfet_wide_bwd")
    return _launch_bwd(ops, dims, _gate(cfg), records, ct)


kanfet_wide_fwd.launches = 0
kanfet_wide_bwd.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel.
    The operands are saved as given, so autograd refuses a backward after
    they changed in place; the grids get no gradient."""

    @staticmethod
    def forward(ctx, opts, x0s, ts, *weights):
        dims, gate, rtol, atol, max_steps = opts
        ops = _operands(weights, x0s, ts, "kanfet_wide_solve_train")
        out, recs = _launch_fwd(ops, dims, gate, x0s, rtol, atol, max_steps,
                                record=True)
        ctx.dims, ctx.gate = dims, gate
        ctx.save_for_backward(*ops, *recs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        saved = ctx.saved_tensors
        n = len(saved) - 4
        grads, x0bar = _launch_bwd(saved[:n], ctx.dims, ctx.gate,
                                   NC.SolveRecords(*saved[n:]), ct)
        grads = iter(grads)
        full = [None if i % N_OPS == _GRID else next(grads)
                for i in range(n - 1)]
        need = ctx.needs_input_grad
        return (None, x0bar if need[1] else None, None,
                *(g if need[3 + i] else None for i, g in enumerate(full)))


def kanfet_wide_solve_train(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                            ts: torch.Tensor, *, rtol: float = 1e-7,
                            atol: float = 1e-9, max_steps: int = 256
                            ) -> torch.Tensor:
    """Solve the autonomous KANFET NODE from ``x0s`` (B, D) -> ``(B, T,
    D)`` at ``ts`` under one batch-shared step controller.  Autograd gives
    the gradients of every trainable parameter of ``params`` (none for
    the knot grids) and of ``x0s``, none for ``ts``: on CUDA through the
    kernel pair, on the CPU through the plain replay."""
    D = check_stack(cfg)
    _check_inputs(x0s, ts, D)
    if x0s.device.type == "cpu":
        return kanfet_wide_solve_train_reference(
            params, cfg, x0s, ts, rtol=rtol, atol=atol, max_steps=max_steps)
    NC.check_cuda(x0s, "kanfet_wide_solve_train")
    w = wide_weights(params)
    dims = _dims(w, cfg, x0s, ts, "kanfet_wide_solve_train")
    if _under_autograd(x0s, *w):
        out = _SolveTrain.apply(
            (dims, _gate(cfg), rtol, atol, max_steps), x0s, ts, *w)
    else:
        out = kanfet_wide_fwd(w, cfg, x0s, ts, rtol=rtol, atol=atol,
                              max_steps=max_steps, record=False)[0]
    return out.transpose(0, 1)
