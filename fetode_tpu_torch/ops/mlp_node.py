"""Whole-solve ECG KanFetNODE 'mlp' latent field: dopri5 over [0, 1]
with batch-shared step control and its discrete adjoint, as two CUDA
kernels.

Counterpart of ``fetode_tpu/ops/pallas_mlp_node.py:
make_mlp_node_solver`` (the TPU kernels ``_make_fwd_kernel`` :150 and
``_make_bwd_kernel`` :173, called at :280 and :308).  The CUDA source is
``fetode_tpu_torch/csrc/mlp_node.cu`` on the shared scaffold
``csrc/node_common.cuh`` (its cooperative grid and fused-stage hook);
its header gives the design and what bounds it.  ``slice_plan`` is how
the kernels cut each layer's parameters into tiles over the grid's
blocks (the CUDA ``layer_plan``, checked against it once a shape), and
``smem_floats`` a block's shared memory.  With L = D*K and C = 8 cubic
B-spline columns on 12 knots a feature:

    h   = LayerNorm(y; ln_scale, ln_bias)            (B, D)
    hb  = h_bound tanh(h / h_bound)
    phi = sigmoid(2 sigmoid(a (hb[l / K] - b)))       (B, L)
    y1  = silu(phi) bw1^T + sum_c B_c(phi) sw1_c^T    (B, H)  KAN layer 1
    y2  = silu(y1) bw2^T + sum_c B_c(y1) sw2_c^T      (B, H)  KAN layer 2
    dy  = eff (silu(y2) out_w^T + out_b)              (B, D)

The kernels take the scaled spline weights ``sw = spline_weight *
spline_scaler`` and ``eff = scale * softplus(log_alpha)``, formed per
call outside them (``mlp_weights``); autograd carries their gradients
back to the scaler, the spline weights, ``scale`` and ``log_alpha``, as
the JAX package applies those chain rules outside its kernel.  The knot
grids are buffers and get no gradient.  Only the KAN geometry that
``KanFetNODESpec.kan_cfg`` builds is supported: two layers [L, H, H],
grid 5, order 3, a standalone scaler, no other branch.

* ``mlp_node_solve`` — the public solve of the model's parameters.  On
  CUDA, under autograd, a ``torch.autograd.Function`` launches
  ``mlp_node_fwd`` (which records every attempt) and, in its backward,
  ``mlp_node_bwd``; without autograd the forward kernel alone, recording
  nothing.  On the CPU it takes the plain version.
* ``mlp_node_fwd`` / ``mlp_node_bwd`` — the kernel wrappers on the 13
  operands of ``mlp_weights``, each with a launch counter
  (``.launches``).  For CPU tensors they take the plain versions
  ``record_solve_reference`` and ``replay_vjp_reference`` of
  ``ops/node_common.py`` around ``mlp_field``; they never fall back from
  a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.nn.mlp import layer_norm
from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.bsplines import bspline_basis
from fetode_tpu_torch.ops.logistic import LogisticParams, logistic_basis
from fetode_tpu_torch.solvers.dopri5 import _under_autograd

_KERNEL_NAME = "mlp_node"
GRID_SIZE, ORDER = 5, 3
N_COEFF = GRID_SIZE + ORDER               # 8 basis columns
N_KNOTS = GRID_SIZE + 2 * ORDER + 1       # 12 knots a feature
N_WEIGHTS = 13
# Positions of the knot grids in ``mlp_weights``: they get no gradient.
_GRIDS = (4, 7)
TILE_ROWS = 16              # output rows of a tile
COLS2, COLS3 = 16, 32       # input columns of a layer-2 / output-layer tile
CHUNK = 16                  # batch rows a tile pass takes
WARPS = 8                   # a block of the cooperative grid
BLOCKS_PER_SM = 2
SMEM_BUDGET = 232448 - 2048  # dynamic shared-memory bytes a block may take
# The forward's form follows the batch (``forward_form``); the same bits
# in either form.
FUSE_ROWS = 16


def forward_form(B: int) -> int:
    """0 up to ``FUSE_ROWS`` rows: a tile's block forms one chunk's inputs
    with all its threads, the layer norm and the crossing sums inside the
    consumers' prologues (three grid barriers an evaluation); 1 past it:
    the layer norm's tanh and the crossing sums, y1 and y2, formed once in
    phases of their own, then each warp takes its own groups of 4 rows
    through a tile, the replicas of a layer's tiles sharing them (six)."""
    return int(B > FUSE_ROWS)


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def _row_stride(k: int) -> int:
    s = _round(k, 4)
    while s % 32 != 4:
        s += 4
    return s


class SlicePlan(NamedTuple):
    """One layer (O outputs, I inputs, F coefficients an element) cut into
    tiles of RG rows by CG columns: NR row groups by NC column chunks,
    tile q = rg * NC + cc; ``rep`` = G // tiles replicas of each where the
    layer has fewer tiles than blocks, copy v = k tiles + q (replica k of
    tile q) on block v mod G, which holds at most ``per_block`` copies; KP
    the tile's contraction (CG F to a multiple of 4), SW its rows' stride
    in shared memory.  Replica 0 runs the backward and the forward up to
    ``FUSE_ROWS`` rows; past them the replicas share the forward's groups
    of 4 rows, group g to replica g mod rep (``forward_form``)."""

    RG: int
    CG: int
    NR: int
    NC: int
    tiles: int
    per_block: int
    KP: int
    SW: int
    rep: int

    def tile(self, q: int, O: int, I: int) -> Tuple[range, range]:
        """(output rows, input columns) of tile q."""
        rg, cc = divmod(q, self.NC)
        return (range(rg * self.RG, min(O, (rg + 1) * self.RG)),
                range(cc * self.CG, min(I, (cc + 1) * self.CG)))


def slice_plan(G: int, O: int, I: int, F: int, RG: int,
               CG: int) -> SlicePlan:
    """The kernels' cut of one layer (``csrc/mlp_node.cu: layer_plan``).
    A forward row's sum is its NC tiles' partials added in tile order
    (each tile's sum over its columns' F coefficients in the products'
    fixed order); an input's cotangent is its NR tiles' partials in
    order."""
    if min(G, O, I, F, RG, CG) < 1:
        raise ValueError(f"slice_plan: G, O, I, F, RG, CG must be >= 1, got "
                         f"{(G, O, I, F, RG, CG)}")
    CG = min(CG, I)
    NR, NC = -(-O // RG), -(-I // CG)
    KP = _round(CG * F, 4)
    rep = max(1, G // (NR * NC))
    return SlicePlan(RG, CG, NR, NC, NR * NC, -(-NR * NC * rep // G),
                     KP, _row_stride(KP), rep)


def layer_plans(G: int, D: int, K: int, H: int) -> List[SlicePlan]:
    """The three layers' plans, tiles of 16 rows: layer 1 (H, D*K, 9
    coefficients; two features' 2 K columns a tile), layer 2 (H, H, 9; 16
    columns), the output layer (D, H, 1; 32 columns).  The kernels place
    the output layer's copy v on block (v + layer 2's tiles) mod G, so
    that its replica 0 and layer 2's sit on other blocks."""
    return [slice_plan(G, H, D * K, N_COEFF + 1, TILE_ROWS, 2 * K),
            slice_plan(G, H, H, N_COEFF + 1, TILE_ROWS, COLS2),
            slice_plan(G, D, H, 1, TILE_ROWS, COLS3)]


def smem_floats(G: int, D: int, K: int, H: int, bwd: bool) -> int:
    """A block's dynamic shared memory in floats (``csrc/mlp_node.cu:
    make_geo``): its tiles' parameters (and, backward, their gradients,
    the running sums and the output layer's columns), the chunk's inputs,
    products' partials and row buffers."""
    plans = layer_plans(G, D, K, H)
    tiles = sum(p.per_block * p.RG * p.SW for p in plans)
    KPm = max(p.KP for p in plans)
    CG4 = _round(plans[0].CG, 4)
    MS = max(CG4, _round(plans[1].CG, 4))
    at = tiles
    # layer 1's and 2's copies' knots, layer 1's with its mixer's slope and
    # centre
    at += plans[0].per_block * (_round(plans[0].CG * N_KNOTS, 4) + 2 * CG4) \
        + plans[1].per_block * _round(plans[1].CG * N_KNOTS, 4)
    if bwd:
        at += tiles + plans[0].per_block * 2 * CG4 \
            + plans[2].per_block * plans[2].RG + plans[1].per_block * 4
        at = _round(at, 4) + plans[1].per_block * plans[1].RG * (D | 1)
        at = _round(at, 4)
    # the chunk's inputs (backward: and their cotangents) or each warp's
    # 4 rows of inputs; backward: the column products' partials, the rows'
    # cotangents
    at += max(CHUNK * KPm * (2 if bwd else 1), WARPS * 4 * KPm)
    if bwd:
        at += 4 * max(KPm, WARPS * 64) + CHUNK * TILE_ROWS
    at += max(CHUNK, WARPS) * _round(max(D, 2 * N_COEFF), 4)
    return at + 3 * CHUNK * MS


def _scaled_spline(layer) -> torch.Tensor:
    return layer.spline_weight * layer.spline_scaler[..., None]


def check_geometry(kan, D: int, K: int, H: int) -> None:
    """The kernels' KAN: two layers [D*K, H, H], grid 5, order 3, a
    standalone spline scaler and no logistic or ferro branch."""
    cfgs = [layer.cfg for layer in kan.layers]
    dims = [(c.in_features, c.out_features) for c in cfgs]
    if dims != [(D * K, H), (H, H)] or any(
            c.grid_size != GRID_SIZE or c.spline_order != ORDER
            or not c.standalone_spline_scaler or c.logistic_num_basis
            or c.ferro_num_basis for c in cfgs):
        raise NotImplementedError(
            f"mlp_node: the kernels take the init-time KAN of "
            f"KanFetNODESpec.kan_cfg ([{D * K}, {H}, {H}], grid {GRID_SIZE}, "
            f"order {ORDER}, standalone scaler, no other branch), got layers "
            f"{dims} at grid {[c.grid_size for c in cfgs]}; a grid refit "
            "(nn/kan.py: kan_update_grid) keeps that geometry and only moves "
            "the knots, which the kernels read as operands")


def mlp_weights(params) -> List[torch.Tensor]:
    """The kernels' 13 operands from a 'mlp' ``KanFetNODEParams``, in
    kernel order: ln_scale, ln_bias (D); mixer a, b (D, K); layer 1's grid
    (L, 12), base weight (H, L), scaled spline weight (H, L, 8); layer 2's
    grid (H, 12), base weight (H, H), scaled spline weight (H, H, 8);
    out_w (D, H), out_b (D); eff (1,).  The scaled weights and eff are new
    tensors on every call, differentiable in the parameters."""
    l1, l2 = params.kan.layers
    eff = params.scale * F.softplus(params.log_alpha)
    return [params.ln_scale, params.ln_bias, params.field_mixer.a,
            params.field_mixer.b, l1.grid, l1.base_weight, _scaled_spline(l1),
            l2.grid, l2.base_weight, _scaled_spline(l2), params.out_w,
            params.out_b, eff.reshape(1)]


def grad_weights(weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The 11 operands the backward kernel returns gradients of: all but
    the two knot grids."""
    return [w for i, w in enumerate(weights) if i not in _GRIDS]


def mlp_field(weights: Sequence[torch.Tensor],
              h_bound: float = 1.0) -> NC.Field:
    """The 'mlp' field as a callable on (B, D) over the operands of
    ``mlp_weights`` (``models/ecg.py: kanfet_node_field``)."""
    ls, lb, a, b, g1, bw1, sw1, g2, bw2, sw2, ow, ob, eff = weights
    mixer = LogisticParams(a, b)

    def layer(x, g, bw, sw):
        bases = bspline_basis(x, g, ORDER).reshape(x.shape[0], -1)
        return F.silu(x) @ bw.T + bases @ sw.reshape(sw.shape[0], -1).T

    def field(y):
        h = h_bound * torch.tanh(layer_norm(y, ls, lb) / h_bound)
        phi = torch.sigmoid(logistic_basis(mixer, h)).reshape(y.shape[0], -1)
        z = F.silu(layer(layer(phi, g1, bw1, sw1), g2, bw2, sw2))
        return eff * (z @ ow.T + ob)
    return field


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mlp_node_fwd.argtypes = [P] * 8 + [I] * 5 + [F32] * 3 + [I, I, P]
    lib.mlp_node_bwd.argtypes = [P] * 9 + [I] * 4 + [F32, I, P]
    lib.mlp_node_fwd.restype = lib.mlp_node_bwd.restype = ctypes.c_int
    lib.mlp_node_work_floats.argtypes = [I] * 5
    lib.mlp_node_work_floats.restype = ctypes.c_longlong
    lib.mlp_node_slice_plan.argtypes = [I] * 6 + [P]
    lib.mlp_node_slice_plan.restype = None
    lib.mlp_node_smem_floats.argtypes = [I] * 6
    lib.mlp_node_smem_floats.restype = ctypes.c_longlong
    lib.mlp_node_grid.argtypes = []
    lib.mlp_node_grid.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _check_plan(D: int, K: int, H: int) -> None:
    """Raise unless the library's tile plans and shared memory are
    ``layer_plans``' and ``smem_floats``' at the card's grid and at one
    block an SM (once a shape)."""
    G2 = _lib().mlp_node_grid()
    for G in (G2, G2 // BLOCKS_PER_SM):
        for p, (O, I, F) in zip(layer_plans(G, D, K, H), (
                (H, D * K, N_COEFF + 1), (H, H, N_COEFF + 1), (D, H, 1))):
            got = (ctypes.c_longlong * 9)()
            _lib().mlp_node_slice_plan(G, O, I, F, p.RG, p.CG,
                                       ctypes.addressof(got))
            if list(got) != list(p):
                raise RuntimeError(f"mlp_node: the library's plan {list(got)}"
                                   f" of ({O}, {I}, {F}) at G={G} is not "
                                   f"slice_plan's {list(p)}")
        for bwd in (0, 1):
            got = _lib().mlp_node_smem_floats(G, D, K, H, bwd, 0)
            if got != smem_floats(G, D, K, H, bool(bwd)):
                raise RuntimeError(f"mlp_node: the library's shared memory "
                                   f"{got} floats at G={G}, bwd={bwd} is not "
                                   f"smem_floats' "
                                   f"{smem_floats(G, D, K, H, bool(bwd))}")


def _dims(weights, h0, name) -> Tuple[int, int, int]:
    """(D, K, H), checked against every operand's shape."""
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"{name}: expected the {N_WEIGHTS} operands of "
                         f"mlp_weights, got {len(weights)}")
    D, K = weights[2].shape
    H, L = weights[5].shape
    NC.check_state(h0, D, name)
    want = [(D,), (D,), (D, K), (D, K), (L, N_KNOTS), (H, L),
            (H, L, N_COEFF), (H, N_KNOTS), (H, H), (H, H, N_COEFF), (D, H),
            (D,), (1,)]
    got = [tuple(w.shape) for w in weights]
    if L != D * K or got != want:
        raise ValueError(f"{name}: operand shapes {got}, expected {want} "
                         f"(D={D}, K={K}, H={H}, L=D*K)")
    return D, K, H


def _operands(weights, h0, name) -> List[torch.Tensor]:
    """The kernels' float32 operands, checked."""
    _dims(weights, h0, name)
    return [NC.kernel_operand(w, h0.device, f"{name} operand {i}")
            for i, w in enumerate(weights)]


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _work(B, D, K, H, device):
    _check_plan(D, K, H)
    n = _lib().mlp_node_work_floats(B, D, K, H, forward_form(B))
    return torch.empty(n, dtype=torch.float32, device=device)


def _launch_fwd(ops, h0, h_bound, rtol, atol, max_steps, record):
    B, D = h0.shape
    K, H = ops[2].shape[1], ops[5].shape[0]
    dev = h0.device
    h0 = h0.detach().contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    recs = NC.new_records(max_steps, B, D, dev) if record else None
    r = recs if record else (None,) * 4
    w, work = _pointers(ops), _work(B, D, K, H, dev)
    NC.launch(_lib().mlp_node_fwd, NC.ptr(h0), ctypes.addressof(w),
              NC.ptr(out), *(NC.ptr(t) for t in r), NC.ptr(work), B, D, K,
              H, int(max_steps), float(rtol), float(atol), float(h_bound),
              int(record), forward_form(B), name="mlp_node_fwd",
              device=dev)
    mlp_node_fwd.launches += 1
    return out, recs


def _launch_bwd(ops, records, hbar, h_bound):
    B, D = hbar.shape
    K, H = ops[2].shape[1], ops[5].shape[0]
    dev = hbar.device
    NC.check_records(records, B, D, dev, "mlp_node_bwd")
    hbar = hbar.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in grad_weights(ops)]
    h0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    w, g = _pointers(ops), _pointers(grads)
    work = _work(B, D, K, H, dev)
    NC.launch(_lib().mlp_node_bwd, NC.ptr(hbar),
              *(NC.ptr(t) for t in records), ctypes.addressof(w),
              ctypes.addressof(g), NC.ptr(h0bar), NC.ptr(work), B, D, K, H,
              float(h_bound), forward_form(B), name="mlp_node_bwd",
              device=dev)
    mlp_node_bwd.launches += 1
    return grads, h0bar


def mlp_node_fwd(weights: Sequence[torch.Tensor], h0: torch.Tensor, *,
                 h_bound: float = 1.0, rtol: float = 1e-2,
                 atol: float = 1e-3, max_steps: int = 16,
                 record: bool = True
                 ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel on the operands of ``mlp_weights``: ``(final
    state (B, D), records or None)``, no autograd.  A CPU tensor gets
    ``record_solve_reference``."""
    if h0.device.type == "cpu":
        _dims(weights, h0, "mlp_node_fwd")
        hT, recs = NC.record_solve_reference(
            mlp_field(weights, h_bound), h0, rtol=rtol, atol=atol,
            max_steps=max_steps)
        return hT, recs if record else None
    NC.check_cuda(h0, "mlp_node_fwd")
    ops = _operands(weights, h0, "mlp_node_fwd")
    return _launch_fwd(ops, h0, h_bound, rtol, atol, max_steps, record)


def mlp_node_bwd(weights: Sequence[torch.Tensor], h0: torch.Tensor,
                 records: NC.SolveRecords, hbar: torch.Tensor, *,
                 h_bound: float = 1.0
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reverse-replay kernel: the final-state cotangent ``hbar`` ->
    (gradients of the 11 operands of ``grad_weights``; h0bar).  The kernel
    reads the recorded states and does not need ``h0``; a CPU tensor gets
    ``replay_vjp_reference``, which does."""
    if h0.device.type == "cpu":
        _dims(weights, h0, "mlp_node_bwd")
        return NC.replay_vjp_reference(mlp_field(weights, h_bound),
                                       grad_weights(weights), h0, records,
                                       hbar)
    NC.check_cuda(h0, "mlp_node_bwd")
    ops = _operands(weights, h0, "mlp_node_bwd")
    return _launch_bwd(ops, records, hbar, h_bound)


mlp_node_fwd.launches = 0
mlp_node_bwd.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel.
    The 13 operands are saved as given, so autograd refuses a backward
    after they changed in place; the grids get no gradient."""

    @staticmethod
    def forward(ctx, opts, h0, *weights):
        h_bound, rtol, atol, max_steps = opts
        ops = _operands(weights, h0, "mlp_node_solve")
        out, recs = _launch_fwd(ops, h0, h_bound, rtol, atol, max_steps,
                                record=True)
        ctx.h_bound = h_bound
        ctx.save_for_backward(*weights, *recs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, hbar):
        saved = ctx.saved_tensors
        ops = [t.detach().contiguous() for t in saved[:N_WEIGHTS]]
        grads, h0bar = _launch_bwd(ops, NC.SolveRecords(*saved[N_WEIGHTS:]),
                                   hbar, ctx.h_bound)
        grads = iter(grads)
        full = [None if i in _GRIDS else next(grads)
                for i in range(N_WEIGHTS)]
        need = ctx.needs_input_grad
        return (None, h0bar if need[1] else None,
                *(g if need[2 + i] else None for i, g in enumerate(full)))


def mlp_node_solve(params, h0: torch.Tensor, spec) -> torch.Tensor:
    """Solve the ``KanFetNODESpec`` (field='mlp') latent ODE over [0, 1]
    from ``h0`` (B, D) -> the final state.  ``params`` is the model's
    parameter module.  Autograd gives the gradients of the field's
    parameters and of ``h0``: on CUDA through the kernel pair, on the CPU
    through the plain replay."""
    check_geometry(params.kan, spec.latent_dim, spec.num_basis,
                   spec.ode_hidden)
    w = mlp_weights(params)
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    grad = _under_autograd(h0, *w)
    if h0.device.type == "cpu":
        _dims(w, h0, "mlp_node_solve")
        field = mlp_field(w, spec.h_bound)
        if grad:
            return NC.solve_reference(field, h0, **opts)
        return NC.record_solve_reference(field, h0, **opts)[0]
    NC.check_cuda(h0, "mlp_node_solve")
    if grad:
        return _SolveTrain.apply(
            (spec.h_bound, spec.rtol, spec.atol, spec.max_steps), h0, *w)
    return mlp_node_fwd(w, h0, h_bound=spec.h_bound, record=False,
                        **opts)[0]


def mlp_node_solve_sharded(params, h0: torch.Tensor, spec, mesh, *,
                           axis: str = "data") -> torch.Tensor:
    """``mlp_node_solve`` over a mesh (counterpart of
    ``pallas_mlp_node_solve_sharded``): every rank solves its block of
    ``h0``'s rows over ``axis`` with that block's own step control and
    returns the global final states; the parameters' gradients are summed
    over the ranks (``parallel.shard_map_rows``).  ``h0``'s batch must
    divide the axis size."""
    from fetode_tpu_torch.parallel.collectives import shard_map_rows

    return shard_map_rows(lambda p, h: mlp_node_solve(p, h, spec),
                          mesh, params, h0, axis=axis)
