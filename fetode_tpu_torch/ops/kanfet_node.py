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
* ``stack_geometry`` / ``smem_placement`` — the walk of any pure-KANFET
  stack that the kernels take (the layer table they read, and their
  refusals), and where each kernel keeps the parameters, the warps'
  scratch and the gradients: shared memory while they fit, else global
  memory (a pure function of the shapes).  ``check_layout`` holds the
  sizes against the ones the built library computes.

Forward only: the result carries no gradient.  The differentiable solve
is ``ops/kanfet_adjoint.py: kanfet_solve_train``, which shares this
kernel's solve (``csrc/kanfet_field.cuh``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fetode_tpu_torch.nn.kan import KAN, KANConfig, kan_apply, kan_state_init
from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5

# Trajectories (warps) a block solves: csrc/kanfet_field.cuh's kWarps,
# checked against the built library by ``check_layout``.
WARPS = 4
# The shared memory a block can use on the H100 (227 KB, past 48 KB only
# after the kernel opts in), and the largest D: lane d of a warp holds
# component d of the state.
SMEM_MAX_BYTES = 232448
MAX_D = 32

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
    """x0s (B, D); ts (T,), shared by every row, or (B, T), a row of times
    a trajectory."""
    if x0s.ndim != 2 or x0s.shape[1] != D or x0s.shape[0] == 0:
        raise ValueError(f"x0s must be (B, {D}) with B >= 1, got "
                         f"{tuple(x0s.shape)}")
    B = x0s.shape[0]
    if ts.ndim not in (1, 2) or ts.shape[-1] == 0 or (
            ts.ndim == 2 and ts.shape[0] != B):
        raise ValueError(f"ts must be (T,) or ({B}, T) with T >= 1, got "
                         f"{tuple(ts.shape)}")
    if ts.device != x0s.device:
        raise ValueError(f"x0s on {x0s.device} but ts on {ts.device}")


def ts_stride(ts: torch.Tensor) -> int:
    """The kernels' time operand stride: trajectory b reads its times at
    ``ts + b * stride``, 0 for one shared (T,) row, T for (B, T)."""
    return 0 if ts.ndim == 1 else ts.shape[1]


def kanfet_solve_reference(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                           ts: torch.Tensor, *, rtol: float = 1e-7,
                           atol: float = 1e-9,
                           max_steps: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``(B, D)`` initial conditions
    -> ``(B, T, D)`` trajectories, each row with its own step control —
    the contract of ``vmap(predict)`` in while mode; ``ts`` is (T,) or (B,
    T), as for ``kanfet_solve``.  Works in the dtype of ``x0s`` (the
    kernel is float32 only)."""
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


def stack_geometry(cfg: KANConfig) -> dict:
    """Walk a pure-KANFET stack for the kernels of ``csrc/kanfet_field.cuh``
    (any depth, widths, K per layer, knot count and spline order): its
    layer table (per layer: in, out, K and its offsets into the packed
    parameters, the gradient vector and the VJP's activation slots), the
    sizes the kernels need, and where each kernel keeps what
    (``smem_placement``).  Raises ValueError only where the JAX kernels'
    contract does (not pure KANFET, output width != input width), for
    per-layer spline order, grid, gate slope or alpha that differ from
    layer 0's (the JAX kernels take layer 0's for every layer;
    ``kanfet_config`` never makes such a stack), and for D > 32 (ROADMAP
    C, F4)."""
    D = _check_stack(cfg)
    cfgs = cfg.layers
    l0 = cfgs[0]
    for c in cfgs[1:]:
        if (c.spline_order, c.grid_size, c.ferro_gate_slope,
                c.ferro_alpha) != (l0.spline_order, l0.grid_size,
                                   l0.ferro_gate_slope, l0.ferro_alpha):
            raise ValueError("the KANFET kernels take one spline order, grid "
                             "size, ferro gate slope and alpha across layers "
                             "(layer 0's), as the JAX kernels do")
    if D > MAX_D:
        raise ValueError(f"the KANFET kernels hold the state one component "
                         f"a lane of a warp, D <= {MAX_D}; got D = {D} "
                         f"(ROADMAP C, F4)")
    order = l0.spline_order
    n_knots = l0.grid_size + 2 * order + 1
    C = n_knots - 1 - order
    table, p_off, g_off, a_off = [], 0, 0, 0
    for c in cfgs:
        i, o, K = c.in_features, c.out_features, c.ferro_num_basis
        table.append((i, o, K, p_off, g_off, a_off))
        p_off += o * i * (1 + C) + i * n_knots + 5 * i * o * K
        g_off += o * i * (1 + C) + 5 * i * o * K
        a_off += i
    maxw = max(max(c.in_features, c.out_features) for c in cfgs)
    maxin = max(c.in_features for c in cfgs)
    geo = dict(D=D, L=len(cfgs), order=order, n_knots=n_knots, C=C,
               gate=float(l0.ferro_gate_slope), alpha=float(l0.ferro_alpha),
               table=table, n_params=p_off, n_grad=g_off, maxw=maxw,
               sum_in=a_off, maxin=maxin,
               ferro_n=max(i * o * K for i, o, K, *_ in table),
               # csrc/kanfet_field.cuh: ws_fwd / ws_bwd (check_layout)
               ws_fwd=2 * maxw + maxin * (4 + order),
               ws_bwd=a_off + 2 * maxw + maxin * (6 + 2 * order))
    geo.update(smem_placement(geo))
    return geo


def smem_placement(geo: dict) -> dict:
    """Where each kernel keeps its data, from the shapes alone: for the
    forward solves (B.1 and B.2's forward) and for B.2's backward, whether
    the packed parameters, the warps' scratch and (backward) the warps'
    gradient vectors of a block of ``WARPS`` warps sit in its shared
    memory (True) or in global memory, and the shared bytes a block asks
    for.  Filled in order, each while it fits ``SMEM_MAX_BYTES``: the
    warps' scratch, then the parameters, then the gradients."""
    out = {}
    for kind, ws in (("fwd", geo["ws_fwd"]), ("bwd", geo["ws_bwd"])):
        used = 0
        place = {}
        for what, floats in (("scratch", WARPS * ws),
                             ("params", geo["n_params"]),
                             ("grads", WARPS * geo["n_grad"])):
            if what == "grads" and kind == "fwd":
                continue
            place[what] = used + 4 * floats <= SMEM_MAX_BYTES
            used += 4 * floats if place[what] else 0
        place["bytes"] = used
        out[kind] = place
    return out


@functools.lru_cache(maxsize=None)
def _library_layout(name: str, maxw: int, maxin: int, sum_in: int,
                    order: int) -> tuple:
    """(kWarps, ws_fwd, ws_bwd) as the library built from ``csrc/<name>.cu``
    computes them (kanfet_field.cuh: kanfet_layout)."""
    from fetode_tpu_torch.ops._build import load_library

    fn = load_library(name).kanfet_layout
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    fn(maxw, maxin, sum_in, order, out)
    return tuple(out)


def check_layout(name: str, geo: dict) -> None:
    """Raise unless the kernel library ``name`` lays out a block's warps
    and their scratch as ``stack_geometry`` sized them (``WARPS``,
    ``ws_fwd``, ``ws_bwd``): the buffers and shared bytes the wrapper
    allocates are only as right as that agreement."""
    got = _library_layout(name, geo["maxw"], geo["maxin"], geo["sum_in"],
                          geo["order"])
    want = (WARPS, geo["ws_fwd"], geo["ws_bwd"])
    if got != want:
        raise RuntimeError(f"{name}: the library's (kWarps, ws_fwd, ws_bwd) "
                           f"= {got}, the wrapper's {want}")


def _geo_ints(geo: dict, kind: str):
    """The host int array the C entry points read (kanfet_field.cuh: Geo)."""
    p = geo[kind]
    vals = [geo["L"], geo["D"], geo["order"], geo["n_knots"],
            geo["n_params"], geo["n_grad"], geo["maxw"], geo["sum_in"],
            geo["ws_" + kind], int(p["params"]), int(p["scratch"]),
            int(p.get("grads", False)), p["bytes"]]
    return (ctypes.c_int * len(vals))(*vals)


def _dims_tensor(geo: dict, device: torch.device) -> torch.Tensor:
    """The layer table on the device, (L, 6) int32, copied from pinned
    host memory without a wait: a blocking copy would hold the host until
    the stream drained, and the kernels' launches would no longer queue."""
    host = torch.tensor(geo["table"], dtype=torch.int32).pin_memory()
    return host.to(device, non_blocking=True)


def _warp_scratch(geo: dict, kind: str, B: int,
                  device: torch.device) -> torch.Tensor:
    """Global warp scratch when it does not fit shared memory (else an
    empty tensor the kernel never reads)."""
    n = 0
    if not geo[kind]["scratch"]:
        n = -(-B // WARPS) * WARPS * geo["ws_" + kind]
    return torch.empty(n, dtype=torch.float32, device=device)


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
    fn.argtypes = [P] * 6 + [ctypes.POINTER(I)] + [I] * 4 + [F] * 5 + [P]
    fn.restype = ctypes.c_int
    return fn


def kanfet_solve(params: KAN, cfg: KANConfig, x0s: torch.Tensor,
                 ts: torch.Tensor, *, rtol: float = 1e-7, atol: float = 1e-9,
                 max_steps: int = 512) -> torch.Tensor:
    """Solve the autonomous KANFET NODE for a batch of initial conditions.

    Args:
      params/cfg: a ``KAN`` whose every layer has the ferro branch and no
        logistic branch (the KANFET contract), and its config: any depth,
        widths, K, grid and order, one order, grid, gate slope and alpha
        across layers, D <= 32 (``stack_geometry``).
      x0s: (B, D) float32 initial conditions; ts: (T,) float32 output
        times shared by every trajectory, or (B, T), trajectory b's times
        in row b (multiple shooting's segments); a row's first time is
        its start (any order after it: every accepted step tests all T
        times).

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
    B, T = x0s.shape[0], ts.shape[-1]
    dev = x0s.device
    geo = stack_geometry(cfg)
    check_layout(_KERNEL_NAME, geo)
    packed = _pack_for(params, cfg, geo, dev)
    dims = _dims_tensor(geo, dev)
    scratch = _warp_scratch(geo, "fwd", B, dev)
    out = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(
        x0s.data_ptr(), ts.data_ptr(), packed.data_ptr(), dims.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), _geo_ints(geo, "fwd"), B, T,
        ts_stride(ts), int(max_steps), float(rtol), float(atol), geo["gate"],
        geo["alpha"], 1.0 - geo["alpha"], stream)
    if rc != 0:
        raise RuntimeError(f"kanfet_node kernel launch failed: CUDA error "
                           f"{rc}")
    kanfet_solve.launches += 1
    return out


kanfet_solve.launches = 0
