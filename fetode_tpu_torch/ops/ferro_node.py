"""Whole-solve ECG ferro MLP-NODE latent field: dopri5 over [0, 1] with
batch-shared step control and its discrete adjoint, as two CUDA
kernels, with optional frozen device noise.

Counterpart of ``fetode_tpu/ops/pallas_ferro_node.py:
make_ferro_node_solver`` (the TPU kernels ``_make_fwd_kernel`` :87 and
``_make_bwd_kernel`` :150, and their batch-vectorized layout :259 /
:309, another TPU layout of the same function).  The CUDA source is
``fetode_tpu_torch/csrc/ferro_node.cu`` on the shared scaffold
``csrc/node_common.cuh`` (its grid policy and fused-stage hook); its
header gives the design and what bounds it.  ``slice_plan`` is how the
kernels cut each layer's parameters into tiles over the grid's blocks
(the CUDA ``slice_plan``, checked against it once a shape).  The field maps D -> hidden -> D through two ferro layers with the
fresh frozen hysteresis state, a tanh bound before and a tanh link
between them, and a clip at the end.  The kernel's field differs from
the eager model field (``models/ecg.py: kanfet_mlp_node_field``) in two
places, as in the JAX package: it has no ``nan_to_num``, and its clip
passes the gradient strictly inside (-clip, clip).

Device noise is frozen per solve: ``frozen_solve_noise`` draws it once,
in the (B, in, out, K) shape of ``ops/ferro.py: ferro_basis``, and hands
it to the kernels as two (B, out, in*K) operands with the scale
multiplied in; only the coef gradient sees it.

* ``ferro_node_solve`` — the public solve.  On CUDA, under autograd, a
  ``torch.autograd.Function`` over ``ferro_node_fwd`` (with records) and
  ``ferro_node_bwd``; without autograd the forward kernel alone.  On the
  CPU the plain version.
* ``ferro_node_fwd`` / ``ferro_node_bwd`` — the kernel wrappers with
  launch counters (``.launches``); for CPU tensors the plain versions of
  ``ops/node_common.py`` around ``ferro_field``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.ferro import FerroConfig
from fetode_tpu_torch.solvers.dopri5 import _under_autograd
from fetode_tpu_torch.utils.init import normal

_KERNEL_NAME = "ferro_node"
_NAMES = ("k", "ec", "ps", "bias", "coef")
MAX_WIDTH = 512      # the kernel's bound on the latent and hidden widths
TILE_LANES = 32      # (row, column) pairs of a parameter tile


class SlicePlan(NamedTuple):
    """One layer (O outputs, I inputs, K bases) cut into tiles of RG rows
    by CG columns (RG * CG = 32, every k of each column): NR row groups
    by NC column chunks, tile q = rg * NC + cc on block q mod G, which
    holds at most ``per_block`` tiles."""

    RG: int
    CG: int
    NR: int
    NC: int
    tiles: int
    per_block: int

    def tile(self, q: int, O: int, I: int) -> Tuple[range, range]:
        """(output rows, input columns) of tile q."""
        rg, cc = divmod(q, self.NC)
        return (range(rg * self.RG, min(O, (rg + 1) * self.RG)),
                range(cc * self.CG, min(I, (cc + 1) * self.CG)))


def slice_plan(G: int, O: int, I: int, K: int) -> SlicePlan:
    """The kernels' cut of one layer (``csrc/ferro_node.cu: slice_plan``):
    RG the power of two that makes max(NR, NC) least, the smaller on a
    tie.  A forward row's sum is its NC tiles' partials added in tile
    order, each tile's a fixed shuffle tree over its columns of sums over
    k in order; an input column's cotangent is its NR tiles' partials in
    order, each a shuffle tree over the tile's rows."""
    if min(G, O, I, K) < 1:
        raise ValueError(f"slice_plan: G, O, I, K must be >= 1, got "
                         f"{(G, O, I, K)}")
    best = None
    rg = 1
    while rg <= TILE_LANES:
        cg = TILE_LANES // rg
        nr, nc = -(-O // rg), -(-I // cg)
        if best is None or max(nr, nc) < max(best[2], best[3]):
            best = (rg, cg, nr, nc)
        rg *= 2
    rg, cg, nr, nc = best
    return SlicePlan(rg, cg, nr, nc, nr * nc, -(-nr * nc // G))


Noise = Optional[Tuple[torch.Tensor, torch.Tensor]]


class FerroNodeConfig(NamedTuple):
    """The static numbers of the field and the solve."""

    gate_slope: float = 10.0
    alpha: float = 0.8
    h_bound: float = 1.0
    dh_clip: float = 50.0
    rtol: float = 1e-2
    atol: float = 1e-3
    max_steps: int = 16


def ferro_node_config(spec) -> FerroNodeConfig:
    """The config of a ``KanFetMLPNODESpec``."""
    c1 = spec.fc1_cfg
    return FerroNodeConfig(c1.gate_slope, c1.alpha, spec.h_bound,
                           spec.dh_clip, spec.rtol, spec.atol, spec.max_steps)


def kernel_layout(p: torch.Tensor) -> torch.Tensor:
    """A ferro parameter (in, out, K) -> the kernel's (out, in*K), column
    l = i*K + k."""
    i, o, k = p.shape
    return p.permute(1, 0, 2).reshape(o, i * k)


def basis_layout(nz: torch.Tensor, in_dim: int) -> torch.Tensor:
    """A kernel-layout noise block (B, out, in*K) -> the basis shape
    (B, in, out, K) of ``ferro_basis``."""
    B, o, L = nz.shape
    return nz.reshape(B, o, in_dim, L // in_dim).permute(0, 2, 1, 3)


def frozen_solve_noise(generator: torch.Generator, B: int, cfg1: FerroConfig,
                       cfg2: FerroConfig, *, noise_std=None,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the frozen per-solve device noise of both layers: a standard
    normal (B, in, out, K) per layer from ``generator`` (layer 1 first),
    times the noise std (``noise_std`` overrides each layer's
    ``cfg.noise_std``), in the kernel's (B, out, in*K) layout.  The eager
    solve adds the same draws (``basis_layout``), so the kernel and the
    eager path compute one function."""
    out = []
    for cfg in (cfg1, cfg2):
        n = normal(generator, (B, cfg.in_dim, cfg.out_dim, cfg.num_basis),
                   device=device)
        std = cfg.noise_std if noise_std is None else noise_std
        out.append((std * n.permute(0, 2, 1, 3)).reshape(
            B, cfg.out_dim, cfg.in_dim * cfg.num_basis).contiguous())
    return out[0], out[1]


def ferro_field(fc1, fc2, cfg: FerroNodeConfig,
                noise: Noise = None) -> NC.Field:
    """The kernel's field as a callable on (B, D), in the kernel's layout
    and arithmetic (``_ferro_rows``): the plain version of both kernels.
    ``fc1``, ``fc2`` are ``FerroParams`` modules (each (in, out, K))."""
    g, alpha = cfg.gate_slope, cfg.alpha
    layers = [([kernel_layout(getattr(p, n)) for n in _NAMES], p.k.shape[2])
              for p in (fc1, fc2)]
    nzs = noise if noise is not None else (None, None)

    def layer(x, w, K, nz):
        fk, fec, fps, fbias, fcoef = w
        xf = x.repeat_interleave(K, dim=1)[:, None, :]          # (B, 1, L)
        mu = torch.sigmoid(g * xf)
        cn = torch.sigmoid(g * (-xf - fec))
        beta = alpha + (1.0 - alpha) * (1.0 - 2.0 * ((1.0 - mu) * cn))
        fb = fps * torch.tanh(fk * (xf + fec * beta)) + fbias
        if nz is not None:
            fb = fb + nz
        return (fb * fcoef).sum(-1)                             # (B, out)

    def field(y):
        hb = cfg.h_bound * torch.tanh(y * (1.0 / cfg.h_bound))
        z = torch.tanh(layer(hb, *layers[0], nzs[0]))
        dh = layer(z, *layers[1], nzs[1])
        c = cfg.dh_clip
        # The kernel's clip: the gradient passes strictly inside (-c, c).
        return torch.where((dh > -c) & (dh < c), dh, dh.detach().clamp(-c, c))
    return field


def _weights(fc1, fc2) -> List[torch.Tensor]:
    return [getattr(p, n) for p in (fc1, fc2) for n in _NAMES]


@functools.lru_cache(maxsize=None)
def _lib():
    from fetode_tpu_torch.ops._build import load_library

    lib = load_library(_KERNEL_NAME)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ferro_node_fwd.argtypes = [P] * 11 + [I] * 6 + [F] * 8 + [I, P]
    lib.ferro_node_bwd.argtypes = [P] * 13 + [I] * 5 + [F] * 6 + [P]
    lib.ferro_node_fwd.restype = lib.ferro_node_bwd.restype = ctypes.c_int
    lib.ferro_node_work_floats.argtypes = [I] * 6
    lib.ferro_node_work_floats.restype = ctypes.c_longlong
    lib.ferro_node_slice_plan.argtypes = [I] * 4 + [P]
    lib.ferro_node_slice_plan.restype = None
    lib.ferro_node_grid.argtypes = []
    lib.ferro_node_grid.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _check_plan(device_index: int, D: int, H: int, K1: int, K2: int) -> None:
    """Raise unless the library cuts both layers as ``slice_plan`` does,
    at the grid the kernels take on this card (once a shape)."""
    G = _lib().ferro_node_grid()
    for G_ in sorted({G, max(1, G // 2)}):   # the grid, and one block an SM
        for O, I, K in ((H, D, K1), (D, H, K2)):
            got = (ctypes.c_longlong * 6)()
            _lib().ferro_node_slice_plan(G_, O, I, K, ctypes.addressof(got))
            want = list(slice_plan(G_, O, I, K))
            if list(got) != want:
                raise RuntimeError(f"ferro_node: the library's tile plan "
                                   f"{list(got)} for G={G_}, (O, I, K) = "
                                   f"{(O, I, K)} is not slice_plan's {want}")


def _dims(fc1, fc2, h0, name):
    """(D, H, K1, K2), checked: fc1 maps D -> H and fc2 H -> D."""
    D, H, K1 = fc1.k.shape
    H2, D2, K2 = fc2.k.shape
    if (H2, D2) != (H, D):
        raise ValueError(f"{name}: the field must map D -> hidden -> D, got "
                         f"fc1 {tuple(fc1.k.shape)}, fc2 {tuple(fc2.k.shape)}")
    NC.check_state(h0, D, name)
    return D, H, K1, K2


def _pack(weights, device, name) -> List[torch.Tensor]:
    """The ten arrays of ``_weights``, each layer's five in kernel layout
    and stacked: two (5, out, L) operands."""
    ops = [NC.kernel_operand(kernel_layout(w), device, f"{name} weight")
           for w in weights]
    return [torch.stack(ops[:5]), torch.stack(ops[5:])]


def _check_noise(noise: Noise, B, D, H, K1, K2, name) -> None:
    shapes = ((B, H, D * K1), (B, D, H * K2))
    if noise is not None and tuple(tuple(n.shape) for n in noise) != shapes:
        raise ValueError(f"{name}: noise must be {shapes[0]} and {shapes[1]}")


def _noise_ops(noise: Noise, B, D, H, K1, K2, device, name):
    """The noise as the kernels' float32 operands, checked."""
    _check_noise(noise, B, D, H, K1, K2, name)
    if noise is None:
        return None, None
    return tuple(NC.kernel_operand(n, device, f"{name} noise") for n in noise)


def _consts(cfg: FerroNodeConfig):
    g, a = float(cfg.gate_slope), float(cfg.alpha)
    return (g, a, 1.0 - a, 2.0 * g * (1.0 - a), float(cfg.h_bound),
            float(cfg.dh_clip))


def _work(B, D, H, K1, K2, bwd, device):
    with torch.cuda.device(device):
        _check_plan(torch.cuda.current_device(), D, H, K1, K2)
    n = _lib().ferro_node_work_floats(B, D, H, K1, K2, int(bwd))
    return torch.empty(n, dtype=torch.float32, device=device)


def _check_width(D, H, name) -> None:
    if max(D, H) > MAX_WIDTH:
        raise ValueError(f"{name}: widths D={D}, hidden={H} exceed the "
                         f"kernel's {MAX_WIDTH}")


def _launch_fwd(prm, nz, h0, dims, cfg, record):
    D, H, K1, K2 = dims
    B = h0.shape[0]
    dev = h0.device
    _check_width(D, H, "ferro_node_fwd")
    h0 = h0.detach().contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    recs = NC.new_records(cfg.max_steps, B, D, dev) if record else None
    r = recs if record else (None,) * 4
    work = _work(B, D, H, K1, K2, False, dev)
    NC.launch(_lib().ferro_node_fwd, NC.ptr(h0), NC.ptr(prm[0]),
              NC.ptr(prm[1]), NC.ptr(nz[0]), NC.ptr(nz[1]), NC.ptr(out),
              *(NC.ptr(t) for t in r), NC.ptr(work), B, D, H, K1, K2,
              int(cfg.max_steps), float(cfg.rtol), float(cfg.atol),
              *_consts(cfg), int(record), name="ferro_node_fwd", device=dev)
    ferro_node_fwd.launches += 1
    return out, recs


def _launch_bwd(prm, nz, records, hbar, dims, cfg):
    D, H, K1, K2 = dims
    B = hbar.shape[0]
    dev = hbar.device
    _check_width(D, H, "ferro_node_bwd")
    NC.check_records(records, B, D, dev, "ferro_node_bwd")
    hbar = hbar.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(p) for p in prm]
    h0bar = torch.empty((B, D), dtype=torch.float32, device=dev)
    work = _work(B, D, H, K1, K2, True, dev)
    NC.launch(_lib().ferro_node_bwd, NC.ptr(hbar),
              *(NC.ptr(t) for t in records), NC.ptr(prm[0]), NC.ptr(prm[1]),
              NC.ptr(nz[0]), NC.ptr(nz[1]), NC.ptr(grads[0]),
              NC.ptr(grads[1]), NC.ptr(h0bar), NC.ptr(work), B, D, H, K1, K2,
              *_consts(cfg), name="ferro_node_bwd", device=dev)
    ferro_node_bwd.launches += 1
    return grads, h0bar


def _unpack(grads, dims) -> List[torch.Tensor]:
    """The kernels' (5, out, L) gradients -> ten (in, out, K) arrays in
    the order of ``_weights``."""
    D, H, K1, K2 = dims
    out = []
    for g, (i, o, k) in zip(grads, ((D, H, K1), (H, D, K2))):
        out += [a.reshape(o, i, k).permute(1, 0, 2).contiguous() for a in g]
    return out


def ferro_node_fwd(fc1, fc2, h0: torch.Tensor, cfg: FerroNodeConfig, *,
                   noise: Noise = None, record: bool = True
                   ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel: ``(final state (B, D), records or None)``, no
    autograd.  ``noise``: the frozen (nz1, nz2) of ``frozen_solve_noise``
    or None.  A CPU tensor gets ``record_solve_reference``."""
    dims = _dims(fc1, fc2, h0, "ferro_node_fwd")
    if h0.device.type == "cpu":
        _check_noise(noise, h0.shape[0], *dims, "ferro_node_fwd")
        hT, recs = NC.record_solve_reference(
            ferro_field(fc1, fc2, cfg, noise), h0, rtol=cfg.rtol,
            atol=cfg.atol, max_steps=cfg.max_steps)
        return hT, recs if record else None
    NC.check_cuda(h0, "ferro_node_fwd")
    nz = _noise_ops(noise, h0.shape[0], *dims, h0.device, "ferro_node_fwd")
    return _launch_fwd(_pack(_weights(fc1, fc2), h0.device,
                             "ferro_node_fwd"), nz, h0, dims, cfg, record)


def ferro_node_bwd(fc1, fc2, h0: torch.Tensor, records: NC.SolveRecords,
                   hbar: torch.Tensor, cfg: FerroNodeConfig, *,
                   noise: Noise = None
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reverse-replay kernel: the final-state cotangent ``hbar`` ->
    (gradients of fc1's k, ec, ps, bias, coef then fc2's, each
    (in, out, K); h0bar).  The kernel reads the recorded states; a CPU
    tensor gets ``replay_vjp_reference``, which needs ``h0``."""
    dims = _dims(fc1, fc2, h0, "ferro_node_bwd")
    if h0.device.type == "cpu":
        _check_noise(noise, h0.shape[0], *dims, "ferro_node_bwd")
        return NC.replay_vjp_reference(ferro_field(fc1, fc2, cfg, noise),
                                       _weights(fc1, fc2), h0, records, hbar)
    NC.check_cuda(h0, "ferro_node_bwd")
    nz = _noise_ops(noise, h0.shape[0], *dims, h0.device, "ferro_node_bwd")
    grads, h0bar = _launch_bwd(_pack(_weights(fc1, fc2), h0.device,
                                     "ferro_node_bwd"),
                               nz, records, hbar, dims, cfg)
    return _unpack(grads, dims), h0bar


ferro_node_fwd.launches = 0
ferro_node_bwd.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel.
    Inputs: the modules (for their shapes) and config, the noise (no
    gradient: the reference's ``noise.detach()``), h0, then the ten
    ferro arrays, saved as given so that autograd refuses a backward
    after they changed in place."""

    @staticmethod
    def forward(ctx, fc1, fc2, cfg, nz1, nz2, h0, *weights):
        dims = _dims(fc1, fc2, h0, "ferro_node_solve")
        noise = None if nz1 is None else (nz1, nz2)
        nz = _noise_ops(noise, h0.shape[0], *dims, h0.device,
                        "ferro_node_solve")
        out, recs = _launch_fwd(_pack(weights, h0.device,
                                      "ferro_node_solve"),
                                nz, h0, dims, cfg, record=True)
        ctx.cfg, ctx.dims = cfg, dims
        ctx.save_for_backward(*recs, *weights,
                              *(n for n in nz if n is not None))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, hbar):
        saved = ctx.saved_tensors
        recs, weights, nz = NC.SolveRecords(*saved[:4]), saved[4:14], saved[14:]
        prm = _pack(weights, hbar.device, "ferro_node_solve")
        grads, h0bar = _launch_bwd(prm, tuple(nz) if nz else (None, None),
                                   recs, hbar, ctx.dims, ctx.cfg)
        need = ctx.needs_input_grad
        grads = _unpack(grads, ctx.dims)
        return (None, None, None, None, None, h0bar if need[5] else None,
                *(g if need[6 + i] else None for i, g in enumerate(grads)))


def ferro_node_solve(fc1, fc2, h0: torch.Tensor, spec, *,
                     generator: torch.Generator | None = None,
                     noise_std=None, noise: Noise = None) -> torch.Tensor:
    """Solve the ``KanFetMLPNODESpec`` latent ODE over [0, 1] from ``h0``
    (B, D) -> the final state, differentiable in fc1, fc2 and h0.

    Device noise (``spec.noise_std > 0`` or a ``noise_std`` override) is
    drawn from ``generator`` by ``frozen_solve_noise``, or given
    pre-drawn as ``noise``."""
    cfg = ferro_node_config(spec)
    if noise is None and (spec.noise_std > 0.0 or noise_std is not None):
        if generator is None:
            raise ValueError("noise_std > 0 requires a generator")
        noise = frozen_solve_noise(generator, h0.shape[0], spec.fc1_cfg,
                                   spec.fc2_cfg, noise_std=noise_std,
                                   device=h0.device)
    w = _weights(fc1, fc2)
    grad = _under_autograd(h0, *w)
    if h0.device.type == "cpu":
        _check_noise(noise, h0.shape[0], *_dims(fc1, fc2, h0,
                                                "ferro_node_solve"),
                     "ferro_node_solve")
        field = ferro_field(fc1, fc2, cfg, noise)
        opts = dict(rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps)
        if grad:
            return NC.solve_reference(field, h0, **opts)
        return NC.record_solve_reference(field, h0, **opts)[0]
    NC.check_cuda(h0, "ferro_node_solve")
    if grad:
        nz1, nz2 = noise if noise is not None else (None, None)
        return _SolveTrain.apply(fc1, fc2, cfg, nz1, nz2, h0, *w)
    return ferro_node_fwd(fc1, fc2, h0, cfg, noise=noise, record=False)[0]
