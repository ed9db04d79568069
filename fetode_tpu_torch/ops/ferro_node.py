"""Whole-solve ECG ferro MLP-NODE latent field: dopri5 over [0, 1] with
batch-shared step control and its discrete adjoint, as two CUDA
kernels, with optional frozen device noise, for one solve or for P
independent members (a population's) in one launch.

Counterpart of ``fetode_tpu/ops/pallas_ferro_node.py:
make_ferro_node_solver`` (the TPU kernels ``_make_fwd_kernel`` :87 and
``_make_bwd_kernel`` :150, and their batch-vectorized layout :259 /
:309, another TPU layout of the same function) and of its ``vmap`` over
a population's members (``fetode_tpu/train/ecg_driver.py:
train_ecg_population``).  The CUDA source is
``fetode_tpu_torch/csrc/ferro_node.cu`` on the shared scaffold
``csrc/node_common.cuh`` (its fused-stage hook in the member form);
its header gives the design and what bounds it.  ``slice_plan`` is how
the kernels cut each layer's parameters into tiles over the grid's
blocks (the CUDA ``slice_plan``, checked against it once a shape).  The
field maps D -> hidden -> D through two ferro layers with the fresh
frozen hysteresis state, a tanh bound before and a tanh link between
them, and a clip at the end.  The kernel's field differs from the eager
model field (``models/ecg.py: kanfet_mlp_node_field``) in two places, as
in the JAX package: it has no ``nan_to_num``, and its clip passes the
gradient strictly inside (-clip, clip).

Device noise is frozen per solve: ``frozen_solve_noise`` draws it once,
in the (B, in, out, K) shape of ``ops/ferro.py: ferro_basis``, and hands
it to the kernels as two (B, out, in*K) operands with the scale
multiplied in; only the coef gradient sees it.
``frozen_solve_noise_members`` draws member m's from member m's
generator at member m's std (a std-0 member rides zero-valued operands).

Members: member m has its own parameters, h0 (B, D), noise and step
control (t, dt, attempts, accept, error norm); within a member the step
control is shared over its B rows.  A member's output, records,
attempts and gradients are the bits of the single solve of that member,
whatever P is.  One launch takes up to ``MAX_MEMBERS``; the wrappers
launch more in groups of that many.

* ``ferro_node_solve`` / ``ferro_node_solve_members`` — the public
  solves.  On CUDA, under autograd, a ``torch.autograd.Function`` over
  the forward kernel (with records) and the replay kernel, which returns
  each member's gradients to that member's parameters; without autograd
  the forward kernel alone.  On the CPU the plain version.
* ``ferro_node_fwd`` / ``ferro_node_bwd`` and ``ferro_node_fwd_members``
  / ``ferro_node_bwd_members`` — the kernel wrappers with launch
  counters (``.launches``, one a launch); for CPU tensors the plain
  versions: ``ops/node_common.py``'s around ``ferro_field``, and for the
  members ``ferro_node_fwd_members_reference`` /
  ``ferro_node_bwd_members_reference``, which solve each member with
  those.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from fetode_tpu_torch.ops import node_common as NC
from fetode_tpu_torch.ops.ferro import FerroConfig
from fetode_tpu_torch.solvers.dopri5 import _under_autograd
from fetode_tpu_torch.utils.init import normal

_KERNEL_NAME = "ferro_node"
_NAMES = ("k", "ec", "ps", "bias", "coef")
MAX_WIDTH = 512      # the kernel's bound on the latent and hidden widths
MAX_MEMBERS = 32     # members one launch takes (the library's, checked)
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


def frozen_solve_noise_members(generators: Sequence[torch.Generator], B: int,
                               cfg1: FerroConfig, cfg2: FerroConfig,
                               noise_stds: Sequence[float], *, device=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``frozen_solve_noise`` for P members: member m's draws from
    ``generators[m]`` times ``noise_stds[m]``, stacked (P, B, out, in*K)
    a layer."""
    per = [frozen_solve_noise(g, B, cfg1, cfg2, noise_std=std, device=device)
           for g, std in zip(generators, noise_stds)]
    return torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])


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
    lib.ferro_node_fwd.argtypes = [P] * 11 + [I] * 7 + [F] * 8 + [I, P]
    lib.ferro_node_bwd.argtypes = [P] * 13 + [I] * 7 + [F] * 6 + [P]
    lib.ferro_node_fwd.restype = lib.ferro_node_bwd.restype = ctypes.c_int
    lib.ferro_node_work_floats.argtypes = [I] * 7
    lib.ferro_node_work_floats.restype = ctypes.c_longlong
    lib.ferro_node_slice_plan.argtypes = [I] * 4 + [P]
    lib.ferro_node_slice_plan.restype = None
    lib.ferro_node_grid.argtypes = []
    lib.ferro_node_grid.restype = ctypes.c_int
    lib.ferro_node_max_members.argtypes = []
    lib.ferro_node_max_members.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _check_plan(device_index: int, D: int, H: int, K1: int, K2: int) -> None:
    """Raise unless the library cuts both layers as ``slice_plan`` does,
    at the grid the kernels take on this card, and takes ``MAX_MEMBERS``
    members a launch (once a shape)."""
    if _lib().ferro_node_max_members() != MAX_MEMBERS:
        raise RuntimeError(f"ferro_node: the library takes "
                           f"{_lib().ferro_node_max_members()} members a "
                           f"launch, the wrapper {MAX_MEMBERS}")
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


def _member_dims(fc1s, fc2s, h0, name):
    """(D, H, K1, K2) of P members, checked: h0 (P, B, D), every member's
    layers of one shape."""
    if h0.ndim != 3 or h0.shape[0] == 0 or len(fc1s) != h0.shape[0] \
            or len(fc2s) != h0.shape[0]:
        raise ValueError(f"{name}: h0 must be (P, B, D) for the P members' "
                         f"layers, got {tuple(h0.shape)} for "
                         f"{len(fc1s)} / {len(fc2s)}")
    dims = _dims(fc1s[0], fc2s[0], h0[0], name)
    for a, b in zip(fc1s, fc2s):
        if (a.k.shape, b.k.shape) != (fc1s[0].k.shape, fc2s[0].k.shape):
            raise ValueError(f"{name}: every member's layers must have one "
                             "shape")
    return dims


def _pack(weights, P, device, name) -> List[torch.Tensor]:
    """The P members' ten arrays (``_weights`` of each, member after
    member), each layer's in kernel layout and stacked: two (P, 5, out, L)
    operands."""
    ops = [NC.kernel_operand(w, device, f"{name} weight") for w in weights]
    out = []
    for layer in (0, 1):
        a = torch.stack([ops[10 * m + 5 * layer + j] for m in range(P)
                         for j in range(5)])
        i, o, k = a.shape[1:]
        out.append(a.reshape(P, 5, i, o, k).permute(0, 1, 3, 2, 4)
                   .reshape(P, 5, o, i * k).contiguous())
    return out


def _unpack(grads, dims) -> List[List[torch.Tensor]]:
    """The kernels' (P, 5, out, L) gradients -> per member ten (in, out, K)
    arrays in the order of ``_weights``."""
    D, H, K1, K2 = dims
    per_layer = [g.reshape(g.shape[0], 5, o, i, k).permute(0, 1, 3, 2, 4)
                 .contiguous()
                 for g, (i, o, k) in zip(grads, ((D, H, K1), (H, D, K2)))]
    return [[a for layer in per_layer for a in layer[m]]
            for m in range(grads[0].shape[0])]


def _check_noise(noise: Noise, lead, D, H, K1, K2, name) -> None:
    shapes = (tuple(lead) + (H, D * K1), tuple(lead) + (D, H * K2))
    if noise is not None and tuple(tuple(n.shape) for n in noise) != shapes:
        raise ValueError(f"{name}: noise must be {shapes[0]} and {shapes[1]}")


def _noise_ops(noise: Noise, lead, D, H, K1, K2, device, name):
    """The noise as the kernels' float32 operands, checked."""
    _check_noise(noise, lead, D, H, K1, K2, name)
    if noise is None:
        return None, None
    return tuple(NC.kernel_operand(n, device, f"{name} noise") for n in noise)


def _consts(cfg: FerroNodeConfig):
    g, a = float(cfg.gate_slope), float(cfg.alpha)
    return (g, a, 1.0 - a, 2.0 * g * (1.0 - a), float(cfg.h_bound),
            float(cfg.dh_clip))


def _work(P, B, D, H, K1, K2, bwd, device):
    with torch.cuda.device(device):
        _check_plan(torch.cuda.current_device(), D, H, K1, K2)
    n = _lib().ferro_node_work_floats(P, B, D, H, K1, K2, int(bwd))
    return torch.empty(n, dtype=torch.float32, device=device)


def _check_width(D, H, name) -> None:
    if max(D, H) > MAX_WIDTH:
        raise ValueError(f"{name}: widths D={D}, hidden={H} exceed the "
                         f"kernel's {MAX_WIDTH}")


def _groups(P):
    """The members of each launch: slices of at most MAX_MEMBERS."""
    return [slice(m, min(P, m + MAX_MEMBERS))
            for m in range(0, P, MAX_MEMBERS)]


def _member_records(M, P, B, D, device) -> NC.SolveRecords:
    kw = dict(dtype=torch.float32, device=device)
    return NC.SolveRecords(torch.zeros((P, M, 4), **kw),
                           torch.empty((P, M, B, D), **kw),
                           torch.empty((P, M, 7, B, D), **kw),
                           torch.zeros((P, 4), **kw))


def _check_member_records(records, P, B, D, device, name) -> None:
    tda, yrec, krec, misc = records
    M = tda.shape[-2] if tda.ndim == 3 else -1
    if (tda.shape != (P, M, 4) or yrec.shape != (P, M, B, D)
            or krec.shape != (P, M, 7, B, D) or misc.shape != (P, 4)):
        raise ValueError(f"{name}: records do not match the members, batch "
                         f"and state size ({P}, {B}, {D})")
    for r in records:
        if r.dtype != torch.float32 or r.device != device \
                or not r.is_contiguous():
            raise ValueError(f"{name} takes the forward kernel's records: "
                             f"float32, contiguous, on {device}")


def _launch_fwd(prm, nz, h0, dims, cfg, record, counter):
    """The forward kernel on h0 (P, B, D), in launches of at most
    MAX_MEMBERS members, each counted on ``counter``."""
    D, H, K1, K2 = dims
    P, B = h0.shape[:2]
    dev = h0.device
    _check_width(D, H, "ferro_node_fwd")
    h0 = h0.detach().contiguous()
    out = torch.empty((P, B, D), dtype=torch.float32, device=dev)
    recs = _member_records(cfg.max_steps, P, B, D, dev) if record else None
    for g in _groups(P):
        n = g.stop - g.start
        r = [t[g] for t in recs] if record else [None] * 4
        work = _work(n, B, D, H, K1, K2, False, dev)
        NC.launch(_lib().ferro_node_fwd, NC.ptr(h0[g]), NC.ptr(prm[0][g]),
                  NC.ptr(prm[1][g]), *(NC.ptr(None if z is None else z[g])
                                       for z in nz),
                  NC.ptr(out[g]), *(NC.ptr(t) for t in r), NC.ptr(work), n, B,
                  D, H, K1, K2, int(cfg.max_steps), float(cfg.rtol),
                  float(cfg.atol), *_consts(cfg), int(record),
                  name="ferro_node_fwd", device=dev)
        counter.launches += 1
    return out, recs


def _launch_bwd(prm, nz, records, hbar, dims, cfg, counter):
    """The replay kernel on (P, ...) records, in launches of at most
    MAX_MEMBERS members, each counted on ``counter``."""
    D, H, K1, K2 = dims
    P, B = hbar.shape[:2]
    dev = hbar.device
    _check_width(D, H, "ferro_node_bwd")
    _check_member_records(records, P, B, D, dev, "ferro_node_bwd")
    hbar = hbar.detach().to(torch.float32).contiguous()
    grads = [torch.empty_like(p) for p in prm]
    h0bar = torch.empty((P, B, D), dtype=torch.float32, device=dev)
    M = records.tda.shape[1]
    for g in _groups(P):
        n = g.stop - g.start
        work = _work(n, B, D, H, K1, K2, True, dev)
        NC.launch(_lib().ferro_node_bwd, NC.ptr(hbar[g]),
                  *(NC.ptr(t[g]) for t in records), NC.ptr(prm[0][g]),
                  NC.ptr(prm[1][g]),
                  *(NC.ptr(None if z is None else z[g]) for z in nz),
                  NC.ptr(grads[0][g]), NC.ptr(grads[1][g]), NC.ptr(h0bar[g]),
                  NC.ptr(work), n, B, D, H, K1, K2, M, *_consts(cfg),
                  name="ferro_node_bwd", device=dev)
        counter.launches += 1
    return grads, h0bar


def _lead(noise: Noise):
    """A single solve's noise with a leading member axis of one."""
    return None if noise is None else tuple(n[None] for n in noise)


def _one(records: NC.SolveRecords) -> NC.SolveRecords:
    return NC.SolveRecords(*(r[None] for r in records))


def _member(records: NC.SolveRecords, m: int) -> NC.SolveRecords:
    return NC.SolveRecords(*(r[m] for r in records))


def ferro_node_fwd(fc1, fc2, h0: torch.Tensor, cfg: FerroNodeConfig, *,
                   noise: Noise = None, record: bool = True
                   ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel: ``(final state (B, D), records or None)``, no
    autograd.  ``noise``: the frozen (nz1, nz2) of ``frozen_solve_noise``
    or None.  A CPU tensor gets ``record_solve_reference``."""
    dims = _dims(fc1, fc2, h0, "ferro_node_fwd")
    if h0.device.type == "cpu":
        _check_noise(noise, h0.shape[:1], *dims, "ferro_node_fwd")
        hT, recs = NC.record_solve_reference(
            ferro_field(fc1, fc2, cfg, noise), h0, rtol=cfg.rtol,
            atol=cfg.atol, max_steps=cfg.max_steps)
        return hT, recs if record else None
    NC.check_cuda(h0, "ferro_node_fwd")
    nz = _noise_ops(_lead(noise), (1, h0.shape[0]), *dims, h0.device,
                    "ferro_node_fwd")
    out, recs = _launch_fwd(_pack(_weights(fc1, fc2), 1, h0.device,
                                  "ferro_node_fwd"), nz, h0[None], dims, cfg,
                            record, ferro_node_fwd)
    return out[0], _member(recs, 0) if record else None


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
        _check_noise(noise, h0.shape[:1], *dims, "ferro_node_bwd")
        return NC.replay_vjp_reference(ferro_field(fc1, fc2, cfg, noise),
                                       _weights(fc1, fc2), h0, records, hbar)
    NC.check_cuda(h0, "ferro_node_bwd")
    NC.check_records(records, h0.shape[0], dims[0], h0.device,
                     "ferro_node_bwd")
    nz = _noise_ops(_lead(noise), (1, h0.shape[0]), *dims, h0.device,
                    "ferro_node_bwd")
    grads, h0bar = _launch_bwd(_pack(_weights(fc1, fc2), 1, h0.device,
                                     "ferro_node_bwd"), nz, _one(records),
                               hbar[None], dims, cfg, ferro_node_bwd)
    return _unpack(grads, dims)[0], h0bar[0]


def ferro_node_fwd_members_reference(fc1s, fc2s, h0: torch.Tensor,
                                     cfg: FerroNodeConfig, *,
                                     noise: Noise = None
                                     ) -> Tuple[torch.Tensor,
                                                NC.SolveRecords]:
    """The plain member forward: each member's ``record_solve_reference``
    around its ``ferro_field``, stacked -> (out (P, B, D), records with a
    leading P)."""
    dims = _member_dims(fc1s, fc2s, h0, "ferro_node_fwd_members")
    _check_noise(noise, h0.shape[:2], *dims, "ferro_node_fwd_members")
    outs, recs = [], []
    for m, (a, b) in enumerate(zip(fc1s, fc2s)):
        nz = None if noise is None else (noise[0][m], noise[1][m])
        out, rec = NC.record_solve_reference(
            ferro_field(a, b, cfg, nz), h0[m], rtol=cfg.rtol, atol=cfg.atol,
            max_steps=cfg.max_steps)
        outs.append(out)
        recs.append(rec)
    return torch.stack(outs), NC.SolveRecords(
        *(torch.stack(r) for r in zip(*recs)))


def ferro_node_bwd_members_reference(fc1s, fc2s, h0: torch.Tensor,
                                     records: NC.SolveRecords,
                                     hbar: torch.Tensor, cfg: FerroNodeConfig,
                                     *, noise: Noise = None
                                     ) -> Tuple[List[List[torch.Tensor]],
                                                torch.Tensor]:
    """The plain member backward: each member's ``replay_vjp_reference``
    on its own records -> (per member its ten gradients, h0bar (P, B, D))."""
    dims = _member_dims(fc1s, fc2s, h0, "ferro_node_bwd_members")
    _check_noise(noise, h0.shape[:2], *dims, "ferro_node_bwd_members")
    grads, h0bars = [], []
    for m, (a, b) in enumerate(zip(fc1s, fc2s)):
        nz = None if noise is None else (noise[0][m], noise[1][m])
        g, hb = NC.replay_vjp_reference(ferro_field(a, b, cfg, nz),
                                        _weights(a, b), h0[m],
                                        _member(records, m), hbar[m])
        grads.append(g)
        h0bars.append(hb)
    return grads, torch.stack(h0bars)


def ferro_node_fwd_members(fc1s, fc2s, h0: torch.Tensor,
                           cfg: FerroNodeConfig, *, noise: Noise = None,
                           record: bool = True
                           ) -> Tuple[torch.Tensor, NC.SolveRecords | None]:
    """The forward kernel for P members: ``fc1s``, ``fc2s`` the members'
    layers, h0 (P, B, D), ``noise`` the stacked (nz1, nz2) of
    ``frozen_solve_noise_members`` or None -> ``(final states (P, B, D),
    records (tda (P, M, 4), yrec (P, M, B, D), krec (P, M, 7, B, D), misc
    (P, 4)) or None)``, no autograd.  CPU tensors get
    ``ferro_node_fwd_members_reference``."""
    dims = _member_dims(fc1s, fc2s, h0, "ferro_node_fwd_members")
    if h0.device.type == "cpu":
        out, recs = ferro_node_fwd_members_reference(fc1s, fc2s, h0, cfg,
                                                     noise=noise)
        return out, recs if record else None
    NC.check_cuda(h0, "ferro_node_fwd_members")
    P = h0.shape[0]
    nz = _noise_ops(noise, h0.shape[:2], *dims, h0.device,
                    "ferro_node_fwd_members")
    w = [t for a, b in zip(fc1s, fc2s) for t in _weights(a, b)]
    return _launch_fwd(_pack(w, P, h0.device, "ferro_node_fwd_members"), nz,
                       h0, dims, cfg, record, ferro_node_fwd_members)


def ferro_node_bwd_members(fc1s, fc2s, h0: torch.Tensor,
                           records: NC.SolveRecords, hbar: torch.Tensor,
                           cfg: FerroNodeConfig, *, noise: Noise = None
                           ) -> Tuple[List[List[torch.Tensor]], torch.Tensor]:
    """The replay kernel for P members: the final states' cotangent
    ``hbar`` (P, B, D) and the members' records -> (per member the
    gradients of its fc1's k, ec, ps, bias, coef then its fc2's, each
    (in, out, K); h0bar (P, B, D)).  CPU tensors get
    ``ferro_node_bwd_members_reference``, which needs ``h0``."""
    dims = _member_dims(fc1s, fc2s, h0, "ferro_node_bwd_members")
    if h0.device.type == "cpu":
        return ferro_node_bwd_members_reference(fc1s, fc2s, h0, records, hbar,
                                                cfg, noise=noise)
    NC.check_cuda(h0, "ferro_node_bwd_members")
    P = h0.shape[0]
    nz = _noise_ops(noise, h0.shape[:2], *dims, h0.device,
                    "ferro_node_bwd_members")
    w = [t for a, b in zip(fc1s, fc2s) for t in _weights(a, b)]
    grads, h0bar = _launch_bwd(_pack(w, P, h0.device,
                                     "ferro_node_bwd_members"),
                               nz, records, hbar, dims, cfg,
                               ferro_node_bwd_members)
    return _unpack(grads, dims), h0bar


for _f in (ferro_node_fwd, ferro_node_bwd, ferro_node_fwd_members,
           ferro_node_bwd_members):
    _f.launches = 0


class _SolveTrain(torch.autograd.Function):
    """Forward kernel with records; the backward is the replay kernel, for
    P members (h0 (P, B, D)).  Inputs: the two wrappers whose counters
    take the launches, the config, the noise (no gradient: the reference's
    ``noise.detach()``), h0, then the members' ferro arrays (ten a member,
    in the order of ``_weights``), saved as given so that autograd refuses
    a backward after they changed in place; each gets its own member's
    gradient."""

    @staticmethod
    def forward(ctx, counters, cfg, nz1, nz2, h0, *weights):
        D, H, K1 = weights[0].shape
        dims = (D, H, K1, weights[5].shape[2])
        P = h0.shape[0]
        noise = None if nz1 is None else (nz1, nz2)
        nz = _noise_ops(noise, h0.shape[:2], *dims, h0.device,
                        "ferro_node_solve")
        out, recs = _launch_fwd(_pack(weights, P, h0.device,
                                      "ferro_node_solve"),
                                nz, h0, dims, cfg, True, counters[0])
        ctx.cfg, ctx.dims, ctx.counter = cfg, dims, counters[1]
        ctx.n_w = len(weights)
        ctx.save_for_backward(*recs, *weights,
                              *(n for n in nz if n is not None))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, hbar):
        saved = ctx.saved_tensors
        n_w = ctx.n_w
        recs, weights = NC.SolveRecords(*saved[:4]), saved[4:4 + n_w]
        nz = saved[4 + n_w:]
        prm = _pack(weights, hbar.shape[0], hbar.device, "ferro_node_solve")
        grads, h0bar = _launch_bwd(prm, tuple(nz) if nz else (None, None),
                                   recs, hbar, ctx.dims, ctx.cfg, ctx.counter)
        need = ctx.needs_input_grad
        flat = [g for member in _unpack(grads, ctx.dims) for g in member]
        return (None, None, None, None, h0bar if need[4] else None,
                *(g if need[5 + i] else None for i, g in enumerate(flat)))


def _plain_solve(field, h0, cfg, grad):
    opts = dict(rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps)
    if grad:
        return NC.solve_reference(field, h0, **opts)
    return NC.record_solve_reference(field, h0, **opts)[0]


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
    dims = _dims(fc1, fc2, h0, "ferro_node_solve")
    if h0.device.type == "cpu":
        _check_noise(noise, h0.shape[:1], *dims, "ferro_node_solve")
        return _plain_solve(ferro_field(fc1, fc2, cfg, noise), h0, cfg, grad)
    NC.check_cuda(h0, "ferro_node_solve")
    if grad:
        nz1, nz2 = _lead(noise) if noise is not None else (None, None)
        return _SolveTrain.apply((ferro_node_fwd, ferro_node_bwd), cfg, nz1,
                                 nz2, h0[None], *w)[0]
    return ferro_node_fwd(fc1, fc2, h0, cfg, noise=noise, record=False)[0]


def ferro_node_solve_members(fc1s, fc2s, h0: torch.Tensor, spec, *,
                             noise: Noise = None) -> torch.Tensor:
    """Solve the ``KanFetMLPNODESpec`` latent ODE over [0, 1] for P
    members: ``fc1s``, ``fc2s`` the members' layers, h0 (P, B, D), the
    frozen noise pre-drawn and pre-scaled (``frozen_solve_noise_members``)
    or None -> the final states (P, B, D), differentiable in every
    member's layers and in h0.  On the CPU each member's plain solve."""
    cfg = ferro_node_config(spec)
    dims = _member_dims(fc1s, fc2s, h0, "ferro_node_solve_members")
    w = [t for a, b in zip(fc1s, fc2s) for t in _weights(a, b)]
    grad = _under_autograd(h0, *w)
    if h0.device.type == "cpu":
        _check_noise(noise, h0.shape[:2], *dims, "ferro_node_solve_members")
        return torch.stack([
            _plain_solve(ferro_field(a, b, cfg, None if noise is None
                                     else (noise[0][m], noise[1][m])),
                         h0[m], cfg, grad)
            for m, (a, b) in enumerate(zip(fc1s, fc2s))])
    NC.check_cuda(h0, "ferro_node_solve_members")
    if grad:
        nz1, nz2 = noise if noise is not None else (None, None)
        return _SolveTrain.apply((ferro_node_fwd_members,
                                  ferro_node_bwd_members), cfg, nz1, nz2, h0,
                                 *w)
    return ferro_node_fwd_members(fc1s, fc2s, h0, cfg, noise=noise,
                                  record=False)[0]


class _Layers(torch.nn.Module):
    """fc1 and fc2 as one module (the parameters a sharded solve sums)."""

    def __init__(self, fc1, fc2):
        super().__init__()
        self.fc1, self.fc2 = fc1, fc2


def ferro_node_solve_sharded(fc1, fc2, h0: torch.Tensor, spec, mesh, *,
                             axis: str = "data",
                             generator: torch.Generator | None = None,
                             noise: Noise = None) -> torch.Tensor:
    """``ferro_node_solve`` over a mesh (counterpart of
    ``pallas_ferro_node_solve_sharded``): every rank takes the global
    ``h0`` (B, D), solves its block of rows over ``axis`` with that
    block's own step control (B.4 on the card, its plain version on the
    CPU) and returns the global final states.  Under autograd fc1's and
    fc2's gradients are summed over the ranks and h0 gets its full
    cotangent (``parallel.shard_map_rows``).  Device noise
    (``spec.noise_std > 0``) is drawn for the global batch from
    ``generator`` with the single-device draws (or given as ``noise``)
    and sharded with ``h0``.  ``h0``'s batch must divide the axis size."""
    from fetode_tpu_torch.parallel.collectives import shard_map_rows

    n = mesh.axis_size(axis)
    if h0.shape[0] % n:
        raise ValueError(f"batch {h0.shape[0]} not divisible by {axis}={n}")
    if noise is None and spec.noise_std > 0.0:
        if generator is None:
            raise ValueError("noise_std > 0 requires a generator")
        noise = frozen_solve_noise(generator, h0.shape[0], spec.fc1_cfg,
                                   spec.fc2_cfg, device=h0.device)

    def solve(m, h, *nz):
        return ferro_node_solve(m.fc1, m.fc2, h, spec,
                                noise=tuple(nz) if nz else None)

    return shard_map_rows(solve, mesh, _Layers(fc1, fc2), h0,
                          *(noise or ()), axis=axis)
