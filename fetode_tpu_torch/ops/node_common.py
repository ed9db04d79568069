"""Batch-shared whole-solve scaffold of the (B, D) latent NODE kernels:
the step records, the plain PyTorch versions of the two kernels every
field of the family has, and what their wrappers share.

Counterpart of ``fetode_tpu/ops/pallas_node_common.py``.  The CUDA side
is ``csrc/node_common.cuh`` (the solve and the replay as device code for
a cooperative grid, a field plugging in as ``eval`` / ``vjp``);
``ops/logistic_node.py`` and ``ops/ferro_node.py`` are the final-state
fields, ``ops/ode_dyn.py`` the trajectory field.

The solve runs dopri5 with ONE step size for the whole batch: the error
norm is the RMS over all B*D elements, as the JAX package's XLA path
takes it for a (B, D) state (``odeint_dopri5`` without ``per_row``).
The final-state pair solves over t in [0, 1] and returns the final
state; the trajectory pair (``*_traj_reference``) solves a
non-autonomous field over [ts[0], ts[-1]] and returns the CONTD5 dense
output at every ``ts``.

* ``SolveRecords`` — every attempt of a solve, in the JAX kernel's
  layout.
* ``record_solve_reference`` — the plain forward kernel: the eager
  solve that also returns the records.
* ``replay_reference`` — a differentiable eager replay of recorded
  attempts (t, dt and accept held constant, every stage recomputed from
  the parameters); ``replay_vjp_reference``, its autograd, is the plain
  backward kernel, an oracle independent of the kernels' hand-written
  VJPs.  ``solve_reference`` chains record and replay.
* ``use_kernel`` — the models' dispatch between the kernels and the
  eager solve.

A field here is a callable ``field(y) -> dy`` on (B, D) (the trajectory
pair: ``field(t, y)``) that closes over its parameters.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.solvers.fixed import fixed_tableau
from fetode_tpu_torch.solvers.rk_common import combination, rk_stage_loop
from fetode_tpu_torch.solvers.tableaux import DOPRI5, DOPRI5_DENSE_D

Field = Callable[[torch.Tensor], torch.Tensor]


class SolveRecords(NamedTuple):
    """Every attempt of a batch-shared solve (``adaptive_solve_final``).

    tda: (M, 4) — per attempt: dt, accepted (0/1), t, 0.
    yrec: (M, B, D) — the state the attempt started from.
    krec: (M, 7, B, D) — its stages k1..k7.
    misc: (4,) — attempts made, the time reached, 0, 0.
    Rows past the attempts made hold no data.
    """

    tda: torch.Tensor
    yrec: torch.Tensor
    krec: torch.Tensor
    misc: torch.Tensor


def check_state(h0: torch.Tensor, D: int, name: str) -> None:
    if h0.ndim != 2 or h0.shape[1] != D or h0.shape[0] == 0:
        raise ValueError(f"{name}: h0 must be (B, {D}) with B >= 1, got "
                         f"{tuple(h0.shape)}")


def _ts(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 1.0], dtype=like.dtype, device=like.device)


def record_solve_reference(field: Field, h0: torch.Tensor, *,
                           rtol: float = 1e-2, atol: float = 1e-3,
                           max_steps: int = 16
                           ) -> Tuple[torch.Tensor, SolveRecords]:
    """The eager batch-shared dopri5 solve over [0, 1], no gradient ->
    ``(final state (B, D), records)``.  Works in the dtype of ``h0``."""
    B, D = h0.shape
    kw = dict(dtype=h0.dtype, device=h0.device)
    tda = torch.zeros((max_steps, 4), **kw)
    yrec = torch.zeros((max_steps, B, D), **kw)
    krec = torch.zeros((max_steps, 7, B, D), **kw)
    n_att = [0]

    def record(m, active, t, dt, adv, y, ks):
        tda[m, 0], tda[m, 1], tda[m, 2] = dt[0], adv[0].to(h0.dtype), t[0]
        yrec[m] = y.reshape(B, D)
        krec[m] = torch.stack(ks).reshape(7, B, D)
        n_att[0] = m + 1

    with torch.no_grad():
        hT = odeint_dopri5(lambda t, y: field(y), h0, _ts(h0), rtol=rtol,
                           atol=atol, max_steps=max_steps, mode="while",
                           record=record)[-1]
    n = n_att[0]
    t_end = (tda[n - 1, 2] + tda[n - 1, 0] * tda[n - 1, 1]) if n else 0.0
    misc = torch.zeros(4, **kw)
    misc[0], misc[1] = n, t_end
    return hT, SolveRecords(tda, yrec, krec, misc)


def replay_reference(field: Field, h0: torch.Tensor,
                     records: SolveRecords) -> torch.Tensor:
    """The solve of ``h0`` on the recorded mesh, every stage recomputed
    from the field, differentiable -> the final state.  Rejected attempts
    leave the state as it was and are skipped.  Works in the dtype of
    ``h0``."""
    tda = records.tda.detach().cpu().tolist()
    y = h0
    for m in range(int(records.misc[0])):
        dt, adv, t, _ = tda[m]
        if adv < 0.5:
            continue
        y, _, _ = rk_stage_loop(lambda t_, u: field(u), t, y, dt, DOPRI5)
    return y


def replay_vjp_reference(field: Field, weights: Sequence[torch.Tensor],
                         h0: torch.Tensor, records: SolveRecords,
                         hbar: torch.Tensor
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Autograd of ``replay_reference`` with the final-state cotangent
    ``hbar`` -> (gradients of ``weights``, the tensors ``field`` closes
    over, and h0bar)."""
    h = h0.detach().requires_grad_(True)
    with torch.enable_grad():
        out = replay_reference(field, h, records)
        grads = torch.autograd.grad(out, list(weights) + [h], hbar,
                                    allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(list(weights) + [h], grads)]
    return grads[:-1], grads[-1]


def solve_reference(field: Field, h0: torch.Tensor, *, rtol: float = 1e-2,
                    atol: float = 1e-3, max_steps: int = 16) -> torch.Tensor:
    """The plain differentiable solve: record the mesh with the eager
    solve, then replay it under autograd."""
    _, records = record_solve_reference(field, h0, rtol=rtol, atol=atol,
                                        max_steps=max_steps)
    return replay_reference(field, h0, records)


# ---------------------------------------------------- trajectory twins
#
# ``adaptive_solve_traj`` / ``adjoint_replay_traj`` of the JAX scaffold
# (``pallas_node_common.py:229``, ``:355``): a non-autonomous field
# ``field(t, y)``, the solve over [ts[0], ts[-1]] with CONTD5 dense
# output at every requested time, the same records.  Output tau is y0
# for ts[tau] <= ts[0], the dense output of the accepted attempt whose
# window (t, t + dt] holds it, and the last state past the time reached.

TrajField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def record_solve_traj_reference(field: TrajField, y0: torch.Tensor,
                                ts: torch.Tensor, *, rtol: float = 1e-3,
                                atol: float = 1e-4, max_steps: int = 32
                                ) -> Tuple[torch.Tensor, SolveRecords]:
    """The eager batch-shared dopri5 solve over [ts[0], ts[-1]], no
    gradient -> ``(trajectory (T, B, D), records)``."""
    B, D = y0.shape
    kw = dict(dtype=y0.dtype, device=y0.device)
    tda = torch.zeros((max_steps, 4), **kw)
    yrec = torch.zeros((max_steps, B, D), **kw)
    krec = torch.zeros((max_steps, 7, B, D), **kw)
    n_att = [0]

    def record(m, active, t, dt, adv, y, ks):
        tda[m, 0], tda[m, 1], tda[m, 2] = dt[0], adv[0].to(y0.dtype), t[0]
        yrec[m] = y.reshape(B, D)
        krec[m] = torch.stack(ks).reshape(7, B, D)
        n_att[0] = m + 1

    with torch.no_grad():
        traj = odeint_dopri5(field, y0, ts.to(y0.dtype), rtol=rtol,
                             atol=atol, max_steps=max_steps, mode="while",
                             record=record)
    n = n_att[0]
    misc = torch.zeros(4, **kw)
    misc[0] = n
    misc[1] = (tda[n - 1, 2] + tda[n - 1, 0] * tda[n - 1, 1]) if n \
        else ts[0]
    return traj, SolveRecords(tda, yrec, krec, misc)


def _dense(y, y1, ks, dt, theta):
    """The CONTD5 interpolant of one step at ``theta``."""
    dy = y1 - y
    r3 = dt * ks[0] - dy
    r4 = dy - dt * ks[6] - r3
    r5 = dt * combination(DOPRI5_DENSE_D, ks)
    th1 = 1.0 - theta
    return y + theta * (dy + th1 * (r3 + theta * (r4 + th1 * r5)))


def replay_traj_reference(field: TrajField, y0: torch.Tensor,
                          ts: torch.Tensor, records: SolveRecords
                          ) -> torch.Tensor:
    """The trajectory of ``y0`` on the recorded mesh, every stage
    recomputed, differentiable -> (T, B, D).  The window tests run in the
    records' dtype, as the kernels take them."""
    tda = records.tda.detach().cpu().numpy()
    f = tda.dtype.type
    tsn = ts.detach().cpu().numpy().astype(tda.dtype)
    tiny = f(1e-12)
    t_end = f(records.misc[1].item())
    T = tsn.shape[0]
    outs = [y0 if tsn[tau] <= tsn[0] + tiny else None for tau in range(T)]
    y = y0
    for m in range(int(records.misc[0])):
        dt, adv, t = tda[m, 0], tda[m, 1], tda[m, 2]
        if adv < 0.5:
            continue
        y1, _, ks = rk_stage_loop(field, float(t), y, float(dt), DOPRI5)
        dt_safe = f(1.0) if dt == 0 else dt
        for tau in range(T):
            if tsn[tau] > t and tsn[tau] <= t + dt + tiny:
                theta = min(max((tsn[tau] - t) / dt_safe, f(0.0)), f(1.0))
                outs[tau] = _dense(y, y1, ks, float(dt), float(theta))
        y = y1
    for tau in range(T):
        if tsn[tau] > t_end + tiny:
            outs[tau] = y
    return torch.stack(outs)


def replay_traj_vjp_reference(field: TrajField,
                              weights: Sequence[torch.Tensor],
                              y0: torch.Tensor, ts: torch.Tensor,
                              records: SolveRecords, ybar: torch.Tensor
                              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Autograd of ``replay_traj_reference`` with the trajectory's
    cotangent ``ybar`` (T, B, D) -> (gradients of ``weights``, y0bar)."""
    h = y0.detach().requires_grad_(True)
    with torch.enable_grad():
        out = replay_traj_reference(field, h, ts, records)
        grads = torch.autograd.grad(out, list(weights) + [h], ybar,
                                    allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(list(weights) + [h], grads)]
    return grads[:-1], grads[-1]


def solve_traj_reference(field: TrajField, y0: torch.Tensor,
                         ts: torch.Tensor, *, rtol: float = 1e-3,
                         atol: float = 1e-4, max_steps: int = 32
                         ) -> torch.Tensor:
    """The plain differentiable trajectory solve: record, then replay."""
    _, records = record_solve_traj_reference(field, y0, ts, rtol=rtol,
                                             atol=atol, max_steps=max_steps)
    return replay_traj_reference(field, y0, ts, records)


# ------------------------------------------------------- kernel wrappers


def use_kernel(spec, x: torch.Tensor) -> bool:
    """Resolve a model's latent solve from ``spec.solver`` and
    ``spec.solver_mode``: True for the CUDA kernels ('pallas', or 'auto'
    on a CUDA tensor), False for the eager dopri5 ('auto' on the CPU,
    'scan', 'while') and for a fixed-step solver in every mode (the
    whole-solve kernels are dopri5 only, as the JAX package's are).
    'pallas' with dopri5 on the CPU raises."""
    mode = spec.solver_mode
    if mode not in ("auto", "pallas", "scan", "while"):
        raise ValueError(f"solver_mode={mode!r}: expected 'auto', 'pallas', "
                         "'scan' or 'while'")
    if spec.solver != "dopri5":
        fixed_tableau(spec.solver)
        return False
    if mode == "pallas" and x.device.type != "cuda":
        raise ValueError("solver_mode='pallas' is the CUDA kernels and takes "
                         f"CUDA tensors, got one on {x.device}; use 'auto' "
                         "or 'scan' for the eager solve")
    return mode == "pallas" or (mode == "auto" and x.device.type == "cuda")


def check_cuda(h0: torch.Tensor, name: str) -> None:
    """What a kernel takes: a float32 state on CUDA."""
    if h0.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA (or CPU, through its plain "
                         f"version), got a tensor on {h0.device}")
    if h0.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 state, got {h0.dtype}")


def kernel_operand(t: torch.Tensor, device: torch.device,
                   name: str) -> torch.Tensor:
    """A float32 operand on ``device``, contiguous, without autograd."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the state on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.detach().contiguous()


def new_records(max_steps: int, B: int, D: int,
                device: torch.device) -> SolveRecords:
    """Buffers for a forward kernel to record into."""
    kw = dict(dtype=torch.float32, device=device)
    return SolveRecords(torch.zeros((max_steps, 4), **kw),
                        torch.empty((max_steps, B, D), **kw),
                        torch.empty((max_steps, 7, B, D), **kw),
                        torch.zeros(4, **kw))


def check_records(records: SolveRecords, B: int, D: int,
                  device: torch.device, name: str) -> None:
    tda, yrec, krec, misc = records
    M = tda.shape[0]
    if (tda.shape != (M, 4) or yrec.shape != (M, B, D)
            or krec.shape != (M, 7, B, D) or misc.shape != (4,)):
        raise ValueError(f"{name}: records do not match the batch and state "
                         f"size ({B}, {D})")
    for r in records:
        if r.dtype != torch.float32 or r.device != device \
                or not r.is_contiguous():
            raise ValueError(f"{name} takes the forward kernel's records: "
                             f"float32, contiguous, on {device}")


def launch(fn, *args, name: str, device: torch.device) -> None:
    """Call a kernel's C launcher on ``device``'s current stream; raise if
    the launch returns a CUDA error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
