"""Batch-shared whole-solve scaffold of the (B, D) latent NODE kernels:
the step records, the plain PyTorch versions of the two kernels every
field of the family has, and what their wrappers share.

Counterpart of ``fetode_tpu/ops/pallas_node_common.py``.  The CUDA side
is ``csrc/node_common.cuh`` (the solve and the replay as device code for
a cooperative grid, a field plugging in as ``eval`` / ``vjp``);
``ops/logistic_node.py`` and ``ops/ferro_node.py`` are the fields.

The solve runs dopri5 over t in [0, 1] with ONE step size for the whole
batch: the error norm is the RMS over all B*D elements, as the JAX
package's XLA path takes it for a (B, D) state (``odeint_dopri5``
without ``per_row``).  Only the final state is returned.

* ``SolveRecords`` — every attempt of a solve, in the JAX kernel's
  layout.
* ``record_solve_reference`` — the plain forward kernel: the eager
  solve that also returns the records.
* ``replay_reference`` — a differentiable eager replay of recorded
  attempts (t, dt and accept held constant, every stage recomputed from
  the parameters); ``replay_vjp_reference``, its autograd, is the plain
  backward kernel, an oracle independent of the kernels' hand-written
  VJPs.  ``solve_reference`` chains record and replay.

A field here is a callable ``field(y) -> dy`` on (B, D) that closes over
its parameters.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.solvers.rk_common import rk_stage_loop
from fetode_tpu_torch.solvers.tableaux import DOPRI5

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


# ------------------------------------------------------- kernel wrappers


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
