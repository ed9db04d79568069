"""Adaptive Dormand-Prince 5(4) integration (counterpart of
``fetode_tpu/solvers/dopri5.py``).

Hairer initial step, PI step-size controller, FSAL stage reuse and the
CONTD5 4th-order dense output at the requested times, with the step body
of the JAX package's ``odeint_dopri5``.

Two forms around one loop:

* whole-state (``per_row=False``): one step controller over all of
  ``y0``, as the JAX solver takes it (``rk_common.py: error_norm`` over
  the whole state).
* per-row (``per_row=True``): ``y0`` is ``(B, D)`` and every row carries
  its own t, dt, err_prev and attempt count; a row stops once it is
  finished or has used ``max_steps`` attempts.  This equals
  ``jax.vmap(odeint_dopri5)``, which is how the JAX package's serving
  path gets per-trajectory step control (``cli.py:693-694``); PyTorch
  cannot vmap a data-dependent loop, so the batch is written out.  The
  output times are ``(T,)``, shared by every row, or ``(B, T)``, each row
  its own (``jax.vmap`` over both ``y0`` and ``ts``, as multiple shooting
  solves its segments): row b then starts at ``ts[b, 0]`` and ends at
  ``ts[b, T-1]``.

Modes:

* ``"while"`` — the early-exit forward solve, run under ``torch.no_grad``.
* ``"scan"`` — the solve that autograd differentiates: the same loop
  with autograd on.  The JAX package runs ``max_steps`` attempts as a
  ``lax.scan`` whose attempts past the end are masked no-ops; those are
  identities in value and in gradient, so stopping once every row has
  finished is exact.  As there, the error norm and the initial step are
  cut from the graph (``stop_gradient`` -> ``.detach()``), so t and dt
  are constants of the step mesh.
* ``"auto"`` — ``"scan"`` exactly when the call is under autograd, else
  ``"while"``, as the JAX ``mode="auto"`` does.

``full_output=True`` also returns ``Dopri5Stats``: accepted and rejected
attempts and whether ``ts[-1]`` was reached, scalars in the whole-state
form and one per row in the per-row form (``jax.vmap``'s stats).
``norm_fn`` replaces the error norm (the continuous adjoint's seminorm).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fetode_tpu_torch.solvers.rk_common import (
    combination,
    error_norm,
    rk_stage_loop,
)
from fetode_tpu_torch.solvers.tableaux import DOPRI5, DOPRI5_DENSE_D

_ORDER = 5
# PI controller (Hairer DOPRI5 defaults): beta = 0.04, alpha = 1/5 - 0.75*beta
_BETA = 0.04
_ALPHA = 1.0 / _ORDER - 0.75 * _BETA


class Dopri5Stats(NamedTuple):
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    success: torch.Tensor   # integration reached ts[-1] within max_steps


def _rms(v: torch.Tensor, ref: torch.Tensor, rtol, atol) -> torch.Tensor:
    s = atol + rtol * ref.abs()
    return torch.sqrt(((v / s) ** 2).mean(dim=-1))


def _initial_step(func, t0, y0, f0, rtol, atol, args) -> torch.Tensor:
    """Hairer's automatic initial step size (Solving ODEs I, II.4), per row."""
    d0 = _rms(y0, y0, rtol, atol)
    d1 = _rms(f0, y0, rtol, atol)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                     0.01 * d0 / torch.clamp(d1, min=1e-30))
    f1 = func(t0 + h0[:, None], y0 + h0[:, None] * f0, *args)
    d2 = _rms(f1 - f0, y0, rtol, atol) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.clamp(dmax, min=1e-30))
                     ** (1.0 / (_ORDER + 1)))
    return torch.minimum(100.0 * h0, h1)


def _dense_coeffs(y0, y1, ks, dt):
    """Hairer CONTD5 coefficients for the 4th-order continuous extension."""
    dy = y1 - y0
    r3 = dt * ks[0] - dy
    r4 = dy - dt * ks[6] - r3
    r5 = dt * combination(DOPRI5_DENSE_D, ks)
    return dy, r3, r4, r5


def _dense_eval(y0, dy, r3, r4, r5, theta):
    """The interpolant of ``(B, D)`` rows at ``theta`` ``(B, T)`` -> ``(B, T, D)``."""
    th = theta[..., None]
    t1 = 1.0 - th
    e = [v[:, None, :] for v in (y0, dy, r3, r4, r5)]
    return e[0] + th * (e[1] + t1 * (e[2] + th * (e[3] + t1 * e[4])))


def _solve_rows(func, y0, ts, args, rtol, atol, max_steps, safety, ifactor,
                dfactor, record=None, norm_fn=error_norm):
    """The early-exit loop over ``(B, D)`` rows, each with its own step
    control.  ``func(t (B, 1), y (B, D), *args) -> (B, D)``; ``ts`` is
    ``(T,)`` or ``(B, T)``, one row of times a row of ``y0``.  Returns
    ``(B, T, D)`` and the rows' ``Dopri5Stats``.  ``record(m, active, t,
    dt, accepted, y, ks)``, when given, sees attempt m of every row before
    the state advances (the rows in ``active`` are making their m-th
    attempt)."""
    B, D = y0.shape
    T = ts.shape[-1]
    ts = ts.expand(B, T)
    t0, t_final = ts[:, 0], ts[:, -1]
    tiny = torch.tensor(1e-12, dtype=ts.dtype, device=ts.device)
    end = t_final - tiny

    t = t0.clone()
    f = func(t[:, None], y0, *args)
    dt = torch.minimum(
        _initial_step(func, t[:, None], y0, f, rtol, atol, args).detach(),
        t_final - t0)
    err_prev = torch.ones_like(t)
    n_acc = torch.zeros(B, dtype=torch.int32, device=y0.device)
    n_rej = torch.zeros_like(n_acc)
    y = y0
    # Output buffer prefilled with y0: index 0 is already right, tails are
    # fixed up after the loop.
    ys = y0[:, None, :].expand(B, T, D).clone()

    m = 0
    while True:
        active = (t < end) & (n_acc + n_rej < max_steps)
        if not bool(active.any()):
            break
        finished = t >= end
        dt = torch.where(finished, 0.0, torch.minimum(dt, t_final - t))
        dt_safe = torch.where(dt == 0.0, 1.0, dt)

        y1, y_err, ks = rk_stage_loop(func, t[:, None], y, dt[:, None], DOPRI5,
                                      args, f0=f)
        # Step control is a discrete decision: cut from the graph.
        err = torch.clamp(norm_fn(y_err, y, y1, rtol, atol).detach(),
                          min=1e-10)
        accept = (err <= 1.0) | finished

        # PI controller on accept; plain shrink on reject.
        fac_acc = torch.clamp(safety * err ** (-_ALPHA) * err_prev ** _BETA,
                              dfactor, ifactor)
        fac_rej = torch.clamp(safety * err ** (-1.0 / _ORDER), dfactor, 1.0)
        dt_next = torch.where(finished, 0.0,
                              dt_safe * torch.where(accept, fac_acc, fac_rej))
        t_new = torch.where(accept, t + dt, t)

        # Dense output at every requested time this step covers.
        dy, r3, r4, r5 = _dense_coeffs(y, y1, ks, dt[:, None])
        theta = torch.clamp((ts - t[:, None]) / dt_safe[:, None], 0.0, 1.0)
        dense = _dense_eval(y, dy, r3, r4, r5, theta)
        adv = active & accept & ~finished
        if record is not None:
            record(m, active, t, dt, adv, y, ks)
        write = (adv[:, None] & (ts > t[:, None])
                 & (ts <= (t + dt + tiny)[:, None]))
        ys = torch.where(write[..., None], dense, ys)

        # A row that is done stays frozen, as a vmapped while_loop lane does.
        t = torch.where(active, t_new, t)
        dt = torch.where(active, dt_next, dt)
        err_prev = torch.where(adv, err, err_prev)
        y = torch.where(adv[:, None], y1, y)
        f = torch.where(adv[:, None], ks[6], f)     # FSAL: f(t_new, y1)
        n_acc = n_acc + adv.to(n_acc.dtype)
        n_rej = n_rej + (active & ~accept).to(n_rej.dtype)
        m += 1

    # Outputs past the frontier a row reached hold its last state.
    unreached = ts > (t + tiny)[:, None]
    return (torch.where(unreached[..., None], y[:, None, :], ys),
            Dopri5Stats(n_acc, n_rej, t >= end))


def _under_autograd(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in tensors)


def odeint_dopri5(func: Callable, y0: torch.Tensor, ts: torch.Tensor, *args,
                  rtol: float = 1e-7, atol: float = 1e-9, max_steps: int = 512,
                  safety: float = 0.9, ifactor: float = 10.0,
                  dfactor: float = 0.2, mode: str = "auto",
                  per_row: bool = False, unroll: int = 1,
                  checkpoint: bool = True, record=None,
                  norm_fn: Callable = error_norm, full_output: bool = False):
    """Integrate ``dy/dt = func(t, y, *args)`` adaptively, output at ``ts``.

    Args:
      ts: (T,) increasing output times; integration runs [ts[0], ts[-1]].
        With ``per_row`` also (B, T), each row of ``y0`` its own times.
      mode: 'auto', 'scan' or 'while' (see the module docstring).
      per_row: False — one controller over the whole of ``y0`` (any shape),
        ``func(t, y)`` with a scalar ``t``; returns ``(T, *y0.shape)``.
        True — ``y0`` is ``(B, D)``, each row stepped on its own,
        ``func(t, y)`` with ``t`` a ``(B, 1)`` column; returns ``(B, T, D)``.
      unroll, checkpoint: the JAX package's scan-mode performance knobs
        (attempts per scan iteration, rematerialisation); accepted and
        ignored, since the eager loop has neither.
      record: a callback that sees every attempt (``_solve_rows``); in
        the whole-state form it sees one row, the flattened state.
        ``ops/kanfet_adjoint.py`` (per row) and ``ops/node_common.py``
        (whole state) record the step mesh with it.
      norm_fn: the error norm ``(y_err, y0, y1, rtol, atol) -> (B,)`` of
        ``(B, D)`` rows (the flattened state in the whole-state form).
      full_output: also return ``Dopri5Stats``.
    """
    if mode not in ("auto", "scan", "while"):
        raise ValueError(f"odeint_dopri5 mode={mode!r}: expected "
                         "'auto', 'scan' or 'while'")
    ts = ts.to(y0.dtype)
    if per_row:
        if y0.ndim != 2:
            raise ValueError(f"per_row=True takes a (B, D) state, got "
                             f"{tuple(y0.shape)}")
        if ts.ndim not in (1, 2) or (ts.ndim == 2
                                     and ts.shape[0] != y0.shape[0]):
            raise ValueError(f"per_row=True takes (T,) or (B, T) times for "
                             f"{y0.shape[0]} rows, got {tuple(ts.shape)}")
        rows, fn = y0, func
    else:
        if ts.ndim != 1:
            raise ValueError(f"ts must be (T,), got {tuple(ts.shape)}")
        shape = y0.shape
        rows = y0.reshape(1, -1)

        def fn(t, y, *a):
            return func(t.reshape(()), y.reshape(shape), *a).reshape(1, -1)

    if mode == "auto":
        # As in the JAX package, the first stage carries whatever the field
        # closes over (its parameters), so it is checked with y0.
        f0 = fn(ts[..., :1].expand(rows.shape[0], 1), rows, *args)
        mode = "scan" if _under_autograd(rows, f0, *args) else "while"
    with torch.set_grad_enabled(mode == "scan" and torch.is_grad_enabled()):
        ys, stats = _solve_rows(fn, rows, ts, args, rtol, atol, max_steps,
                                safety, ifactor, dfactor, record, norm_fn)
    if not per_row:
        ys = ys[0].reshape((ts.shape[0],) + tuple(shape))
        stats = Dopri5Stats(*(v[0] for v in stats))
    return (ys, stats) if full_output else ys
