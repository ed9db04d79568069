"""Continuous-adjoint differentiation for the adaptive solver
(counterpart of ``fetode_tpu/solvers/adjoint.py``).

``odeint_adjoint`` gives optimise-then-discretise gradients:

* forward: the early-exit ``while``-mode dopri5, no graph kept;
* backward: the augmented system ``d/dt [y, a, g] = [f, -a^T df/dy,
  -a^T df/dargs]`` integrated in reverse time between output times,
  adding each output's cotangent to ``a`` as it is crossed.

Memory is O(state), independent of the step count.  Step control of the
backward covers (y, a) only, the seminorm of "'Hey, that's not an ODE':
Faster ODE Adjoints via Seminorms" (arXiv:2009.09457): the parameter
channels are integrals of already-controlled quantities.

The cotangents of ``ts`` are the boundary terms ``dL/dt_i = g_i .
f(t_i, y_i)``, with the conservation term at t0.

The state is a tensor and the augmented system is solved as one
flattened vector [y, a, g] (the JAX package keeps the three as a
pytree); gradients reach ``y0``, ``ts`` and the tensors of ``args``,
which is where the field's parameters go: a parameter the field closes
over gets no gradient.
"""

from __future__ import annotations

from typing import Callable

import torch

from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
from fetode_tpu_torch.solvers.rk_common import error_norm


def _seminorm(n: int):
    """The error norm over the first ``n`` entries of each row: the state
    and its adjoint, not the parameter accumulators."""
    def norm(y_err, y0, y1, rtol, atol):
        return error_norm(y_err[:, :n], y0[:, :n], y1[:, :n], rtol, atol)
    return norm


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, opts, y0, ts, *args):
        ys = odeint_dopri5(lambda t, y: func(t, y, *args), y0, ts,
                           rtol=opts["rtol"], atol=opts["atol"],
                           max_steps=opts["max_steps"], mode="while")
        ctx.func, ctx.opts = func, opts
        ctx.save_for_backward(ys, ts, *args)
        return ys

    @staticmethod
    def backward(ctx, g):
        ys, ts, *args = ctx.saved_tensors
        func, opts = ctx.func, ctx.opts
        shape, ny = ys.shape[1:], ys[0].numel()
        sizes = [ny, ny] + [p.numel() for p in args]

        def aug_field(t, aug):
            """The reverse-time augmented field at time -t."""
            y, a, *_ = torch.split(aug, sizes)
            with torch.enable_grad():
                yy = y.reshape(shape).detach().requires_grad_()
                pp = [p.detach().requires_grad_() for p in args]
                f = func(-t, yy, *pp)
                vjp = torch.autograd.grad(f, [yy] + pp, a.reshape(shape),
                                          allow_unused=True)
            vjp = [torch.zeros_like(x) if v is None else v
                   for v, x in zip(vjp, [yy] + pp)]
            # d/d(-t): y' = -f, a' = +a^T df/dy, g' = +a^T df/dargs
            return torch.cat([-f.detach().reshape(-1)]
                             + [v.reshape(-1) for v in vjp])

        with torch.no_grad():
            a = torch.zeros_like(ys[0])
            g_args = [torch.zeros_like(p) for p in args]
            t_bar = torch.zeros_like(ts)
            for i1 in range(ts.shape[0] - 1, 0, -1):
                t1, t0 = ts[i1], ts[i1 - 1]
                a = a + g[i1]
                t_bar[i1] += torch.sum(g[i1] * func(t1, ys[i1], *args))
                aug0 = torch.cat([ys[i1].reshape(-1), a.reshape(-1)]
                                 + [p.reshape(-1) for p in g_args])
                aug1 = odeint_dopri5(
                    aug_field, aug0, torch.stack([-t1, -t0]),
                    rtol=opts["adjoint_rtol"], atol=opts["adjoint_atol"],
                    max_steps=opts["max_steps"], mode="while",
                    norm_fn=_seminorm(2 * ny))[-1]
                _, a, *g_flat = torch.split(aug1, sizes)
                a = a.reshape(shape)
                g_args = [v.reshape(p.shape) for v, p in zip(g_flat, args)]
            # the cotangent at t0: the remaining adjoint and its time term
            a = a + g[0]
            t_bar[0] -= torch.sum(a * func(ts[0], ys[0], *args))
        return (None, None, a, t_bar, *g_args)


def odeint_adjoint(func: Callable, y0: torch.Tensor, ts: torch.Tensor, *args,
                   rtol: float = 1e-7, atol: float = 1e-9,
                   max_steps: int = 512, adjoint_rtol: float | None = None,
                   adjoint_atol: float | None = None) -> torch.Tensor:
    """Like ``odeint_dopri5`` (whole-state form, ``func(t, y, *args)``)
    but with continuous-adjoint gradients for ``y0``, ``ts`` and the
    tensors of ``args``.  Returns ``(T, *y0.shape)``."""
    opts = dict(rtol=rtol, atol=atol, max_steps=max_steps,
                adjoint_rtol=rtol if adjoint_rtol is None else adjoint_rtol,
                adjoint_atol=atol if adjoint_atol is None else adjoint_atol)
    return _Adjoint.apply(func, opts, y0, ts.to(y0.dtype), *args)
