"""Explicit Runge-Kutta Butcher tableaux (counterpart of
``fetode_tpu/solvers/tableaux.py``).

The fixed-step methods of ``solvers/fixed.py`` (Euler, explicit
midpoint, Heun, the classical RK4 and Dormand-Prince's 5th-order row
without step control) and the Dormand-Prince 5(4) pair with its
dense-output coefficients.  Coefficients are plain Python floats, so a
product with a float32 tensor stays float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple


class ButcherTableau(NamedTuple):
    """Coefficients of an explicit RK method.

    a     : (s, s) strictly lower-triangular stage weights
    b     : (s,)   solution weights
    c     : (s,)   stage times
    b_err : (s,)   optional — (b - b_low) for the embedded error estimate
    order : int    classical order of the ``b`` solution
    """

    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int
    b_err: Optional[Tuple[float, ...]] = None


def _tab(a, b, c, order, b_err=None) -> ButcherTableau:
    s = len(b)
    a_full = tuple(tuple(float(row[j]) if j < len(row) else 0.0
                         for j in range(s)) for row in a)
    return ButcherTableau(
        a=a_full, b=tuple(float(v) for v in b), c=tuple(float(v) for v in c),
        order=order,
        b_err=tuple(float(v) for v in b_err) if b_err is not None else None)


EULER = _tab(a=[[]], b=[1.0], c=[0.0], order=1)

MIDPOINT = _tab(a=[[], [0.5]], b=[0.0, 1.0], c=[0.0, 0.5], order=2)

HEUN = _tab(a=[[], [1.0]], b=[0.5, 0.5], c=[0.0, 1.0], order=2)

# The reference's "RK2" is the explicit midpoint method.
RK2 = MIDPOINT

RK4 = _tab(
    a=[[], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
    b=[1 / 6, 1 / 3, 1 / 3, 1 / 6],
    c=[0.0, 0.5, 0.5, 1.0],
    order=4,
)

# Dormand-Prince 5(4) pair, FSAL: the b row equals the last a row, so the
# 7th stage of an accepted step is the first stage of the next.
_DOPRI5_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DOPRI5_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DOPRI5_B_LOW = [
    5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
    -92097 / 339200, 187 / 2100, 1 / 40,
]
DOPRI5 = _tab(
    a=_DOPRI5_A,
    b=_DOPRI5_B,
    c=[0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
    order=5,
    b_err=[bh - bl for bh, bl in zip(_DOPRI5_B, _DOPRI5_B_LOW)],
)

# Hairer's dense-output coefficients for DOPRI5 (order-4 continuous
# extension; "Solving Ordinary Differential Equations I", CONTD5).
DOPRI5_DENSE_D = (
    -12715105075 / 11282082432,
    0.0,
    87487479700 / 32700410799,
    -10690763975 / 1880347072,
    701980252875 / 199316789632,
    -1453857185 / 822651844,
    69997945 / 29380423,
)

FIXED_TABLEAUX = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "rk2": RK2,
    "heun": HEUN,
    "rk4": RK4,
    "dopri5_fixed": DOPRI5,
}
