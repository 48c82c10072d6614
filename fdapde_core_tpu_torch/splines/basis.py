"""B-spline bases by vectorized Cox-de Boor recursion.

Host-only NumPy copy of ``fdapde_core_tpu/splines/basis.py`` (counterpart of
fdaPDE-core's splines/basis/spline.h, compile-time recursion, and
spline_basis.h, knot padding and basis enumeration). Semantics match
exactly:

- knots are padded with R repeats of the first/last knot
  (spline_basis.h:38-50); the basis has n + R - 1 elements,
- order-0 splines are indicators of [u_i, u_{i+1}), returning 1 at the very
  last knot for the span adjacent to it (spline.h:67-83, tolerance 50*eps),
- zero-length spans give zero coefficients (guarded divisions,
  spline.h:44-46),
- derivatives follow the recursive formula
  d/dx N_{i,r} = r/(u_{i+r}-u_i) N_{i,r-1} - r/(u_{i+r+1}-u_{i+1}) N_{i+1,r-1}
  (spline.h:56-63).

Everything is evaluated as dense (n_points, n_basis) arrays in one pass: the
de Boor triangle is a loop of elementwise ops over the whole table.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pad_knots", "spline_basis_matrix", "SplineBasis"]

_TOL = 50 * np.finfo(np.float64).eps  # spline.h:71


def pad_knots(knots: np.ndarray, R: int) -> np.ndarray:
    """Pad with R repeats at both ends (spline_basis.h:38-50)."""
    knots = np.asarray(knots, dtype=np.float64).reshape(-1)
    return np.concatenate([np.full(R, knots[0]), knots, np.full(R, knots[-1])])


def _order0(padded: np.ndarray, x: np.ndarray, top_order: int) -> np.ndarray:
    """Indicator splines N_{i,0}: (npts, len(padded)-1)."""
    u = padded
    N = ((u[None, :-1] <= x[:, None]) & (x[:, None] < u[None, 1:])).astype(
        np.float64
    )
    # right-endpoint fix: x == last knot activates the span with index
    # len(padded) - top_order - 2 (spline.h:79-81)
    at_end = np.abs(x - u[-1]) < _TOL
    i_fix = len(u) - top_order - 2
    N[at_end, :] = 0.0
    N[at_end, i_fix] = 1.0
    return N


def spline_basis_matrix(
    knots: np.ndarray, R: int, x: np.ndarray, deriv: int = 0
) -> np.ndarray:
    """Evaluate all order-R B-splines (or their deriv-th derivative) at x.

    Returns (npts, n_basis) with n_basis = len(knots) + R - 1.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    u = pad_knots(knots, R)
    if deriv > R:
        return np.zeros((x.size, len(u) - R - 1))
    # de Boor triangle for values up to order R - deriv
    N = _order0(u, x, R)
    for r in range(1, R - deriv + 1):
        n = N.shape[1] - 1
        den_a = u[r : r + n] - u[:n]
        den_b = u[r + 1 : r + 1 + n] - u[1 : 1 + n]
        a = np.divide(1.0, den_a, out=np.zeros_like(den_a), where=den_a != 0)
        b = np.divide(1.0, den_b, out=np.zeros_like(den_b), where=den_b != 0)
        N = (
            a[None, :] * (x[:, None] - u[None, :n]) * N[:, :-1]
            + b[None, :] * (u[None, r + 1 : r + 1 + n] - x[:, None]) * N[:, 1:]
        )
    # derivative ladder: D N_{i,r} = r (a_i N_{i,r-1} - b_i N_{i+1,r-1})
    for r in range(R - deriv + 1, R + 1):
        n = N.shape[1] - 1
        den_a = u[r : r + n] - u[:n]
        den_b = u[r + 1 : r + 1 + n] - u[1 : 1 + n]
        a = np.divide(1.0, den_a, out=np.zeros_like(den_a), where=den_a != 0)
        b = np.divide(1.0, den_b, out=np.zeros_like(den_b), where=den_b != 0)
        N = r * (a[None, :] * N[:, :-1] - b[None, :] * N[:, 1:])
    return N


class SplineBasis:
    """Order-R spline basis over a knot vector (spline_basis.h:28-102)."""

    def __init__(self, knots: np.ndarray, R: int):
        self.R = R
        self.knots = np.asarray(knots, dtype=np.float64).reshape(-1)
        self.padded = pad_knots(self.knots, R)
        self.n_basis = self.knots.size + R - 1

    def eval(self, x, deriv: int = 0) -> np.ndarray:
        return spline_basis_matrix(self.knots, self.R, x, deriv)

    def __call__(self, i: int, x, deriv: int = 0):
        return self.eval(x, deriv)[:, i]

    def greville(self) -> np.ndarray:
        """Greville abscissae: natural dof coordinates of the basis."""
        u = self.padded
        R = self.R
        return np.array(
            [u[i + 1 : i + R + 1].mean() for i in range(self.n_basis)]
        )
