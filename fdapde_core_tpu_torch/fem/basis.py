"""Lagrange polynomial bases on the reference simplex (host-only NumPy; a
copy of ``fdapde_core_tpu/fem/basis.py``).

Counterpart of fdaPDE-core fdaPDE/finite_elements/basis/multivariate_polynomial.h
and the Vandermonde construction in lagrangian_basis.h:65-91: basis function i
is the polynomial of total degree <= R with psi_i(node_j) = delta_ij. Instead
of compile-time monomial recursion we precompute, host-side in f64:

- the monomial exponent table (all alpha with |alpha| <= R),
- the coefficient matrix C = V^{-1} (V the Vandermonde at the element nodes),
- dense tabulations (values and gradients) at arbitrary points — in
  particular at quadrature nodes, which is all the assembly kernels need.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np

from .reference_element import n_basis, reference_nodes

__all__ = ["monomial_exponents", "LagrangeBasis", "tabulate_basis"]


def monomial_exponents(M: int, R: int) -> np.ndarray:
    """All exponent multi-indices with total degree <= R, (nb, M).

    Deterministic graded-lexicographic order. (The reference's `ct_poly_exp`
    uses a different order; the interpolating polynomial — hence everything
    downstream — is order-independent.)
    """
    exps = [e for e in product(range(R + 1), repeat=M) if sum(e) <= R]
    exps.sort(key=lambda e: (sum(e), e))
    return np.asarray(exps, dtype=np.int64).reshape(-1, M)


def _monomials(points: np.ndarray, exps: np.ndarray) -> np.ndarray:
    """Evaluate all monomials at points: (npts, nmono)."""
    # points: (n, M); exps: (k, M)
    return np.prod(points[:, None, :] ** exps[None, :, :], axis=2)


def _monomial_grads(points: np.ndarray, exps: np.ndarray) -> np.ndarray:
    """Gradients of all monomials at points: (npts, nmono, M)."""
    n, M = points.shape
    k = exps.shape[0]
    out = np.zeros((n, k, M))
    for d in range(M):
        e = exps.copy()
        coef = e[:, d].astype(np.float64)
        e[:, d] = np.maximum(e[:, d] - 1, 0)
        out[:, :, d] = coef[None, :] * np.prod(
            points[:, None, :] ** e[None, :, :], axis=2
        )
    return out


class LagrangeBasis:
    """Order-R Lagrange basis on the unit M-simplex (host-side tabulator)."""

    def __init__(self, M: int, R: int):
        self.M, self.R = M, R
        self.nodes = reference_nodes(M, R)
        self.exps = monomial_exponents(M, R)
        V = _monomials(self.nodes, self.exps)  # (nb, nb) Vandermonde
        self.coeffs = np.linalg.inv(V)  # column i = coeffs of psi_i
        self.n_basis = n_basis(M, R)

    def eval(self, points: np.ndarray) -> np.ndarray:
        """psi_i(p): (npts, nb)."""
        return _monomials(np.atleast_2d(points), self.exps) @ self.coeffs

    def grad(self, points: np.ndarray) -> np.ndarray:
        """grad psi_i(p): (npts, nb, M)."""
        g = _monomial_grads(np.atleast_2d(points), self.exps)  # (n, k, M)
        return np.einsum("nkm,ki->nim", g, self.coeffs)


@lru_cache(maxsize=None)
def tabulate_basis(M: int, R: int, table: str = "fem"):
    """(quadrature, phi_tab (nq,nb), grad_tab (nq,nb,M)) for the standard rule."""
    from ..utils.quadrature import standard_fem_quadrature

    basis = LagrangeBasis(M, R)
    quad = standard_fem_quadrature(M, R)
    return quad, basis.eval(quad.nodes), basis.grad(quad.nodes)
