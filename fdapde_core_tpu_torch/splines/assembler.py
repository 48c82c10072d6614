"""Spline assembly: weighted Gram products over all Gauss points.

Port of ``fdapde_core_tpu/splines/assembler.py`` (counterpart of
fdaPDE-core's splines/spline_assembler.h:30-79). The reference loops basis
pairs (i, j) and integrates the weak form span-by-span over the support
intersection; summing Gauss-Legendre contributions over ALL spans gives
identical values (the integrand vanishes outside the support) and becomes
one product

    A = B_i^T diag(w) B_j

with B the (n_gauss_total, n_basis) basis (or derivative) tabulation. The
tables are a few hundred rows, so the products run on the host in float64
(NumPy) and only the results move to ``device``: the matrices as the port's
``SparseMatrix``, the forcing as a tensor.

Weak forms:
- Reaction<SPLINE>: c * psi_i * psi_j            (splines/operators/reaction.h:31-53)
- BiLaplacian<SPLINE>: -psi_i'' * psi_j''        (splines/operators/bilaplacian.h:30-41)
- dt: zero spatial contribution (parabolic trait only)
"""

from __future__ import annotations

import numpy as np
import torch

from ..linear_algebra.sparse import SparseMatrix
from ..pde.operators import BiLaplacian, Dt, Reaction

__all__ = ["assemble_forcing", "assemble_mass", "assemble_operator"]


def _gram(space, di: int, dj: int, weight=None) -> np.ndarray:
    Bi = space.basis.eval(space.quad_points, deriv=di)
    Bj = Bi if dj == di else space.basis.eval(space.quad_points, deriv=dj)
    w = space.quad_weights if weight is None else space.quad_weights * weight
    return Bi.T @ (w[:, None] * Bj)


def assemble_operator(space, op, dtype=torch.float64, device="cuda") -> SparseMatrix:
    """Discretize a DifferentialOp in the spline basis -> SparseMatrix."""
    n = space.n_dofs
    acc = np.zeros((n, n))
    for scale, leaf in op.terms:
        if isinstance(leaf, Dt):
            continue  # spatial weak form is zero (operators/dt.h:28-37)
        if isinstance(leaf, Reaction):
            c = leaf.c
            if callable(c):
                from ..utils.callables import eval_at_points

                cvals = eval_at_points(c, np.asarray(space.quad_points).reshape(-1, 1))
                acc = acc + scale * _gram(space, 0, 0, weight=cvals)
            else:
                acc = acc + scale * float(c) * _gram(space, 0, 0)
        elif isinstance(leaf, BiLaplacian):
            acc = acc - scale * _gram(space, 2, 2)  # leading minus (bilaplacian.h:37-40)
        else:
            raise ValueError(
                f"operator {leaf!r} has no SPLINE weak form (the reference "
                "supports Reaction and BiLaplacian: splines/operators/)"
            )
    return SparseMatrix.from_dense(acc, dtype=dtype, device=device)


def assemble_mass(space, dtype=torch.float64, device="cuda") -> SparseMatrix:
    """[R0]_ij = int phi_i phi_j (spline_solver_base.h:75-77)."""
    return SparseMatrix.from_dense(_gram(space, 0, 0), dtype=dtype, device=device)


def assemble_forcing(space, f, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """F_i = int f phi_i.

    The reference leaves spline forcing discretization as a TODO
    (spline_solver_base.h:72); implemented here with the same quadrature as
    the operators. `f` may be a callable or values at `space.quad_points`.
    """
    if callable(f):
        from ..utils.callables import eval_at_points

        fv = eval_at_points(f, np.asarray(space.quad_points).reshape(-1, 1))
    else:
        fv = f.cpu() if isinstance(f, torch.Tensor) else f
    B = space.basis.eval(space.quad_points)
    F = B.T @ (space.quad_weights * np.asarray(fv, dtype=np.float64).reshape(-1))
    return torch.as_tensor(F, device=device).to(dtype)
