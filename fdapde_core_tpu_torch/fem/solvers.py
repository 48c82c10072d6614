"""FEM linear solvers with Dirichlet conditions by symmetric masking.

Port of ``fdapde_core_tpu/fem/solvers.py`` ``DirichletSystem``,
``masked_matrix``, ``solve_elliptic`` and ``_recover_elliptic``: boundary
rows and columns are masked and the boundary coupling moves to the
right-hand side,

    A~ v = mask(v) + free(A @ free(v));   b~ = free(b - A (g . mask)) + g . mask

whose solution equals g on the boundary dofs and leaves the interior
equations unchanged. Masking keeps an SPD operator SPD, so CG applies;
advection systems take BiCGStab.

Differences from the JAX module: the recovery step skips the FSPAI rung on
purpose (``linear_algebra/fspai.py`` needs the package's native C++, not
ported yet) and says so in its warning, where JAX swallows a failed FSPAI
setup; ``preconditioner="amg"`` and ``solve_parabolic`` raise
NotImplementedError (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from ..linear_algebra.solvers import bicgstab, cg, gmres, jacobi_preconditioner

__all__ = ["DirichletSystem", "masked_matrix", "solve_elliptic", "solve_parabolic"]

_TODO_AMG = ("preconditioner='amg' (linear_algebra/amg.py, smoothed-aggregation AMG) "
             "is not ported yet: ROADMAP queue 1 item 3")


class DirichletSystem(NamedTuple):
    """A linear operator (anything with ``@`` and ``diagonal()``) with the
    Dirichlet dofs in ``mask`` ((n,) bool) pinned by masking."""

    A: object
    mask: torch.Tensor

    def __call__(self, v):
        free = ~self.mask
        if v.dim() == 2:
            fm = free[:, None]
            return (self.A @ (v * fm)) * fm + v * (~free)[:, None]
        w = (self.A @ (v * free)) * free
        return w + v * self.mask

    def rhs(self, b, g):
        """Move the boundary data g to the right-hand side b."""
        gm = torch.where(self.mask, g, 0.0)
        b2 = (b - self.A @ gm) * (~self.mask)
        return b2 + gm

    def diagonal(self):
        d = self.A.diagonal()
        return torch.where(self.mask, 1.0, d)


def masked_matrix(A, mask):
    """A (a ``SparseMatrix``) with Dirichlet rows/cols dropped and 1 on the
    masked diagonal entries: the explicit counterpart of DirichletSystem's
    masking, for preconditioner setups that need the matrix entries.
    Assumes the diagonal is in A's pattern (true for FEM operators)."""
    mask = torch.as_tensor(mask, device=A.vals.device)
    rows, cols = A.rows.long(), A.cols.long()
    keep = (~mask)[rows] & (~mask)[cols]
    vals = torch.where(keep, A.vals, 0.0)
    vals = torch.where((rows == cols) & mask[rows], 1.0, vals)
    return A.with_vals(vals)


def solve_elliptic(A, b, mask, g, symmetric=True, rtol=1e-12, maxiter=None,
                   recovery=True, preconditioner=None):
    """Solve A u = b with Dirichlet data g on the ``mask`` dofs.

    CG when the operator is symmetric, BiCGStab otherwise. preconditioner:
    None (Jacobi), a callable M_inv(r), ("auxgrid", dof_coords) for the
    auxiliary structured-grid V-cycle (``ops/auxgrid.py``, 2D), or "amg"
    (not ported: raises NotImplementedError). When the Krylov solve reports
    converged=False and ``recovery`` is set, escalate once to GMRES(50)
    warm-started from the last finite iterate. Returns (x, SolveInfo).
    """
    sys = DirichletSystem(A, mask)
    if preconditioner == "amg":
        raise NotImplementedError(_TODO_AMG)
    if isinstance(preconditioner, tuple) and preconditioner[0] == "auxgrid":
        from ..ops.auxgrid import AuxGridPreconditioner

        coords = preconditioner[1]
        if coords.shape[1] != 2:
            raise NotImplementedError(
                "the 3D auxiliary grid (AuxGridPreconditioner3D) is not ported yet: "
                "ROADMAP queue 1, slice 4")
        diag = sys.diagonal()
        pre = AuxGridPreconditioner.build(coords, diag, device=diag.device)
    else:
        pre = preconditioner or jacobi_preconditioner(sys.diagonal())
    b_mod = sys.rhs(b, g)
    x0 = torch.where(mask, g, 0.0)
    solver = cg if symmetric else bicgstab
    x, info = solver(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol, maxiter=maxiter)
    if recovery and not info.converged:
        x, info = _recover_elliptic(sys, b_mod, x, x0, rtol, maxiter, pre)
    return x, info


def _recover_elliptic(sys, b_mod, x, x0, rtol, maxiter, pre):
    """One escalation step: GMRES(50) with the same preconditioner,
    restarted from the stalled iterate unless it is not finite (a Krylov
    breakdown)."""
    x_start = x if bool(torch.isfinite(x).all()) else x0
    warnings.warn(
        "elliptic solve did not converge; escalating to GMRES(50) with the same "
        "preconditioner (the FSPAI rung of the JAX package is not ported: "
        "ROADMAP queue 3)",
        stacklevel=3,
    )
    return gmres(sys, b_mod, M_inv=pre, x0=x_start, rtol=rtol, maxiter=maxiter, restart=50)


def solve_parabolic(*args, **kwargs):
    """Implicit-Euler time stepping: not ported yet."""
    raise NotImplementedError("solve_parabolic is not ported yet: ROADMAP queue 1 item 3")
