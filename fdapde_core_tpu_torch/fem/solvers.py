"""FEM linear solvers with Dirichlet conditions by symmetric masking.

Port of ``fdapde_core_tpu/fem/solvers.py`` ``DirichletSystem``,
``masked_matrix``, ``solve_elliptic``, ``_recover_elliptic``,
``solve_parabolic`` and ``_diag_sparse``: boundary
rows and columns are masked and the boundary coupling moves to the
right-hand side,

    A~ v = mask(v) + free(A @ free(v));   b~ = free(b - A (g . mask)) + g . mask

whose solution equals g on the boundary dofs and leaves the interior
equations unchanged. Masking keeps an SPD operator SPD, so CG applies;
advection systems take BiCGStab.

The parabolic solver is implicit Euler (fem_linear_parabolic_solver.h:37-72):
K = A + M/dt (or A + diag(lump(M))/dt), per-step right-hand side
(M/dt) u_i + F_{i+1} and boundary values g_{i+1}, a Krylov solve
warm-started from the previous step. JAX runs the steps in a
``lax.scan``; here they are a host loop.

Differences from the JAX module: the recovery step skips the FSPAI rung on
purpose (``linear_algebra/fspai.py`` needs the package's native C++, not
ported yet) and says so in its warning, where JAX swallows a failed FSPAI
setup.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..linear_algebra.amg import AMG
from ..linear_algebra.lumping import lump
from ..linear_algebra.solvers import bicgstab, cg, gmres, jacobi_preconditioner
from ..linear_algebra.sparse import SparseMatrix

__all__ = ["DirichletSystem", "masked_matrix", "solve_elliptic", "solve_parabolic"]


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
    auxiliary structured-grid V-cycle (``ops/auxgrid.py``; 3D dof
    coordinates take ``AuxGridPreconditioner3D``), or "amg"
    (an SA-AMG V-cycle of the masked operator, ``linear_algebra/amg.py``,
    set up on the host). When the Krylov solve reports
    converged=False and ``recovery`` is set, escalate once to GMRES(50)
    warm-started from the last finite iterate. Returns (x, SolveInfo).
    """
    sys = DirichletSystem(A, mask)
    if preconditioner == "amg":
        pre = AMG.build(masked_matrix(A, mask)).v_cycle
    elif isinstance(preconditioner, tuple) and preconditioner[0] == "auxgrid":
        from ..ops.auxgrid import AuxGridPreconditioner, AuxGridPreconditioner3D

        coords = preconditioner[1]
        cls = AuxGridPreconditioner3D if coords.shape[1] == 3 else AuxGridPreconditioner
        diag = sys.diagonal()
        pre = cls.build(coords, diag, device=diag.device)
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


def solve_parabolic(A, Mass, F, mask, g, u0, times, rtol=1e-12, maxiter=None,
                    lumped=False, symmetric=True, recovery=True, return_info=False):
    """Implicit-Euler time stepping (fem_linear_parabolic_solver.h:37-72).

    A: stiffness, Mass: mass matrix (SparseMatrix), F: (n, m) forcing per
    time instant, g: (n, m) Dirichlet data per instant, u0: (n,) initial
    condition, times: (m,) uniform grid (dt from the first two entries, as
    upstream). lumped=True row-sum lumps the mass matrix (lumping.h:30), so
    M/dt is diagonal. Each step solves with a Jacobi preconditioner of the
    masked K, CG when symmetric else BiCGStab, warm-started from
    where(mask, g_next, u_prev).

    Recovery: every step's (converged, iterations) is kept; a stalled step
    poisons every later one, so if any step failed and ``recovery`` is set,
    the whole trajectory is run again once with GMRES(50), with a warning.
    return_info=True also returns {"converged": (m-1,) bool,
    "iterations": (m-1,) int64, "escalated": bool}, host tensors.

    Returns the (n, m) solution, column 0 = u0.
    """
    times = np.asarray(times.cpu() if isinstance(times, torch.Tensor) else times,
                       dtype=np.float64).reshape(-1)
    dt = float(times[1] - times[0])
    dev = A.vals.device
    if lumped:
        mdiag = lump(Mass) / dt

        def mass_apply(v):
            return mdiag * v

        K = A + _diag_sparse(mdiag)
    else:
        def mass_apply(v):
            return Mass @ v / dt

        K = A + Mass * (1.0 / dt)

    mask = torch.as_tensor(mask, device=dev)
    sys = DirichletSystem(K, mask)
    pre = jacobi_preconditioner(sys.diagonal())
    F = torch.as_tensor(F, device=dev)
    g = torch.as_tensor(g, device=dev)
    u0 = torch.as_tensor(u0, device=dev).reshape(-1)

    def run(krylov, **kw):
        u, us, conv, iters = u0, [u0], [], []
        for k in range(1, F.shape[1]):
            rhs = mass_apply(u) + F[:, k]
            b_mod = sys.rhs(rhs, g[:, k])
            x0 = torch.where(mask, g[:, k], u)
            u, info = krylov(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol, maxiter=maxiter, **kw)
            us.append(u)
            conv.append(bool(info.converged))
            iters.append(int(info.iterations))
        return torch.stack(us, dim=1), conv, iters

    out, conv, iters = run(cg if symmetric else bicgstab)
    escalated = False
    if recovery and not all(conv):
        first_bad = conv.index(False)
        warnings.warn(
            f"parabolic step {first_bad + 1} did not converge (and poisons "
            "every later step); re-running the trajectory with GMRES(50)",
            stacklevel=2,
        )
        escalated = True
        out, conv, iters = run(gmres, restart=50)
    if return_info:
        return out, {"converged": torch.tensor(conv, dtype=torch.bool),
                     "iterations": torch.tensor(iters, dtype=torch.int64),
                     "escalated": escalated}
    return out


def _diag_sparse(d):
    """diag(d) as a SparseMatrix on d's device."""
    n = d.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=d.device)
    return SparseMatrix(idx, idx, d, (n, n))
