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

Recovery: a non-converged elliptic solve escalates once to GMRES(50),
with an FSPAI preconditioner (``linear_algebra/fspai.py``, native set-up,
applied as two K2 products) on symmetric systems of at most 200,000 dofs,
as in JAX. Difference: JAX keeps its first preconditioner when the FSPAI
set-up raises anything; here only a numerical failure of the set-up
(``LinAlgError``) does, and a failed native build raises. An operator that
is not a ``SparseMatrix`` (DIA storage) keeps its preconditioner, where
JAX's FSPAI set-up raises on it and is caught: the same rung.

Spans (``utils.profiling``): a solve's preconditioner set-up, once an
elliptic solve or a trajectory, is a ``precond.build`` span valued by its
rung (``RUNGS``: 0 the auxiliary grid, 1 SA-AMG, 2 Jacobi or a caller's
callable); a trajectory's set-up outside its steps and its preconditioner
(K = A + M/dt, the placement of F, g and u0) a ``parabolic.setup`` span;
each implicit-Euler step a ``parabolic.step`` span valued by its Krylov
iterations; the escalation to GMRES(50), of an elliptic solve or of a whole
trajectory, a ``krylov.recover`` span.

An auxiliary grid that fails to build raises ``AuxGridBuildError``, the
one failure on which ``PDE``'s "auto" ladder takes its next rung; an
error of the solve itself (a kernel's launch, device memory) propagates.
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
from ..utils.profiling import span

__all__ = ["AuxGridBuildError", "DirichletSystem", "masked_matrix", "solve_elliptic",
           "solve_parabolic"]

# the value of a ``precond.build`` span: the preconditioner's rung
RUNGS = {"auxgrid": 0, "amg": 1, "jacobi": 2, "callable": 2}


class AuxGridBuildError(RuntimeError):
    """The auxiliary grid's set-up failed for this mesh (the cause is
    chained); out of device memory is not such a failure and propagates as
    it is."""


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


def _build_preconditioner(sys, preconditioner):
    """(M_inv, rung) for the masked operator ``sys``, set up inside a
    ``precond.build`` span valued by its rung. preconditioner: None
    (Jacobi), a callable M_inv(r), ("auxgrid", dof_coords) (3D coordinates
    take ``AuxGridPreconditioner3D``; a failed build raises
    ``AuxGridBuildError``) or "amg" (SA-AMG of the masked matrix)."""
    auxgrid = isinstance(preconditioner, tuple) and preconditioner[0] == "auxgrid"
    rung = ("auxgrid" if auxgrid else "amg" if preconditioner == "amg" else
            "callable" if callable(preconditioner) else "jacobi")
    with span("precond.build", RUNGS[rung]):
        if rung == "amg":
            pre = AMG.build(masked_matrix(sys.A, sys.mask)).v_cycle
        elif auxgrid:
            from ..ops.auxgrid import AuxGridPreconditioner, AuxGridPreconditioner3D

            coords = preconditioner[1]
            cls = AuxGridPreconditioner3D if coords.shape[1] == 3 else AuxGridPreconditioner
            diag = sys.diagonal()
            try:
                pre = cls.build(coords, diag, device=diag.device)
            except torch.OutOfMemoryError:
                raise
            except Exception as exc:
                raise AuxGridBuildError(f"{type(exc).__name__}: {exc}") from exc
        else:
            pre = preconditioner or jacobi_preconditioner(sys.diagonal())
    return pre, rung


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
    warm-started from the last finite iterate. Returns (x, SolveInfo), the
    info's ``rung`` the preconditioner's (a key of ``RUNGS``) and its
    ``recovered`` whether the escalation ran.
    """
    sys = DirichletSystem(A, mask)
    pre, rung = _build_preconditioner(sys, preconditioner)
    b_mod = sys.rhs(b, g)
    x0 = torch.where(mask, g, 0.0)
    solver = cg if symmetric else bicgstab
    x, info = solver(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol, maxiter=maxiter)
    recovered = recovery and not info.converged
    if recovered:
        with span("krylov.recover"):
            x, info = _recover_elliptic(A, sys, b_mod, x, x0, symmetric, rtol, maxiter, pre)
    return x, info._replace(rung=rung, recovered=recovered)


_FSPAI_RECOVERY_MAX_DOFS = 200_000  # host-side set-up cost bound


def _recover_elliptic(A, sys, b_mod, x, x0, symmetric, rtol, maxiter, pre):
    """One escalation step: a stronger solver (GMRES(50)) and, when
    affordable, a stronger preconditioner (FSPAI of the masked operator),
    restarted from the stalled iterate unless it is not finite (a Krylov
    breakdown)."""
    x_start = x if bool(torch.isfinite(x).all()) else x0
    pre_strong = pre
    if symmetric and isinstance(A, SparseMatrix) and sys.A.shape[0] <= _FSPAI_RECOVERY_MAX_DOFS:
        from ..linear_algebra.fspai import fspai

        try:
            L = fspai(masked_matrix(A, sys.mask), alpha=8, beta=8, epsilon=1e-4)

            def pre_strong(r):
                return L @ L.rmatvec(r)
        except np.linalg.LinAlgError:  # keep the first preconditioner
            pre_strong = pre
    warnings.warn(
        "elliptic solve did not converge; escalating to GMRES(50) "
        f"({'FSPAI' if pre_strong is not pre else 'Jacobi'}-preconditioned)",
        stacklevel=3,
    )
    return gmres(sys, b_mod, M_inv=pre_strong, x0=x_start, rtol=rtol, maxiter=maxiter,
                 restart=50)


def solve_parabolic(A, Mass, F, mask, g, u0, times, rtol=1e-12, maxiter=None,
                    lumped=False, symmetric=True, recovery=True, return_info=False,
                    preconditioner=None):
    """Implicit-Euler time stepping (fem_linear_parabolic_solver.h:37-72).

    A: stiffness, Mass: mass matrix (SparseMatrix), F: (n, m) forcing per
    time instant, g: (n, m) Dirichlet data per instant, u0: (n,) initial
    condition, times: (m,) uniform grid (dt from the first two entries, as
    upstream). lumped=True row-sum lumps the mass matrix (lumping.h:30), so
    M/dt is diagonal. Each step solves with one preconditioner of the
    masked K, built once before the first step (``preconditioner`` as in
    ``solve_elliptic``: None for Jacobi, a callable, ("auxgrid",
    dof_coords) or "amg"), CG when symmetric else BiCGStab, warm-started
    from where(mask, g_next, u_prev).

    Recovery: every step's (converged, iterations) is kept; a stalled step
    poisons every later one, so if any step failed and ``recovery`` is set,
    the whole trajectory is run again once with GMRES(50) on the same
    preconditioner, with a warning. return_info=True also returns
    {"converged": (m-1,) bool, "iterations": (m-1,) int64, "escalated":
    bool, "rung": the preconditioner's (a key of ``RUNGS``)}, host tensors.

    Returns the (n, m) solution, column 0 = u0.
    """
    times = np.asarray(times.cpu() if isinstance(times, torch.Tensor) else times,
                       dtype=np.float64).reshape(-1)
    dt = float(times[1] - times[0])
    dev = A.vals.device
    with span("parabolic.setup"):
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
        F = torch.as_tensor(F, device=dev)
        g = torch.as_tensor(g, device=dev)
        u0 = torch.as_tensor(u0, device=dev).reshape(-1)
    pre, rung = _build_preconditioner(sys, preconditioner)

    def run(krylov, **kw):
        u, us, conv, iters = u0, [u0], [], []
        for k in range(1, F.shape[1]):
            with span("parabolic.step") as step:
                rhs = mass_apply(u) + F[:, k]
                b_mod = sys.rhs(rhs, g[:, k])
                x0 = torch.where(mask, g[:, k], u)
                u, info = krylov(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol, maxiter=maxiter, **kw)
                step.value = int(info.iterations)
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
        with span("krylov.recover"):
            out, conv, iters = run(gmres, restart=50)
    if return_info:
        return out, {"converged": torch.tensor(conv, dtype=torch.bool),
                     "iterations": torch.tensor(iters, dtype=torch.int64),
                     "escalated": escalated, "rung": rung}
    return out


def _diag_sparse(d):
    """diag(d) as a SparseMatrix on d's device."""
    n = d.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=d.device)
    return SparseMatrix(idx, idx, d, (n, n))
