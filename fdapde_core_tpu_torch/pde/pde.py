"""The PDE problem descriptor.

Port of ``fdapde_core_tpu/pde/pde.py``, elliptic and parabolic, with
``discretization="fem"`` or ``"spline"`` (counterpart of fdaPDE-core's
pde.h:40-114):

    mesh = Triangulation(nodes, cells, boundary)
    pde = PDE(mesh, -laplacian(), order=1)     # device="cuda", float64
    pde.set_dirichlet_bc(g)           # g: values at dof coordinates
    pde.set_forcing(f)                # callable, or array over quadrature nodes
    pde.init()                        # assemble stiff/mass/force on the device
    pde.solve()                       # CG / BiCGStab / implicit Euler
    u = pde.solution()

The solver is parabolic iff the operator holds a ``dt()`` term (then
``times`` and ``set_initial_condition`` are needed; forcing and Dirichlet
data may carry one column per instant). The mesh and the FEM or spline
space stay on the host (NumPy); matrices, vectors and the solve live on
``device``.

Spans (``utils.profiling``): ``init`` is a ``pde.init`` span valued by
the dofs, with a ``pde.init.stiff``, ``pde.init.mass`` and
``pde.init.force`` span for each assembled term; ``solve`` is a
``pde.solve`` span, which holds the preconditioner's ``precond.build``
(one a solve, also a parabolic one; one more, valued 1, when the "auto"
ladder falls back to SA-AMG), a parabolic solve's ``parabolic.setup``
spans (here the Dirichlet data's columns and the upload of them and of
the initial condition; K in ``solve_parabolic``) and ``parabolic.step``
spans, and the Krylov loop's spans.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..utils.profiling import span
from .operators import DifferentialOp, reaction

__all__ = ["PDE"]

# beyond this size, a Jacobi CG pays more iterations than the auxgrid setup
# costs: switch to the "auto" preconditioner ladder
_AUTO_PRECOND_DOFS = 20_000


class PDE:
    """An initialized boundary-value problem over a mesh.

    solver_preconditioner (elliptic and parabolic solves): None (Jacobi
    below 20,000 dofs, "auto" above), "auto" (the auxiliary grid, 2D or 3D
    after the dof coordinates, and SA-AMG where the auxiliary grid fails to
    build), "auxgrid", "amg" or a callable M_inv(r). A parabolic solve
    builds it once, for K = A + M/dt, and every step reuses it.
    """

    def __init__(
        self,
        domain,
        operator: DifferentialOp,
        forcing=None,
        times=None,
        order: int = 1,
        discretization: str = "fem",
        solver_rtol: float = 1e-12,
        solver_maxiter: int | None = None,
        lumped_mass: bool = False,
        solver_preconditioner=None,
        device="cuda",
        dtype=torch.float64,
    ):
        if discretization == "fem":
            from ..fem.space import FEMSpace

            self.space = FEMSpace(domain, order)
        elif discretization == "spline":
            from ..splines.space import SplineSpace

            self.space = SplineSpace(domain, order)
        else:
            raise ValueError(discretization)

        self.domain = domain
        self.operator = operator
        self.times = None if times is None else np.asarray(times, dtype=np.float64).reshape(-1)
        self.order = order
        self.discretization = discretization
        self.solver_rtol = solver_rtol
        self.solver_maxiter = solver_maxiter
        self.lumped_mass = lumped_mass
        self.solver_preconditioner = solver_preconditioner
        self.device = torch.device(device)
        self.dtype = dtype

        self._forcing = forcing
        self._dirichlet = None
        self._initial_condition = None
        self._stiff = None
        self._mass = None
        self._force = None
        self._solution = None
        self.is_init = False
        self.success = False

    # -- setters (pde.h:74-85) ----------------------------------------------
    def set_forcing(self, f):
        self._forcing = f

    def set_dirichlet_bc(self, g):
        self._dirichlet = np.asarray(g, dtype=np.float64)

    def set_initial_condition(self, u0):
        self._initial_condition = np.asarray(u0, dtype=np.float64).reshape(-1)

    def set_differential_operator(self, L: DifferentialOp):
        self.operator = L

    # -- queries (pde.h:86-100) ----------------------------------------------
    def dof_coords(self) -> np.ndarray:
        return self.space.dof_coords

    def quadrature_nodes(self) -> np.ndarray:
        return self.space.quadrature_nodes

    @property
    def n_dofs(self) -> int:
        return self.space.n_dofs

    def stiff(self):
        return self._stiff

    def mass(self):
        return self._mass

    def force(self):
        return self._force

    def solution(self):
        return self._solution

    @property
    def is_parabolic(self) -> bool:
        return self.operator.is_parabolic

    def eval_functional_basis(self, locs, policy: str = "pointwise"):
        """Psi matrix of basis evaluations (pde.h:89-92), a SparseMatrix on
        the PDE's device, and the subdomain measures D."""
        kw = dict(dtype=self.dtype, device=self.device)
        if self.discretization == "spline":
            return self.space.eval(locs, policy, **kw)
        from ..fem.evaluation import eval_basis_areal, eval_basis_pointwise

        if policy == "pointwise":
            return eval_basis_pointwise(self.space, locs, **kw)
        if policy == "areal":
            return eval_basis_areal(self.space, locs, **kw)
        raise ValueError(policy)

    # -- init: assembly (fem_solver_base.h:104-139) ---------------------------
    def init(self):
        kw = dict(dtype=self.dtype, device=self.device)
        with span("pde.init", self.space.n_dofs):
            if self.discretization == "spline":
                from ..splines import assembler as spline_asm

                assemble_forcing = spline_asm.assemble_forcing
                with span("pde.init.stiff"):
                    self._stiff = spline_asm.assemble_operator(self.space, self.operator, **kw)
                with span("pde.init.mass"):
                    self._mass = spline_asm.assemble_mass(self.space, **kw)
            else:
                from ..fem.assembler import assemble_forcing, assemble_matrix

                with span("pde.init.stiff"):
                    self._stiff = assemble_matrix(self.space, self.operator, **kw)
                with span("pde.init.mass"):
                    self._mass = assemble_matrix(self.space, reaction(1.0), **kw)
            with span("pde.init.force"):
                if self._forcing is not None:
                    self._force = assemble_forcing(self.space, self._forcing, **kw)
                else:
                    self._force = torch.zeros(self.space.n_dofs, **kw)
        self.is_init = True
        return self

    # -- solve (fem_linear_{elliptic,parabolic}_solver.h) ---------------------
    def solve(self):
        t0 = time.time()
        with span("pde.solve"):
            if not self.is_init:
                self.init()
            if self.is_parabolic:
                self._solve_parabolic()
            else:
                self._solve_elliptic()
        self.solve_seconds = time.time() - t0
        return self._solution

    def _boundary(self):
        """(mask, g as a float64 host array or None) of the Dirichlet data."""
        if self._dirichlet is None:
            # no boundary data set: solve the raw system (the reference
            # imposes conditions only when supplied; splines upstream have no
            # BC handling at all, spline_solver_base.h:79)
            return torch.zeros(self.space.n_dofs, dtype=torch.bool, device=self.device), None
        return torch.as_tensor(self.space.boundary_dofs, device=self.device), self._dirichlet

    def _on_ladder(self, run):
        """run(preconditioner) on the rung that ``solver_preconditioner``
        selects, for the elliptic and the parabolic solve alike. "auto"
        (also the default beyond _AUTO_PRECOND_DOFS): the auxiliary grid
        first (3D dof coordinates take the 3D grid), then SA-AMG where the
        auxiliary grid fails to build (``AuxGridBuildError``); any other
        error, a kernel's or the device's in the solve among them,
        propagates. Sets ``ladder_fallback`` when it falls back."""
        from ..fem.solvers import AuxGridBuildError

        precond = self.solver_preconditioner
        auto = precond == "auto" or (precond is None and self.space.n_dofs >= _AUTO_PRECOND_DOFS)
        if precond == "auxgrid" or auto:
            precond = ("auxgrid", self.space.dof_coords)
        self.ladder_fallback = False
        try:
            return run(precond)
        except AuxGridBuildError as exc:  # the next rung of the ladder
            if not auto:
                raise
            warnings.warn(f"the auxiliary-grid rung failed to build ({exc}); "
                          "falling back to SA-AMG", stacklevel=4)
            self.ladder_fallback = True
            return run("amg")

    def _solve_elliptic(self):
        from ..fem.solvers import solve_elliptic

        mask, g = self._boundary()
        g = np.zeros(self.space.n_dofs) if g is None else g.reshape(-1)
        g = torch.as_tensor(g, device=self.device).to(self.dtype)
        x, info = self._on_ladder(lambda pre: solve_elliptic(
            self._stiff, self._force.reshape(-1), mask, g,
            symmetric=self.operator.is_symmetric, rtol=self.solver_rtol,
            maxiter=self.solver_maxiter, preconditioner=pre,
        ))
        self._solution = x
        self.solve_info = info
        self.success = bool(info.converged)

    def _solve_parabolic(self):
        from ..fem.solvers import solve_parabolic

        if self.times is None:
            raise ValueError("parabolic problems need a time grid (times=)")
        if self._initial_condition is None:
            raise ValueError("parabolic problems need an initial condition (pde.h:83)")
        T = self.times.size
        mask, g = self._boundary()
        with span("parabolic.setup"):
            if g is None:
                g = np.zeros((self.space.n_dofs, T))
            elif g.ndim == 1:
                g = np.tile(g[:, None], (1, T))
            F = self._force
            if F.dim() == 1:
                F = F[:, None].expand(-1, T)
            g = torch.as_tensor(g, device=self.device).to(self.dtype)
            u0 = torch.as_tensor(self._initial_condition, device=self.device).to(self.dtype)
        self._solution, self.step_info = self._on_ladder(lambda pre: solve_parabolic(
            self._stiff, self._mass, F, mask, g, u0, self.times, rtol=self.solver_rtol,
            maxiter=self.solver_maxiter, lumped=self.lumped_mass,
            symmetric=self.operator.is_symmetric, return_info=True, preconditioner=pre,
        ))
        self.success = bool(self.step_info["converged"].all())

    def report(self) -> dict:
        """Per-solve record: problem size, operator sparsity, solver
        iterations and final residual (a parabolic solve: each step's
        iterations), the preconditioner's rung ("auxgrid", "amg", "jacobi"
        or "callable"), whether the "auto" ladder fell back from the
        auxiliary grid to SA-AMG, and whether the escalation to GMRES(50)
        ran (``recovered``; a parabolic solve's trajectory rerun
        ``escalated``)."""
        rec = {
            "discretization": self.discretization,
            "order": self.order,
            "n_dofs": self.n_dofs,
            "is_parabolic": self.is_parabolic,
            "is_init": self.is_init,
            "success": self.success,
        }
        if self._stiff is not None:
            rec["stiff_nnz"] = self._stiff.nnz
        if hasattr(self, "solve_info"):
            rec["solver_iterations"] = int(self.solve_info.iterations)
            rec["solver_residual"] = float(self.solve_info.residual)
            rec["solver_converged"] = bool(self.solve_info.converged)
            rec["preconditioner"] = self.solve_info.rung
            rec["ladder_fallback"] = self.ladder_fallback
            rec["recovered"] = self.solve_info.recovered
        if hasattr(self, "step_info"):
            rec["step_iterations"] = self.step_info["iterations"].tolist()
            rec["escalated"] = self.step_info["escalated"]
            rec["preconditioner"] = self.step_info["rung"]
            rec["ladder_fallback"] = self.ladder_fallback
        if hasattr(self, "solve_seconds"):
            rec["solve_seconds"] = round(self.solve_seconds, 4)
        return rec

    # -- error functional (fem_pde_test.cpp:72-74) ----------------------------
    def l2_error(self, exact_at_dofs) -> float:
        """Mass-weighted squared L2 error functional of the reference
        tests: (mass @ (e * e)).sum(); for an (n, m) parabolic solution,
        the largest such sum over the time columns."""
        exact = exact_at_dofs
        if not isinstance(exact, torch.Tensor):
            exact = torch.as_tensor(np.asarray(exact, dtype=np.float64))
        e = exact.to(self.device, self.dtype).reshape(self._solution.shape) - self._solution
        if e.dim() == 1:
            return float((self._mass @ (e * e)).sum())
        return float((self._mass @ (e * e)).sum(dim=0).max())
