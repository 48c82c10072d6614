"""The PDE problem descriptor.

Port of ``fdapde_core_tpu/pde/pde.py`` for elliptic operators, with
``discretization="fem"`` or ``"spline"`` (counterpart of fdaPDE-core's
pde.h:40-114):

    mesh = Triangulation(nodes, cells, boundary)
    pde = PDE(mesh, -laplacian(), order=1)     # device="cuda", float64
    pde.set_dirichlet_bc(g)           # g: values at dof coordinates
    pde.set_forcing(f)                # callable, or array over quadrature nodes
    pde.init()                        # assemble stiff/mass/force on the device
    pde.solve()                       # CG / BiCGStab
    u = pde.solution()

The mesh and the FEM or spline space stay on the host (NumPy); matrices,
vectors and the solve live on ``device``. Not ported yet, each raising
NotImplementedError with its ROADMAP item: parabolic problems (a ``dt()``
term or ``times``) and the "amg" rung of the preconditioner ladder.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .operators import DifferentialOp, reaction

__all__ = ["PDE"]

# beyond this size, a Jacobi CG pays more iterations than the auxgrid setup
# costs: switch to the "auto" preconditioner ladder
_AUTO_PRECOND_DOFS = 20_000

_TODO_PARABOLIC = "parabolic problems (solve_parabolic) are not ported yet: ROADMAP queue 1 item 3"


class PDE:
    """An initialized boundary-value problem over a mesh.

    solver_preconditioner: None (Jacobi below 20,000 dofs, "auto" above),
    "auto" (the auxiliary grid; its fallback rung, SA-AMG, is not ported
    and raises, chained to the auxiliary grid's error), "auxgrid", "amg"
    (raises NotImplementedError) or a callable M_inv(r).
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
        if times is not None or operator.is_parabolic:
            raise NotImplementedError(_TODO_PARABOLIC)
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
        self.times = None
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
        raise NotImplementedError(_TODO_PARABOLIC)

    def set_differential_operator(self, L: DifferentialOp):
        if L.is_parabolic:
            raise NotImplementedError(_TODO_PARABOLIC)
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
        if self.discretization == "spline":
            from ..splines import assembler as spline_asm

            self._stiff = spline_asm.assemble_operator(self.space, self.operator, **kw)
            self._mass = spline_asm.assemble_mass(self.space, **kw)
            assemble_forcing = spline_asm.assemble_forcing
        else:
            from ..fem.assembler import assemble_forcing, assemble_matrix

            self._stiff = assemble_matrix(self.space, self.operator, **kw)
            self._mass = assemble_matrix(self.space, reaction(1.0), **kw)
        if self._forcing is not None:
            self._force = assemble_forcing(self.space, self._forcing, **kw)
        else:
            self._force = torch.zeros(self.space.n_dofs, **kw)
        self.is_init = True
        return self

    # -- solve (fem_linear_elliptic_solver.h) ---------------------------------
    def solve(self):
        from ..fem.solvers import solve_elliptic

        t0 = time.time()
        if not self.is_init:
            self.init()
        kw = dict(dtype=self.dtype, device=self.device)
        if self._dirichlet is None:
            # no boundary data set: solve the raw system (the reference
            # imposes conditions only when supplied; splines upstream have no
            # BC handling at all, spline_solver_base.h:79)
            mask = torch.zeros(self.space.n_dofs, dtype=torch.bool, device=self.device)
            g = torch.zeros(self.space.n_dofs, **kw)
        else:
            mask = torch.as_tensor(self.space.boundary_dofs, device=self.device)
            g = torch.as_tensor(self._dirichlet.reshape(-1), device=self.device).to(self.dtype)

        # preconditioner selection. "auto" (also the default beyond
        # _AUTO_PRECOND_DOFS): the auxiliary grid first, then SA-AMG for
        # domains no covering grid preconditions (not ported: it raises)
        precond = self.solver_preconditioner
        auto = precond == "auto" or (precond is None and self.space.n_dofs >= _AUTO_PRECOND_DOFS)
        if precond == "auxgrid" or auto:
            precond = ("auxgrid", self.space.dof_coords)

        def run(pre):
            return solve_elliptic(
                self._stiff, self._force.reshape(-1), mask, g,
                symmetric=self.operator.is_symmetric, rtol=self.solver_rtol,
                maxiter=self.solver_maxiter, preconditioner=pre,
            )

        if auto:
            try:
                x, info = run(precond)
            except Exception as aux_error:  # the next rung of the ladder
                try:
                    x, info = run("amg")
                except NotImplementedError as amg_error:
                    raise amg_error from aux_error
        else:
            x, info = run(precond)
        self._solution = x
        self.solve_info = info
        self.success = bool(info.converged)
        self.solve_seconds = time.time() - t0
        return self._solution

    def report(self) -> dict:
        """Per-solve record: problem size, operator sparsity, solver
        iterations and final residual."""
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
        if hasattr(self, "solve_seconds"):
            rec["solve_seconds"] = round(self.solve_seconds, 4)
        return rec

    # -- error functional (fem_pde_test.cpp:72-74) ----------------------------
    def l2_error(self, exact_at_dofs) -> float:
        """Mass-weighted squared L2 error functional of the reference
        tests: (mass @ (e * e)).sum()."""
        exact = exact_at_dofs
        if not isinstance(exact, torch.Tensor):
            exact = torch.as_tensor(np.asarray(exact, dtype=np.float64))
        e = exact.to(self.device, self.dtype).reshape(self._solution.shape) - self._solution
        return float((self._mass @ (e * e)).sum())
