"""Semilinear PDE solves via Newton iteration, with a BFGS fallback.

Port of ``fdapde_core_tpu/fem/nonlinear.py``. The reference core exposes
the nonlinear hook (the active-coefficient gather `f_` in the assembler,
fem_assembler.h:44,84-85) and leaves the Newton outer loop to downstream
packages; here the full solver ships:

    -div(K grad u) + h(u) = f  in Omega,   u = g on boundary

Newton: given u_k, solve  (A + M_{h'(u_k)}) delta = -(A u_k + B(u_k) - F)
on the free dofs (Dirichlet masking as in fem/solvers.py), u_{k+1} = u_k +
damping * delta, where

    B_i(u)  = int h(u) psi_i           (weighted forcing assembly)
    M_{w} = mass matrix weighted by w evaluated at quadrature points.

Differences from the JAX module: the Jacobian is ``A.with_vals(...)``, so
K2's sliced layout of the pattern is built once a solve (JAX builds a new
``SparseMatrix`` every step); the weighted mass and load are sums over the
space's fixed-order ``SegmentSum`` tables (JAX's ``segment_sum``); the BFGS
fallback's gradient of the energy runs through K2's backward
(``linear_algebra.sparse.SparseProduct``).
"""

from __future__ import annotations

import torch

from ..geometry.affine import affine_maps
from ..linear_algebra.solvers import cg, jacobi_preconditioner
from .assembler import _mesh_tensors, assemble_forcing, assemble_matrix
from .solvers import DirichletSystem

__all__ = ["solve_semilinear"]


def solve_semilinear(
    space,
    linear_op,
    h,
    dh,
    forcing,
    g,
    newton_tol: float = 1e-10,
    max_newton: int = 25,
    cg_rtol: float = 1e-12,
    damping: float = 1.0,
    bfgs_fallback: bool = False,
    H_potential=None,
    dtype=torch.float64,
    device="cuda",
):
    """Solve linear_op(u) + h(u) = forcing with Dirichlet data g, on
    ``device``.

    h, dh: elementwise torch callables (the nonlinearity and its
    derivative). Returns (u, info dict): "newton_iterations", "residuals"
    (the masked residual norm of each step), "method" ("newton" or
    "bfgs_fallback"), "cg_iterations" (each step's Jacobi CG; not in JAX's
    dict) and, after the fallback, "bfgs_iterations".

    With `bfgs_fallback=True` (BASELINE config 4: "Newton iteration with
    BFGS fallback"), a non-converged Newton loop falls back to BFGS
    minimization of the discrete energy

        E(u) = 1/2 u^T A u + int H(u) - F^T u,    H' = h

    (`H_potential`, an antiderivative of h, defaults to h(u)*u if omitted;
    supply it for exact energies). Dense-BFGS memory is O(n^2): intended
    for moderate n.
    """
    A = assemble_matrix(space, linear_op, dtype=dtype, device=device)
    F = assemble_forcing(space, forcing, dtype=dtype, device=device)
    mask = torch.as_tensor(space.boundary_dofs, device=device)
    g = torch.as_tensor(g, device=device).to(dtype)

    nodes, cells, phi, _, w = _mesh_tensors(space, dtype, device)
    _, _, measure = affine_maps(nodes, cells)
    dofs = torch.as_tensor(space.dofs, device=device).long()
    mass_sum = space.segment_sum("matrix", device)
    load_sum = space.segment_sum("forcing", device)

    def u_at_quad(u):
        return u[dofs] @ phi.T  # (C, nb) @ (nb, nq) -> (C, nq)

    def weighted_mass_vals(wq):
        """COO values of the mass matrix weighted by wq (C, nq)."""
        local = torch.einsum("cq,qi,qj,q->ijc", wq, phi, phi, w) * measure
        return mass_sum(local.reshape(-1))

    def weighted_load(wq):
        """int wq psi_i as a dof vector."""
        loc = torch.einsum("cq,qi,q->ic", wq, phi, w) * measure
        return load_sum(loc.reshape(-1))

    u = torch.where(mask, g, 0.0)
    history, cg_iterations = [], []
    for it in range(max_newton):
        uq = u_at_quad(u)
        R = A @ u + weighted_load(h(uq)) - F
        J = A.with_vals(A.vals + weighted_mass_vals(dh(uq)))
        sys = DirichletSystem(J, mask)
        rhs = -R * (~mask)  # delta = 0 on the boundary (u already equals g)
        pre = jacobi_preconditioner(sys.diagonal())
        delta, cg_info = cg(sys, rhs, M_inv=pre, rtol=cg_rtol)
        cg_iterations.append(cg_info.iterations)
        u = u + damping * delta
        res_norm = float(torch.linalg.norm(rhs))
        history.append(res_norm)
        if res_norm < newton_tol:
            break

    converged = history[-1] < newton_tol if history else False
    info = {"newton_iterations": it + 1, "residuals": history, "method": "newton",
            "cg_iterations": cg_iterations}
    if not converged and bfgs_fallback:
        # minimize the discrete energy over the FREE dofs with BFGS
        from ..optimization import bfgs as _bfgs

        free_idx = torch.nonzero(~mask).reshape(-1)
        gv = torch.where(mask, g, 0.0)
        Hpot = H_potential if H_potential is not None else (lambda v: h(v) * v)

        def energy(u_free):
            ufull = torch.index_put(gv, (free_idx,), u_free)
            # int H(u): quadrature of the potential
            pot = (Hpot(u_at_quad(ufull)) @ w) @ measure
            return 0.5 * torch.dot(ufull, A @ ufull) + pot - torch.dot(F, ufull)

        res = _bfgs(energy, u[free_idx], tol=1e-8, max_iter=500, line_search="backtracking")
        u = torch.index_put(gv, (free_idx,), res.x)
        info = {
            "newton_iterations": it + 1,
            "residuals": history,
            "method": "bfgs_fallback",
            "cg_iterations": cg_iterations,
            "bfgs_iterations": int(res.n_iter),
        }
    return u, info
