"""SplineSpace: the spline discretization over an Interval mesh.

Host NumPy copy of ``fdapde_core_tpu/splines/space.py`` (counterpart of the
basis/solver-state bookkeeping in fdaPDE-core's
splines/solvers/spline_solver_base.h:33-89): the basis is built on the
domain's own knot vector (the interval nodes, spline_assembler.h:36),
quadrature is 3-point Gauss-Legendre per knot span (integrator.h:126-142).
``eval`` returns the port's ``SparseMatrix`` on ``device``.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..utils.quadrature import gauss_legendre_1d
from .basis import SplineBasis

__all__ = ["SplineSpace"]


class SplineSpace:
    """Order-R spline space over a 1D Interval triangulation."""

    def __init__(self, mesh, order: int = 3, n_quad: int = 3):
        self.mesh = mesh
        self.order = order
        knots = np.asarray(mesh.nodes).reshape(-1)
        self.basis = SplineBasis(knots, order)
        self.n_dofs = self.basis.n_basis
        self.n_quad = n_quad
        # Gauss-Legendre points per (padded) knot span; degenerate spans get
        # zero weight (the reference integrates them to 0 trivially,
        # spline_assembler.h:64-66)
        gl_x, gl_w = gauss_legendre_1d(n_quad)
        u = self.basis.padded
        a, b = u[:-1], u[1:]
        self._span_mid = 0.5 * (a + b)
        self._span_half = 0.5 * (b - a)
        pts = self._span_mid[:, None] + self._span_half[:, None] * gl_x[None, :]
        self.quad_points = pts.reshape(-1)  # (n_spans * n_quad,)
        self.quad_weights = (self._span_half[:, None] * gl_w[None, :]).reshape(-1)

    @cached_property
    def boundary_dofs(self) -> np.ndarray:
        """First/last basis functions interpolate the interval endpoints
        (clamped knots): natural Dirichlet dofs. The reference leaves spline
        BCs unimplemented (spline_solver_base.h:79 TODO)."""
        mask = np.zeros(self.n_dofs, dtype=bool)
        mask[0] = mask[-1] = True
        return mask

    @cached_property
    def dof_coords(self) -> np.ndarray:
        """Greville abscissae (natural interpolation points of the basis)."""
        return self.basis.greville()[:, None]

    @property
    def quadrature_nodes(self) -> np.ndarray:
        return self.quad_points[:, None]

    def eval(self, locs, policy: str = "pointwise", dtype=torch.float64, device="cuda"):
        """Phi matrix of basis evaluations, a SparseMatrix on ``device``.

        pointwise (spline_basis.h:80-102): Phi[i, j] = phi_j(t_i).
        areal (left TODO upstream, spline_basis.h:105-113; implemented here):
        `locs` is a binary incidence matrix (n_subdomains, n_cells) over the
        interval's cells; Phi[k, j] = (int_{D_k} phi_j) / |D_k|, D holds the
        subdomain measures.
        """
        from ..linear_algebra.sparse import SparseMatrix

        kw = dict(dtype=dtype, device=device)
        if policy == "pointwise":
            locs = np.asarray(locs, dtype=np.float64).reshape(-1)
            dense = self.basis.eval(locs)
            return SparseMatrix.from_dense(dense, **kw), np.ones(locs.size)
        if policy != "areal":
            raise ValueError(policy)
        incidence = np.asarray(locs)
        R = self.order
        # span s of the padded knots covers mesh cell s - R (interior spans)
        B = self.basis.eval(self.quad_points)  # (n_spans * nq, n_basis)
        wB = self.quad_weights[:, None] * B
        span_int = wB.reshape(-1, self.n_quad, self.n_dofs).sum(axis=1)
        cell_int = span_int[R : R + self.mesh.n_cells]  # (n_cells, n_basis)
        cell_meas = np.diff(np.asarray(self.mesh.nodes).reshape(-1))
        D = incidence @ cell_meas
        dense = (incidence @ cell_int) / D[:, None]
        return SparseMatrix.from_dense(dense, **kw), D
