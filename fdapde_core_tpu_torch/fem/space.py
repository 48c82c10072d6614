"""FEMSpace: degrees of freedom, basis tabulations, and scatter structure.

Counterpart of the reference's `LagrangianBasis` dof handler
(fdaPDE-core fdaPDE/finite_elements/basis/lagrangian_basis.h:94-183) plus
the sparsity preprocessing that replaces Eigen `setFromTriplets`. A copy
of ``fdapde_core_tpu/fem/space.py`` (host NumPy), plus ``segment_sum``: the
fixed-order device scatter tables the port's assembly uses in place of
JAX's ``segment_sum``.

Dof numbering parity with the reference (so that P1/P2 golden matrices match):
- order 1: dof i == mesh node i (lagrangian_basis.h:96-99),
- order 2: dofs are mesh nodes followed by one dof per edge, numbered
  n_nodes + edge_id with the first-encounter edge numbering of the
  triangulation (lagrangian_basis.h:100-134); the dof sits in cell slot
  (M+1) + local_edge_index (lex edge order),
- a P2 edge dof is on the boundary iff its edge is (lagrangian_basis.h:124).
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from ..utils.combinatorics import combinations
from .basis import LagrangeBasis, tabulate_basis

__all__ = ["FEMSpace"]


class FEMSpace:
    """Lagrange finite-element space of order R over a triangulation."""

    def __init__(self, mesh, order: int = 1):
        if order not in (1, 2, 3):
            raise NotImplementedError(
                "FEM orders 1-3 are supported (the reference enumerates "
                "dofs only up to 2, lagrangian_basis.h:94)"
            )
        if order == 3 and mesh.local_dim != 2:
            raise NotImplementedError("order 3 is available for 2D meshes")
        self.mesh = mesh
        self.order = order
        self._segment_sums = {}  # (which, device) -> SegmentSum, see segment_sum
        M = mesh.local_dim
        self.ref_basis = LagrangeBasis(M, order)
        self.quad, self.phi_tab, self.grad_tab = tabulate_basis(M, order)
        self.n_basis_per_cell = self.ref_basis.n_basis

        if order == 1:
            self.dofs = mesh.cells
            self.n_dofs = mesh.n_nodes
            self.boundary_dofs = mesh.boundary_node_markers().copy()
        elif order == 2:
            edge_dofs = mesh.n_nodes + mesh.cell_to_edges  # (C, n_edges_per_cell)
            self.dofs = np.concatenate([mesh.cells, edge_dofs], axis=1).astype(
                np.int32
            )
            self.n_dofs = mesh.n_nodes + mesh.n_edges
            self.boundary_dofs = np.concatenate(
                [mesh.boundary_node_markers(), mesh.boundary_edges]
            )
        else:  # order 3 (2D): 2 dofs per edge (orientation-consistent) + 1 interior
            from ..utils.combinatorics import combinations

            C = mesh.n_cells
            pattern = combinations(2, M + 1)  # lex local edges
            cells = mesh.cells
            c2e = mesh.cell_to_edges
            edge_slots = np.zeros((C, 2 * pattern.shape[0]), dtype=np.int64)
            edges = mesh.edges  # rows sorted (u < v); dofs along u -> v
            for j, (a, b) in enumerate(pattern):
                e = c2e[:, j]
                ga, gb = cells[:, a], cells[:, b]
                d1 = mesh.n_nodes + 2 * e  # at 1/3 from min(u,v)
                d2 = d1 + 1  # at 2/3
                fwd = ga < gb  # local direction matches the sorted edge
                edge_slots[:, 2 * j] = np.where(fwd, d1, d2)
                edge_slots[:, 2 * j + 1] = np.where(fwd, d2, d1)
            interior = (mesh.n_nodes + 2 * mesh.n_edges + np.arange(C))[:, None]
            self.dofs = np.concatenate(
                [cells, edge_slots, interior], axis=1
            ).astype(np.int32)
            self.n_dofs = mesh.n_nodes + 2 * mesh.n_edges + C
            self.boundary_dofs = np.concatenate(
                [
                    mesh.boundary_node_markers(),
                    np.repeat(mesh.boundary_edges, 2),
                    np.zeros(C, dtype=bool),
                ]
            )

    # -- coordinates ---------------------------------------------------------
    @cached_property
    def dof_coords(self) -> np.ndarray:
        """Physical coordinates of each dof (lagrangian_basis.h:159-183)."""
        if self.order == 1:
            return self.mesh.nodes
        if self.order == 2:
            mids = self.mesh.nodes[self.mesh.edges].mean(axis=1)
            return np.concatenate([self.mesh.nodes, mids], axis=0)
        # order 3: thirds along each sorted edge, then cell barycenters
        u = self.mesh.nodes[self.mesh.edges[:, 0]]
        v = self.mesh.nodes[self.mesh.edges[:, 1]]
        pts = np.empty((2 * self.mesh.n_edges, self.mesh.embed_dim))
        pts[0::2] = u + (v - u) / 3.0
        pts[1::2] = u + 2.0 * (v - u) / 3.0
        return np.concatenate(
            [self.mesh.nodes, pts, self.mesh.cell_barycenters], axis=0
        )

    @cached_property
    def quadrature_nodes(self) -> np.ndarray:
        """Physical quadrature nodes, row `nq * cell + q` (integrator.h:109-121)."""
        coords = self.mesh.cell_coords  # (C, M+1, N)
        qn = self.quad.nodes  # (nq, M)
        # x = v0 + J @ q ; J columns = v_{j+1} - v_0
        J = np.swapaxes(coords[:, 1:, :] - coords[:, :1, :], 1, 2)  # (C,N,M)
        phys = coords[:, None, 0, :] + np.einsum("cnm,qm->cqn", J, qn)
        return phys.reshape(-1, self.mesh.embed_dim)

    @property
    def n_quad(self) -> int:
        return self.quad.num_nodes

    # -- scatter structure (setFromTriplets equivalent) -----------------------
    @cached_property
    def scatter(self):
        """(rows, cols, inverse) for scatter-add assembly.

        rows/cols: (nnz,) sorted unique (row, col) pairs of the stiffness
        pattern; inverse: (C*nb*nb,) mapping the flattened local matrices
        (cell-major, i-row-major) to their global slot. Host-side, computed
        once per space; the device-side assembly is then a single
        `segment_sum` (the scatter-add semantics of fem_assembler.h:99-112).
        """
        from ..linear_algebra.sparse import coo_sum_duplicates

        nb = self.n_basis_per_cell
        rows = np.repeat(self.dofs, nb, axis=1).reshape(-1)
        cols = np.tile(self.dofs, (1, nb)).reshape(-1)
        r, c, inv = coo_sum_duplicates(rows, cols, self.n_dofs, self.n_dofs)
        return r, c, inv

    def segment_sum(self, which: str, device):
        """The fixed-order scatter of device assembly
        (``linear_algebra.sparse.SegmentSum``), built once per device:

        - "matrix": (nb, nb, C) cell-last local matrices, flattened, into
          the nnz slots of ``scatter`` (its inverse permuted to that order);
        - "forcing": (nb, C) cell-last local vectors, flattened, into the
          n_dofs entries.
        """
        from ..linear_algebra.sparse import SegmentSum

        key = (which, str(device))
        cache = self._segment_sums
        if key not in cache:
            C, nb = self.mesh.n_cells, self.n_basis_per_cell
            if which == "matrix":
                rows, _, inv = self.scatter
                ids, n_out = inv.reshape(C, nb * nb).T, rows.shape[0]
            elif which == "forcing":
                ids, n_out = self.dofs.T, self.n_dofs
            else:
                raise ValueError(which)
            cache[key] = SegmentSum.build(ids, n_out, device)
        return cache[key]

    def __repr__(self):
        return (
            f"FEMSpace(order={self.order}, n_dofs={self.n_dofs}, "
            f"mesh={self.mesh!r})"
        )
