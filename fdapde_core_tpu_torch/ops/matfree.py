"""Matrix-free general FEM operator: element-local matrices + the ELL
combine (AoS layout).

Port of ``fdapde_core_tpu/ops/matfree.py``. The operator action

    y = A x  =  combine( A_loc[c] @ x[dofs[c]] )

is evaluated element-locally, the combine a gather through the incidence
table of ``ops/ell.py``. ``MatrixFreeLocal`` has the operator protocol
(``@``, ``diagonal``, ``astype``) of ``fem/solvers.DirichletSystem``. The
device-scale path keeps the cell axis last instead (``ops/matfree_soa.py``);
these (C, nb, nb) forms are its oracle in the tests.
"""

from __future__ import annotations

import torch

from .ell import build_ell_adjacency, ell_spmv

__all__ = ["MatrixFreeLocal", "p1_local_stiffness", "p1_local_stiffness_3d"]


def p1_local_stiffness(nodes, cells, kappa=None):
    """Batched P1 triangle stiffness matrices (C, 3, 3) of +grad.grad
    (the -laplacian weak form, operators/laplacian.h:37-44), gradients from
    the adjugate of the affine map (simplex.h:184-195); kappa: optional
    per-cell (C,) diffusivity."""
    p = nodes[cells.long()]  # (C, 3, 2)
    e0 = p[:, 1] - p[:, 0]
    e1 = p[:, 2] - p[:, 0]
    det = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    inv_det = 1.0 / det
    g1 = torch.stack([e1[:, 1], -e1[:, 0]], dim=1) * inv_det[:, None]
    g2 = torch.stack([-e0[:, 1], e0[:, 0]], dim=1) * inv_det[:, None]
    g = torch.stack([-(g1 + g2), g1, g2], dim=1)  # (C, 3, 2)
    area = 0.5 * torch.abs(det)
    if kappa is not None:
        area = area * kappa
    return torch.einsum("cin,cjn->cij", g, g) * area[:, None, None]


def p1_local_stiffness_3d(nodes, cells, kappa=None):
    """Batched P1 tet stiffness matrices (C, 4, 4): grad(lam_1) =
    (c x d) / det and cyclic, grad(lam_0) = -sum, volume |det| / 6."""
    p = nodes[cells.long()]  # (C, 4, 3)
    b = p[:, 1] - p[:, 0]
    c = p[:, 2] - p[:, 0]
    d = p[:, 3] - p[:, 0]

    def cross(u, v):
        return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                            u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                            u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)

    cxd = cross(c, d)
    det = (b * cxd).sum(dim=1)
    inv_det = 1.0 / det
    g1 = cxd * inv_det[:, None]
    g2 = cross(d, b) * inv_det[:, None]
    g3 = cross(b, c) * inv_det[:, None]
    g = torch.stack([-(g1 + g2 + g3), g1, g2, g3], dim=1)  # (C, 4, 3)
    vol = torch.abs(det) / 6.0
    if kappa is not None:
        vol = vol * kappa
    return torch.einsum("cin,cjn->cij", g, g) * vol[:, None, None]


class MatrixFreeLocal:
    """y = A @ x from element-local matrices.

    A_loc (C, nb, nb) local matrices, dofs (C, nb) int32 dof table,
    adj/adj_mask (n, D) its incidence table (flat positions into the
    (C * nb,) element-local result and their validity).
    """

    def __init__(self, A_loc, dofs, adj, adj_mask, n_dofs: int):
        self.A_loc = A_loc
        self.dofs = dofs
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs

    @classmethod
    def build(cls, A_loc, dofs, n_dofs: int, max_degree: int):
        """max_degree bounds the (cell, slot) incidences per dof. Returns
        (operator, overflowed): overflowed means some dof has more, and the
        caller must rebuild with a larger bound."""
        dofs = torch.as_tensor(dofs)
        adj, mask, overflowed = build_ell_adjacency(dofs, n_dofs, max_degree)
        return cls(torch.as_tensor(A_loc), dofs, adj, mask, n_dofs), overflowed

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    def __matmul__(self, x):
        return ell_spmv(self.A_loc, self.dofs.long(), self.adj, self.adj_mask, x)

    def diagonal(self):
        """diag(A): the (c, i, i) local entries through the same table."""
        dloc = torch.diagonal(self.A_loc, dim1=1, dim2=2).reshape(-1)  # (C * nb,)
        return (dloc[self.adj] * self.adj_mask.to(dloc.dtype)).sum(dim=1)

    def astype(self, dtype):
        """Same table, local matrices stored in ``dtype``."""
        return MatrixFreeLocal(self.A_loc.to(dtype), self.dofs, self.adj, self.adj_mask,
                               self.n_dofs)
