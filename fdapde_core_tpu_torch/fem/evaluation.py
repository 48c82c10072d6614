"""Basis evaluation at data locations: the Psi matrix of data-mesh coupling.

Port of ``fdapde_core_tpu/fem/evaluation.py`` (counterpart of the
evaluation policies in fdaPDE-core's
finite_elements/basis/lagrangian_basis.h:203-283):

- pointwise: Psi[i, j] = psi_j(p_i) for each location p_i, built by locating
  each point and evaluating the reference basis at the pulled-back point
  invJ (p - v0); rows of points outside the domain are empty,
- areal: Psi[k, j] = (int_{D_k} psi_j) / |D_k| for subdomains D_k given by a
  binary incidence matrix over cells; D holds the subdomain measures.

Psi is the port's ``SparseMatrix`` on ``device``; its products run on K2.
The entries are computed on the host, as in JAX. A pointwise row holds the
distinct dofs of one cell, so it has no duplicates: its entries are put in
column order directly, where JAX's ``from_coo`` sorts and deduplicates all
of them (same pattern and values).
"""

from __future__ import annotations

import numpy as np
import torch

from ..linear_algebra.sparse import SparseMatrix

__all__ = ["basis_expansion", "eval_basis_areal", "eval_basis_pointwise"]


def eval_basis_pointwise(space, locs, device_locate: bool = False, dtype=torch.float64,
                         device="cuda"):
    """(Psi, D): Psi sparse (n_locs, n_dofs) on ``device``, D = ones
    (lagrangian_basis.h:203-235).

    device_locate=True runs the point location on ``device``
    (geometry.DeviceCellLocator, the same ids as the host locator): the
    scalable path for millions of observation points."""
    from ..geometry.affine import affine_maps_np

    mesh = space.mesh
    locs = np.atleast_2d(np.asarray(locs, dtype=np.float64))
    if device_locate:
        ids = mesh.locate_device(locs, device=device).cpu().numpy()
    else:
        ids = mesh.locate(locs)
    inside = np.nonzero(ids >= 0)[0]
    e = ids[inside]
    _, invJ, _ = affine_maps_np(mesh.nodes, mesh.cells)
    v0 = mesh.nodes[mesh.cells[e, 0]]
    ref_pts = np.einsum("kmn,kn->km", invJ[e], locs[inside] - v0)
    vals = space.ref_basis.eval(ref_pts)  # (k, nb)
    nb = space.n_basis_per_cell
    dofs = space.dofs[e]  # (k, nb), distinct within a row
    order = np.argsort(dofs, axis=1, kind="stable")
    rows = np.repeat(inside, nb).astype(np.int32)
    cols = np.take_along_axis(dofs, order, axis=1).reshape(-1).astype(np.int32)
    vals = np.take_along_axis(vals, order, axis=1).reshape(-1)
    Psi = SparseMatrix(
        torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device),
        torch.as_tensor(vals, device=device).to(dtype), (locs.shape[0], space.n_dofs),
    )
    return Psi, np.ones(locs.shape[0])


def eval_basis_areal(space, incidence, dtype=torch.float64, device="cuda"):
    """(Psi, D) for areal observations (lagrangian_basis.h:237-283).

    incidence: binary (n_subdomains, n_cells); Psi[k, j] = mean over D_k of
    psi_j; D[k] = measure of D_k (host array).
    """
    mesh = space.mesh
    incidence = np.asarray(incidence)
    n_sub = incidence.shape[0]
    measures = mesh.measures
    # per-cell integrals of each local basis fn: int_e psi_h = measure_e *
    # sum_q w_q phi[q, h]
    cell_int = measures[:, None] * (space.quad.weights @ space.phi_tab)  # (C, nb)
    D = incidence.astype(np.float64) @ measures  # (n_sub,)
    ks, cells_k = np.nonzero(incidence == 1)
    nb = space.n_basis_per_cell
    rows = np.repeat(ks, nb)
    cols = space.dofs[cells_k].reshape(-1)
    vals = (cell_int[cells_k] / D[ks, None]).reshape(-1)
    vals = torch.as_tensor(vals, device=device).to(dtype)
    return SparseMatrix.from_coo(rows, cols, vals, (n_sub, space.n_dofs)), D


def basis_expansion(space, coeffs, locs, device="cuda"):
    """Evaluate sum_i c_i psi_i at locations (lagrangian_basis.h:186-200);
    a tensor on ``device``."""
    Psi, _ = eval_basis_pointwise(space, locs, device=device)
    return Psi @ torch.as_tensor(coeffs, dtype=torch.float64, device=device)
