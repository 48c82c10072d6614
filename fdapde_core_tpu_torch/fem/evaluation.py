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
A pointwise build runs on ``device`` from the uploaded points, where JAX's
runs on the host: the cell ids stay there, and only the located points'
affine maps (``geometry.affine.affine_maps``), pulled-back points and basis
values are computed, in chunks of the locator's ``_BATCH`` points, in the
operation order of the host build. It is an ``evaluation.basis`` span
(``utils.profiling``; its value the points) made of ``evaluation.locate``
(the upload of the points and the point location) and ``evaluation.host``,
which holds the build, ``evaluation.device_build``. A pointwise row holds
the distinct dofs of one cell, so it has no duplicates: its entries are
put in column order directly, where JAX's ``from_coo`` sorts and
deduplicates all of them (same pattern and values).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import point_location
from ..geometry.affine import affine_maps
from ..linear_algebra.sparse import SparseMatrix
from ..utils.profiling import span

__all__ = ["basis_expansion", "eval_basis_areal", "eval_basis_pointwise"]


def eval_basis_pointwise(space, locs, device_locate: bool = False, dtype=torch.float64,
                         device="cuda"):
    """(Psi, D): Psi sparse (n_locs, n_dofs) on ``device``, D = ones
    (lagrangian_basis.h:203-235).

    device_locate=True runs the point location on ``device``
    (geometry.DeviceCellLocator, the same ids as the host locator): the
    scalable path for millions of observation points. Otherwise the host
    locator's ids are uploaded; the build is the same."""
    mesh = space.mesh
    locs = np.atleast_2d(np.asarray(locs, dtype=np.float64))
    with span("evaluation.basis", locs.shape[0]):
        with span("evaluation.locate"):
            pts = torch.as_tensor(locs, device=device)
            if device_locate:
                ids = mesh.locate_device(pts)
            else:
                ids = torch.as_tensor(mesh.locate(locs), device=device)
        with span("evaluation.host"), span("evaluation.device_build"):
            Psi = _pointwise_psi(space, pts, ids, dtype)
    return Psi, np.ones(locs.shape[0])


def _pointwise_psi(space, pts, ids, dtype):
    """Psi from the points (n, N) and their cell ids (n,) (-1 outside), on
    their device: the located points' rows in order, psi_j(p) for the nb
    dofs j of the point's cell in column order."""
    mesh, nb = space.mesh, space.n_basis_per_cell
    dev = pts.device
    inside = torch.nonzero(ids >= 0)[:, 0]  # sorted; its count is the build's one host read
    k = inside.shape[0]
    nodes = torch.as_tensor(mesh.nodes, dtype=torch.float64, device=dev)
    cells = torch.as_tensor(mesh.cells, device=dev)
    dofs = cells if space.dofs is mesh.cells else torch.as_tensor(space.dofs, device=dev)
    cols = torch.empty((k, nb), dtype=torch.int32, device=dev)
    vals = torch.empty((k, nb), dtype=torch.float64, device=dev)
    batch = point_location._BATCH
    for s in range(0, k, batch):
        i = inside[s:s + batch]
        e = ids[i].long()
        ce = cells[e]
        _, invJ, _ = affine_maps(nodes, ce)  # (b, M, N)
        d = pts[i] - nodes[ce[:, 0].long()]
        ref = invJ[:, :, 0] * d[:, :1]  # invJ (p - v0), summed over N in order
        for j in range(1, d.shape[1]):
            ref = ref + invJ[:, :, j] * d[:, j:j + 1]
        c, order = torch.sort(dofs[e], dim=1, stable=True)  # distinct within a row
        cols[s:s + batch] = c
        vals[s:s + batch] = space.ref_basis.eval(ref).gather(1, order)
    return SparseMatrix(inside.to(torch.int32).repeat_interleave(nb), cols.reshape(-1),
                        vals.reshape(-1).to(dtype), (pts.shape[0], space.n_dofs))


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
