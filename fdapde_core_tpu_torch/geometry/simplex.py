"""Batched simplex utilities: barycentric coordinates, containment,
circumcenters, bounding boxes.

Host-only NumPy copy of ``fdapde_core_tpu/geometry/simplex.py``
(counterpart of fdaPDE-core's fdaPDE/geometry/simplex.h:33-203), vectorized
over many simplices and points; affine maps live in affine.py,
nearest-point projection in projection.py.
"""

from __future__ import annotations

import numpy as np

from .affine import affine_maps_np

MACHINE_EPSILON = 10 * np.finfo(np.float64).eps

__all__ = [
    "barycentric_coords",
    "contains",
    "circumcenters",
    "circumradii",
    "bounding_boxes",
    "barycenters",
]


def barycentric_coords(mesh, cell_ids, points) -> np.ndarray:
    """Barycentric coordinates of points[i] in cell cell_ids[i], (k, M+1)
    (simplex.h:70-75)."""
    _, invJ, _ = affine_maps_np(mesh.nodes, mesh.cells)
    cell_ids = np.asarray(cell_ids)
    points = np.atleast_2d(points)
    p0 = mesh.nodes[mesh.cells[cell_ids, 0]]
    z = np.einsum("kmn,kn->km", invJ[cell_ids], points - p0)
    z0 = 1.0 - z.sum(axis=1, keepdims=True)
    return np.concatenate([z0, z], axis=1)


def contains(mesh, cell_ids, points) -> np.ndarray:
    """Exact containment (simplex.h:115-127), incl. the manifold plane check."""
    from .point_location import contains as _contains

    return _contains(mesh, np.asarray(cell_ids), np.atleast_2d(points))


def barycenters(mesh) -> np.ndarray:
    return mesh.cell_barycenters


def bounding_boxes(mesh):
    """(lo, hi) per cell (simplex.h:62-64)."""
    coords = mesh.cell_coords
    return coords.min(axis=1), coords.max(axis=1)


def circumcenters(mesh) -> np.ndarray:
    """Circumcenters of all cells (simplex.h:78-100).

    Supports M == N (general dimension, Levy-Liu formula) and 2.5D surface
    triangles (cross-product formula).
    """
    coords = mesh.cell_coords  # (C, M+1, N)
    M, N = mesh.local_dim, mesh.embed_dim
    if M == 1:
        return coords.mean(axis=1)
    if M == 2 and N == 3:
        a = coords[:, 1] - coords[:, 0]
        b = coords[:, 2] - coords[:, 0]
        axb = np.cross(a, b)
        denom = 2 * (axb ** 2).sum(axis=1, keepdims=True)
        term = (np.cross(axb, a) * (b ** 2).sum(axis=1)[:, None]
                + np.cross(b, axb) * (a ** 2).sum(axis=1)[:, None])
        return coords[:, 0] + term / denom
    # M == N: solve  M_rows x = 0.5 (|p_i|^2 - |p_0|^2)
    rows = coords[:, 1:, :] - coords[:, :1, :]  # (C, M, N)
    rhs = 0.5 * ((coords[:, 1:, :] ** 2).sum(axis=2) - (coords[:, :1, :] ** 2).sum(axis=2))
    return np.linalg.solve(rows, rhs[..., None])[..., 0]


def circumradii(mesh) -> np.ndarray:
    cc = circumcenters(mesh)
    return np.linalg.norm(cc - mesh.cell_coords[:, 0], axis=1)
