"""Point-to-mesh projection.

Host-only NumPy copy of ``fdapde_core_tpu/geometry/projection.py``
(counterpart of fdaPDE-core's fdaPDE/geometry/project.h): find, for each
query point, its best approximation on the mesh. `exact` scans every
cell's nearest point (project.h Exact policy); the default approximate
policy finds the nearest mesh node via the KD-tree and searches only its
cell patch (project.h:34-69 NotExact).
"""

from __future__ import annotations

import numpy as np

from .kd_tree import KDTree

__all__ = ["project", "nearest_on_simplex"]


def nearest_on_simplex(coords: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Nearest point to `p` on the simplex with vertex rows `coords`.

    Recursive descent to the nearest boundary sub-simplex, mirroring
    Simplex::nearest (simplex.h:157-181).
    """
    coords = np.asarray(coords, dtype=np.float64)
    k = coords.shape[0]  # number of vertices = local_dim + 1
    # least squares for the barycentric coordinates
    D = (coords[1:] - coords[0]).T
    z, *_ = np.linalg.lstsq(D, p - coords[0], rcond=None)
    bary = np.concatenate([[1.0 - z.sum()], z])
    eps = 10 * np.finfo(np.float64).eps
    proj = coords[0] + D @ z
    if (bary >= -eps).all():
        return proj
    if k == 2:
        return coords[1] if bary[0] < 0 else coords[0]
    # recurse on the facet excluding the farthest vertex (simplex.h:171-179)
    dst = np.linalg.norm(coords - p, axis=1)
    keep = np.argsort(dst, kind="stable")[:-1]
    return nearest_on_simplex(coords[np.sort(keep)], p)


def _nearest_over(mesh, cells, p, best, bd):
    for c in cells:
        q = nearest_on_simplex(mesh.cell_coords[c], p)
        d = np.linalg.norm(q - p)
        if d < bd:
            best, bd = q, d
    return best


def project(mesh, points: np.ndarray, exact: bool = False) -> np.ndarray:
    """Project each point onto the mesh surface/volume."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    out = np.empty_like(points)
    if exact:
        for i, p in enumerate(points):
            out[i] = _nearest_over(mesh, range(mesh.n_cells), p, None, np.inf)
        return out
    tree = KDTree(mesh.nodes)
    for i, p in enumerate(points):
        nid = tree.nn_search(p)
        out[i] = _nearest_over(mesh, mesh.node_patch(nid), p, mesh.nodes[nid],
                               np.linalg.norm(mesh.nodes[nid] - p))
    return out
