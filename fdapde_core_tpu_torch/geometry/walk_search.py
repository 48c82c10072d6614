"""Barycentric walk point location for convex planar meshes.

Host-only NumPy copy of ``fdapde_core_tpu/geometry/walk_search.py``
(counterpart of fdaPDE-core's fdaPDE/geometry/walk_search.h:27-62):
starting from a (random) cell, hop to the neighbor opposite the
most-negative barycentric coordinate until the point is contained; -1
after too many hops (non-convex domains can trap the walk; the grid
locator in point_location.py is the robust default).
"""

from __future__ import annotations

import numpy as np

from .affine import affine_maps_np

__all__ = ["walk_search"]


def walk_search(mesh, points: np.ndarray, start: int | None = None,
                max_hops: int | None = None) -> np.ndarray:
    """All points walk at once: each hop is one batched barycentric
    evaluation over the still-active points. The reference's visited-set
    cycle guard becomes a no-backtrack rule (forbids the immediate
    2-cycle) plus the hop cap."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    _, invJ, _ = affine_maps_np(mesh.nodes, mesh.cells)
    v0 = mesh.nodes[mesh.cells[:, 0]]
    neighbors = mesh.neighbors
    if max_hops is None:
        max_hops = 4 * int(np.sqrt(mesh.n_cells)) + 50
    rng = np.random.default_rng(0)
    npts = points.shape[0]
    eps = 10 * np.finfo(np.float64).eps

    c = (np.full(npts, start, dtype=np.int64) if start is not None
         else rng.integers(0, mesh.n_cells, size=npts))
    prev = np.full(npts, -1, dtype=np.int64)
    out = np.full(npts, -1, dtype=np.int32)
    active = np.ones(npts, dtype=bool)
    for _ in range(max_hops):
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        ca = c[idx]
        z = np.einsum("kmn,kn->km", invJ[ca], points[idx] - v0[ca])
        bary = np.concatenate([1.0 - z.sum(axis=1, keepdims=True), z], axis=1)
        j = np.argmin(bary, axis=1)
        rows = np.arange(idx.size)
        contained = bary[rows, j] >= -eps
        out[idx[contained]] = ca[contained]
        # hop across the facet opposite the most negative coordinate:
        # neighbors[c, v] is the cell opposite vertex v (walk_search.h:44-52)
        nxt = neighbors[ca, j]
        back = (nxt == prev[idx]) & ~contained
        if back.any():  # avoid 2-cycles: take the next-most-negative facet
            bary2 = bary.copy()
            bary2[rows, j] = np.inf
            j2 = np.argmin(bary2, axis=1)
            nxt = np.where(back, neighbors[ca, j2], nxt)
        dead = (nxt < 0) & ~contained
        stop = contained | dead
        prev[idx] = np.where(stop, prev[idx], ca)
        c[idx] = np.where(stop, ca, nxt)
        active[idx[stop]] = False
    return out
