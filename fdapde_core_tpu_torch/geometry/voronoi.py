"""Voronoi tessellation as the dual of a 2D Delaunay triangulation.

Host-only NumPy copy of ``fdapde_core_tpu/geometry/voronoi.py``
(counterpart of fdaPDE-core's fdaPDE/geometry/voronoi.h): each mesh node is
a site; its Voronoi cell is the polygon of circumcenters of incident
triangles, augmented on the boundary with edge midpoints and the site
itself (voronoi.h:34-121). `locate` maps a point to the nearest site
(voronoi.h:173-180).
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from .kd_tree import KDTree

__all__ = ["Voronoi"]


def _circumcenter(a, b, c):
    """Circumcenter of 2D triangle (simplex.h:88-99)."""
    M = np.stack([b - a, c - a])
    rhs = 0.5 * np.array([(b - a) @ (b + a - 2 * a), (c - a) @ (c + a - 2 * a)])
    # solve M x = rhs relative to a
    return a + np.linalg.solve(M, rhs)


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull vertices counterclockwise."""
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) <= 2:
        return pts

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and (
                (out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])
            ) <= 1e-18:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


class VoronoiCell:
    def __init__(self, site, vertices, vertex_on_boundary=None):
        self.site = site
        self.vertices = vertices  # (k, 2) counterclockwise
        # which polygon vertices come from the boundary closure (edge
        # midpoints / the site itself) — the reference's nodes_markers_
        # (voronoi.h:112-120)
        self.vertex_on_boundary = (
            np.zeros(len(vertices), dtype=bool)
            if vertex_on_boundary is None
            else vertex_on_boundary
        )

    @property
    def n_edges(self) -> int:
        return self.vertices.shape[0]

    def edges(self) -> np.ndarray:
        """(n_edges, 2) local vertex-index pairs of consecutive polygon
        vertices, wrap-around — VoronoiCell::edges() (voronoi.h:87-95)."""
        k = self.n_edges
        j = np.arange(k)
        return np.stack([j, (j + 1) % k], axis=1)

    def edge(self, i: int) -> np.ndarray:
        """(2, 2) coordinates of the i-th cell edge (voronoi.h:106-111)."""
        k = self.n_edges
        return self.vertices[[i % k, (i + 1) % k]]

    @property
    def on_boundary(self) -> bool:
        """True iff some edge lies on the domain boundary: both endpoints
        are boundary-closure vertices (voronoi.h:112-120)."""
        m = self.vertex_on_boundary
        return bool((m & np.roll(m, -1)).any())

    @property
    def measure(self) -> float:
        """Polygon area (shoelace — voronoi.h:96-105)."""
        v = self.vertices
        x, y = v[:, 0], v[:, 1]
        return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    def contains(self, p) -> bool:
        """Point-in-convex-polygon test (equivalent to the reference's
        nearest-site definition, voronoi.h:121)."""
        v = self.vertices
        n = v.shape[0]
        eps = 1e-12
        for i in range(n):
            a, b = v[i], v[(i + 1) % n]
            cross = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
            if cross < -eps:
                return False
        return True


class Voronoi:
    """Voronoi dual of a Triangulation<2,2>."""

    def __init__(self, mesh):
        assert mesh.local_dim == 2 and mesh.embed_dim == 2
        self.mesh = mesh
        self.n_cells = mesh.n_nodes  # one Voronoi cell per mesh node

    @cached_property
    def circumcenters(self) -> np.ndarray:
        coords = self.mesh.cell_coords
        out = np.empty((self.mesh.n_cells, 2))
        for c in range(self.mesh.n_cells):
            out[c] = _circumcenter(*coords[c])
        return out

    def cell(self, node_id: int) -> VoronoiCell:
        mesh = self.mesh
        site = mesh.nodes[node_id]
        patch = mesh.node_patch(node_id)
        verts = [self.circumcenters[c] for c in patch]
        closure = []  # boundary-closure vertices (reference nodes_markers_)
        if mesh.boundary_node_markers()[node_id]:
            # add midpoints of incident boundary edges + the site itself
            # (voronoi.h boundary closure)
            edges = mesh.edges
            bmask = mesh.boundary_edges
            incident = np.nonzero(bmask & (edges == node_id).any(axis=1))[0]
            for e in incident:
                a, b = edges[e]
                closure.append(0.5 * (mesh.nodes[a] + mesh.nodes[b]))
            closure.append(site)
            verts.extend(closure)
        verts = np.asarray(verts, dtype=np.float64)
        # dedupe with tolerance, then order as the convex hull (Voronoi cells
        # of a Delaunay dual are convex; the reference sorts clockwise around
        # the site, voronoi.h clockwise_order — hull ordering is equivalent
        # and robust when the site lies on the cell boundary)
        verts = np.unique(np.round(verts / 1e-12).astype(np.int64), axis=0) * 1e-12
        hull = _convex_hull(verts)
        if closure:
            cl = np.asarray(closure)
            d = np.linalg.norm(hull[:, None, :] - cl[None, :, :], axis=2)
            marker = (d < 1e-9).any(axis=1)
        else:
            marker = np.zeros(len(hull), dtype=bool)
        return VoronoiCell(site, hull, marker)

    def cells(self):
        return [self.cell(i) for i in range(self.n_cells)]

    @cached_property
    def _site_tree(self):
        return KDTree(self.mesh.nodes)

    def locate(self, points: np.ndarray) -> np.ndarray:
        """Voronoi cell (= nearest site) of each point; -1 outside the hull."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        in_mesh = self.mesh.locate(points)
        out = np.array(
            [self._site_tree.nn_search(p) for p in points], dtype=np.int32
        )
        out[in_mesh < 0] = -1
        return out

    def measure(self) -> float:
        return sum(c.measure for c in self.cells())
