"""Simplicial triangulations of dimension M embedded in R^N.

Host-only NumPy copy of ``fdapde_core_tpu/geometry/triangulation.py``
(counterpart of fdaPDE-core's `fdaPDE/geometry/triangulation.h`). Supported
(M, N): (2,2), (2,3) manifold, (3,3), and 1D cells. All topology (edges,
faces, neighbors, boundary markers) is derived vectorized on the host;
geometric per-cell maps live in `affine.py` (torch, and a NumPy twin).

Sub-simplex numbering takes the native C++ hash pass
(`native/topology.cpp`, built with g++ at first use) wherever a g++ is on
PATH, as the JAX package does, and the NumPy sort otherwise; both give the
same ids. Point location (`locate` on the host, `locate_device` in torch)
is `geometry/point_location.py`. The constructor is the span `build.mesh`
(`utils.profiling`); the topology it derives lazily is not in it.

Numbering parity with the reference (required so P2 degrees of freedom and
golden matrices match bit-for-bit):

- sub-simplices (edges/faces) are numbered in *first-encounter order* while
  scanning cells in row order and, inside a cell, local sub-simplices in the
  lexicographic order of `combinations(k, M+1)` — exactly the iteration order
  of the reference's hash-map extraction (triangulation.h:150-196),
- `neighbors[c, v]` is the cell adjacent to `c` across the facet opposite to
  local vertex `v`, -1 if none (triangulation.h:56-57,184-185),
- a facet is on the boundary iff it is shared by exactly one cell.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..utils.combinatorics import combinations
from ..utils.profiling import span

__all__ = ["Triangulation", "first_encounter_unique", "first_encounter_unique_numpy"]


def first_encounter_unique(keys: np.ndarray):
    """Unique rows of `keys` in first-encounter order.

    Returns (unique_rows, ids) with ids[r] the id of row r; ids are assigned
    0,1,2,... in order of first appearance (matching the reference's
    sequential hash-map numbering, triangulation.h:167-191).

    Uses the native C++ hash pass (O(n)) when a g++ can build it, as the JAX
    package does; the sort-based NumPy pass (O(n log n)) otherwise. A failed
    native build raises.
    """
    from ..native import first_encounter_unique_native, native_available

    if native_available():
        return first_encounter_unique_native(np.ascontiguousarray(keys, np.int32))
    return first_encounter_unique_numpy(keys)


def first_encounter_unique_numpy(keys: np.ndarray):
    """The sort-based NumPy form of ``first_encounter_unique``: the same ids."""
    _, first_idx, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    inverse = inverse.reshape(-1)  # numpy>=2 returns original-shaped inverse
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    ids = rank[inverse]
    return keys[np.sort(first_idx)], ids.astype(np.int32)


class Triangulation:
    """An M-dimensional simplicial mesh embedded in R^N."""

    def __init__(
        self,
        nodes: np.ndarray,
        cells: np.ndarray,
        boundary: np.ndarray | None = None,
    ):
        with span("build.mesh"):
            nodes = np.asarray(nodes, dtype=np.float64)
            if nodes.ndim == 1:
                nodes = nodes[:, None]
            cells = np.asarray(cells, dtype=np.int32)
            self.nodes = nodes
            self.cells = cells
            self.local_dim = cells.shape[1] - 1
            self.embed_dim = nodes.shape[1]
            self.n_nodes = nodes.shape[0]
            self.n_cells = cells.shape[0]
            if boundary is not None:
                self.boundary_nodes = np.asarray(boundary).reshape(-1).astype(bool)
            else:
                self.boundary_nodes = None  # derived lazily from boundary facets
            # mesh bounding box (triangulation.h:54-55)
            self.range = np.stack([nodes.min(axis=0), nodes.max(axis=0)])

    # -- topology ------------------------------------------------------------
    @property
    def is_manifold(self) -> bool:
        return self.local_dim != self.embed_dim

    @cached_property
    def _facet_data(self):
        """(facets, cell_to_facets, facet_to_cells, boundary_facets)."""
        return self._extract(self.local_dim - 1)

    @cached_property
    def _edge_data(self):
        """(edges, cell_to_edges, edge_to_cells, boundary_edges)."""
        if self.local_dim == 2:
            return self._facet_data  # in 2D facets ARE edges
        return self._extract(1)

    def _extract(self, k: int):
        """Extract all k-subsimplices with first-encounter numbering."""
        pattern = combinations(k + 1, self.local_dim + 1)  # (P, k+1) lex order
        sub = self.cells[:, pattern]  # (C, P, k+1)
        P = pattern.shape[0]
        keys = np.sort(sub.reshape(self.n_cells * P, k + 1), axis=1)
        uniq, ids = first_encounter_unique(keys)
        cell_to_sub = ids.reshape(self.n_cells, P)
        n_sub = uniq.shape[0]
        counts = np.bincount(ids, minlength=n_sub)
        # adjacency in encounter order: for each sub-simplex, the cells that
        # contain it, ordered by encounter (CSR layout).
        occ_order = np.argsort(ids, kind="stable")
        occ_cells = (occ_order // P).astype(np.int32)
        offsets = np.zeros(n_sub + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        sub_to_cells = (occ_cells, offsets)
        if k == self.local_dim - 1:
            boundary = counts == 1
        else:
            boundary = None  # meaningful only via facets (set below for edges in 3D)
        return uniq, cell_to_sub, sub_to_cells, boundary

    @property
    def facets(self) -> np.ndarray:
        return self._facet_data[0]

    @property
    def cell_to_facets(self) -> np.ndarray:
        return self._facet_data[1]

    @property
    def boundary_facets(self) -> np.ndarray:
        return self._facet_data[3]

    @property
    def n_facets(self) -> int:
        return self.facets.shape[0]

    @property
    def edges(self) -> np.ndarray:
        return self._edge_data[0]

    @property
    def cell_to_edges(self) -> np.ndarray:
        return self._edge_data[1]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    def edge_adjacent_cells(self, split: bool = False):
        """CSR adjacency (cells, offsets): cells containing each edge."""
        return self._edge_data[2]

    @cached_property
    def boundary_edges(self) -> np.ndarray:
        """Boolean marker per edge (true iff edge lies on the boundary).

        In 2D edges are facets; in 3D an edge is on the boundary iff it
        belongs to some boundary face (triangulation.h:319-399 semantics).
        """
        if self.local_dim == 1:
            # 1D "edges" are the cells themselves; their midpoint dofs are
            # always interior
            return np.zeros(self.n_edges, dtype=bool)
        if self.local_dim == 2:
            return self._facet_data[3]
        # 3D: mark edges of boundary faces (vectorized pair lookup — the
        # former per-face Python dict loop was O(n_faces) interpreter work)
        faces, cell_to_faces, (occ_cells, offsets), bfaces = self._facet_data
        bf = faces[np.nonzero(bfaces)[0]]
        marker = np.zeros(self.n_edges, dtype=bool)
        for a, b in combinations(2, 3):
            marker[self._edge_ids_of_pairs(bf[:, a], bf[:, b])] = True
        return marker

    @cached_property
    def _sorted_edge_keys(self):
        """Sorted encoded (u < v) edge keys + permutation to edge ids —
        backs all vectorized node-pair -> edge-id lookups."""
        keys = self.edges[:, 0].astype(np.int64) * self.n_nodes + self.edges[:, 1]
        order = np.argsort(keys)
        return keys[order], order

    def _edge_ids_of_pairs(self, a, b) -> np.ndarray:
        """Edge ids of node pairs (a[i], b[i]) in any order (must exist)."""
        lo = np.minimum(a, b).astype(np.int64)
        hi = np.maximum(a, b).astype(np.int64)
        skeys, order = self._sorted_edge_keys
        return order[np.searchsorted(skeys, lo * self.n_nodes + hi)]

    @cached_property
    def neighbors(self) -> np.ndarray:
        """neighbors[c, v]: cell sharing the facet opposite to vertex v."""
        M = self.local_dim
        _, cell_to_facets, (occ_cells, offsets), _ = self._facet_data
        n_fac = offsets.size - 1
        first = occ_cells[offsets[:-1]]
        # second adjacent cell, or -1
        second = np.full(n_fac, -1, dtype=np.int32)
        has2 = (offsets[1:] - offsets[:-1]) >= 2
        second[has2] = occ_cells[offsets[:-1][has2] + 1]
        neigh = np.full((self.n_cells, M + 1), -1, dtype=np.int32)
        P = cell_to_facets.shape[1]
        for j in range(P):
            f = cell_to_facets[:, j]
            other = np.where(
                first[f] == np.arange(self.n_cells), second[f], first[f]
            )
            # local facet j (lex order) is opposite to local vertex M - j
            neigh[:, M - j] = other
        return neigh

    @cached_property
    def derived_boundary_nodes(self) -> np.ndarray:
        """Boundary-node markers derived from boundary facets."""
        marker = np.zeros(self.n_nodes, dtype=bool)
        bf = self.facets[self.boundary_facets]
        marker[bf.reshape(-1)] = True
        return marker

    def boundary_node_markers(self) -> np.ndarray:
        if self.boundary_nodes is not None:
            return self.boundary_nodes
        return self.derived_boundary_nodes

    @property
    def n_boundary_nodes(self) -> int:
        return int(self.boundary_node_markers().sum())

    # -- geometry ------------------------------------------------------------
    @cached_property
    def cell_coords(self) -> np.ndarray:
        """Coordinates of cell vertices, shape (C, M+1, N)."""
        return self.nodes[self.cells]

    @cached_property
    def cell_barycenters(self) -> np.ndarray:
        return self.cell_coords.mean(axis=1)

    @cached_property
    def measures(self) -> np.ndarray:
        """Cell measures (|det J| / M!, or Gram-determinant form on manifolds;
        simplex.h:184-195)."""
        from .affine import affine_maps_np

        return affine_maps_np(self.nodes, self.cells)[2]

    def measure(self) -> float:
        return float(self.measures.sum())

    # -- point location ------------------------------------------------------
    def locate(self, points: np.ndarray) -> np.ndarray:
        """Cell id containing each point (-1 if outside the mesh).

        Replaces the reference's ADT tree search (tree_search.h:28-84) with a
        uniform-grid candidate search + exact barycentric `contains` test
        (simplex.h:115-127), a vectorization-friendly equivalent.
        """
        from .point_location import CellLocator

        if not hasattr(self, "_locator"):
            self._locator = CellLocator(self)
        return self._locator.locate(np.asarray(points, dtype=np.float64))

    def locate_device(self, points, device=None):
        """Point location for large query batches on a device
        (geometry/point_location.DeviceCellLocator, the same ids as
        `locate`). The device is that of `points` when they are a tensor,
        else `device` ("cuda" when None); returns an int32 tensor there."""
        from .point_location import DeviceCellLocator

        if isinstance(points, torch.Tensor):
            device = points.device
        device = torch.device("cuda" if device is None else device)
        cache = self.__dict__.setdefault("_device_locators", {})
        if str(device) not in cache:
            cache[str(device)] = DeviceCellLocator(self, device=device)
        return cache[str(device)].locate(points)

    def node_patch(self, node_id: int) -> np.ndarray:
        """Ids of cells having `node_id` as a vertex (triangulation.h:257-260)."""
        return np.nonzero((self.cells == node_id).any(axis=1))[0]

    def surface(self) -> "Triangulation":
        """Boundary surface of a 3D mesh as a 2.5D triangulation.

        Counterpart of Triangulation<3,3>::surface (triangulation.h:447-471):
        boundary faces become cells of a Triangulation<2,3>, with nodes
        renumbered compactly. Returns the surface mesh; its `parent_nodes`
        attribute maps surface node ids back to volume node ids.
        """
        assert self.local_dim == 3 and self.embed_dim == 3
        bf = self.facets[self.boundary_facets]  # (k, 3) volume node ids
        used = np.unique(bf.reshape(-1))
        remap = np.full(self.n_nodes, -1, dtype=np.int64)
        remap[used] = np.arange(used.size)
        surf = Triangulation(self.nodes[used], remap[bf].astype(np.int32))
        surf.parent_nodes = used
        return surf

    def face_to_edges(self) -> np.ndarray:
        """For each facet of a 3D mesh, the ids of its 3 edges
        (triangulation.h face_to_edges_)."""
        assert self.local_dim == 3
        faces = self.facets
        return np.stack(
            [
                self._edge_ids_of_pairs(faces[:, a], faces[:, b])
                for a, b in [(0, 1), (0, 2), (1, 2)]
            ],
            axis=1,
        ).astype(np.int64)

    # -- misc ----------------------------------------------------------------
    def __repr__(self):
        return (
            f"Triangulation<{self.local_dim},{self.embed_dim}>("
            f"{self.n_nodes} nodes, {self.n_cells} cells)"
        )
