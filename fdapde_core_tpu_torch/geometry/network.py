"""1.5D linear networks (Triangulation<1,2>): graph meshes embedded in R^2.

Host-only NumPy copy of ``fdapde_core_tpu/geometry/network.py``
(counterpart of fdaPDE-core's fdaPDE/geometry/linear_network.h): cells are
segments, a node may belong to arbitrarily many cells, neighbor structure
is the variable-degree cell adjacency through shared nodes. A ``PDE`` over
a network assembles its segments on the host tables and solves on its
``device``, as over any other mesh.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from .triangulation import Triangulation

__all__ = ["LinearNetwork"]


class LinearNetwork(Triangulation):
    """A network of segments in R^2 (local_dim=1, embed_dim=2)."""

    def __init__(self, nodes, cells, boundary=None):
        super().__init__(np.asarray(nodes, np.float64), cells, boundary)
        assert self.local_dim == 1 and self.embed_dim == 2

    @cached_property
    def node_to_cells(self):
        """CSR adjacency (cells, offsets): cells insisting on each node
        (linear_network.h:28-56)."""
        flat = self.cells.reshape(-1)
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=self.n_nodes)
        offsets = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return (order // 2).astype(np.int32), offsets

    def cell_neighbors(self, cell_id: int) -> np.ndarray:
        """Cells sharing a node with `cell_id` (variable-degree adjacency)."""
        cells_adj, offsets = self.node_to_cells
        out = [cells_adj[offsets[v]:offsets[v + 1]] for v in self.cells[cell_id]]
        out = np.unique(np.concatenate(out))
        return out[out != cell_id]

    @cached_property
    def derived_boundary_nodes(self) -> np.ndarray:
        """A network node is on the boundary iff it belongs to exactly one cell."""
        counts = np.bincount(self.cells.reshape(-1), minlength=self.n_nodes)
        return counts == 1
