"""1D interval meshes (Triangulation<1,1>).

Host-only NumPy copy of ``fdapde_core_tpu/geometry/interval.py``
(counterpart of fdaPDE-core's fdaPDE/geometry/interval.h): a sorted set of
nodes on the real line, cells are the consecutive segments, boundary is the
two endpoints, O(log n) locate via binary search.
"""

from __future__ import annotations

import numpy as np

from .triangulation import Triangulation

__all__ = ["Interval"]


class Interval(Triangulation):
    """Mesh of the interval [a, b].

    `Interval(nodes)` from an explicit sorted node vector, or
    `Interval(a, b, n)` splitting [a, b] into n equal sub-intervals
    (interval.h:39-65).
    """

    def __init__(self, *args):
        if len(args) == 3:
            a, b, n = args
            nodes = np.linspace(float(a), float(b), int(n) + 1)
        elif len(args) == 1:
            nodes = np.asarray(args[0], dtype=np.float64).reshape(-1)
        else:
            raise TypeError("Interval(nodes) or Interval(a, b, n)")
        n_nodes = nodes.size
        cells = np.stack(
            [np.arange(n_nodes - 1), np.arange(1, n_nodes)], axis=1
        ).astype(np.int32)
        boundary = np.zeros(n_nodes, dtype=bool)
        boundary[0] = boundary[-1] = True
        super().__init__(nodes[:, None], cells, boundary)

    def locate(self, points: np.ndarray) -> np.ndarray:
        """Cell containing each point via binary search (interval.h:98-126)."""
        p = np.asarray(points, dtype=np.float64).reshape(-1)
        x = self.nodes[:, 0]
        idx = np.searchsorted(x, p, side="right") - 1
        idx = np.clip(idx, 0, self.n_cells - 1)
        outside = (p < x[0]) | (p > x[-1])
        return np.where(outside, -1, idx).astype(np.int32)
