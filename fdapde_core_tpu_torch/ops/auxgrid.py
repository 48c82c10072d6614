"""Auxiliary structured-grid preconditioner for unstructured 2D meshes.

Port of ``fdapde_core_tpu/ops/auxgrid.py`` ``AuxGridPreconditioner``
(the auxiliary-space method, Xu 1996):

    B r = omega * D^{-1} r  +  P  G^{-1}  P^T r

P is the bilinear interpolation from a uniform (m, m) grid over the mesh's
bounding box (4 weights per mesh node), G^{-1} one V-cycle of the grid
stencil multigrid (``ops/grid_mg.GridMG``, 5-point Laplacian with an
identity boundary ring). B is SPD, so it preconditions CG.

P^T r, which JAX forms with ``segment_sum``, is a product with P^T stored
as an (m^2, n) sliced ELL on K2 (``ops/gather_spmv.SlicedELL``): each grid
node's contributions are summed by one thread in increasing position of
the flattened (4, n) table, the order ``segment_sum`` adds them in on the
CPU, with no atomics, so the apply is bitwise the same from run to run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .gather_spmv import SlicedELL
from .grid_dia import GridDIAMatrix
from .grid_mg import GridMG

__all__ = ["AuxGridPreconditioner"]

_OFFS5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def _grid_stencil(free):
    """5-point layers (_OFFS5 order) over the (m, m) free-node mask:
    4 / -1 on free nodes, identity rows elsewhere."""
    m = free.shape[0]
    freep = torch.nn.functional.pad(free, (1, 1, 1, 1))
    layers = [torch.where(free > 0, 4.0, 1.0).to(free.dtype)]
    for di, dj in _OFFS5[1:]:
        layers.append(-1.0 * free * freep[1 + di:1 + di + m, 1 + dj:1 + dj + m])
    return GridDIAMatrix(torch.stack(layers), _OFFS5, (m, m))


def _restriction(idx, w, m):
    """P^T as an (m^2, n) SlicedELL on idx's device: the entries of the
    (4, n) table ordered by grid node, each node's in increasing flattened
    position (a stable sort of the ids)."""
    n = idx.shape[1]
    order = torch.sort(idx.reshape(-1), stable=True)
    return SlicedELL.from_coo(order.values, order.indices % n, w.reshape(-1)[order.indices],
                              (m * m, n))


class AuxGridPreconditioner:
    """z = omega * dinv * r + P V(P^T r).

    idx: (4, n) int32 grid node ids; w: (4, n) bilinear weights; dinv: (n,)
    inverse diagonal of the mesh operator; mg: GridMG over the grid
    stencil; n_grid: grid cells per side (m = n_grid + 1 nodes); PT: P^T
    as a SlicedELL, built from idx and w.
    """

    def __init__(self, idx, w, dinv, mg, omega, n_grid):
        self.idx = idx
        self.w = w
        self.dinv = dinv
        self.mg = mg
        self.omega = omega
        self.n_grid = n_grid
        self.PT = _restriction(idx, w, n_grid + 1)

    @classmethod
    def build(cls, nodes, diag, grid_n: int | None = None, bbox=None,
              grid_free=None, omega: float = 0.5, coarse_n: int = 32,
              mg_nu: int = 2, dtype=None, device="cuda"):
        """Host setup (numpy) for (n, 2) node coordinates and the (n,)
        diagonal of the masked mesh operator. grid_n defaults to ~sqrt(n),
        rounded to even; bbox to the nodes' bounding box; grid_free (an
        (m, m) bool array, or "auto" for the grid nodes around occupied
        cells) to the interior of the box. dtype defaults to diag's."""
        nodes = np.asarray(nodes, dtype=np.float64)
        n = nodes.shape[0]
        if dtype is None:
            dtype = diag.dtype if isinstance(diag, torch.Tensor) else torch.float64
        if bbox is None:
            lo, hi = nodes.min(axis=0), nodes.max(axis=0)
        else:
            lo, hi = np.asarray(bbox[0], float), np.asarray(bbox[1], float)
        if grid_n is None:
            grid_n = int(2 * round(math.sqrt(n) / 2))
        m = grid_n + 1
        span = np.where(hi > lo, hi - lo, 1.0)
        u = (nodes - lo) / span * grid_n  # grid coordinates
        cell = np.clip(np.floor(u).astype(np.int64), 0, grid_n - 1)
        frac = u - cell
        i0, j0 = cell[:, 0], cell[:, 1]
        fx, fy = frac[:, 0], frac[:, 1]
        idx = np.stack([i0 * m + j0, (i0 + 1) * m + j0,
                        i0 * m + (j0 + 1), (i0 + 1) * m + (j0 + 1)]).astype(np.int32)
        w = np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy])

        if isinstance(grid_free, str) and grid_free == "auto":
            # free: box-interior grid nodes of cells that hold mesh nodes,
            # so the void outside a non-box domain gets identity rows
            occ = np.zeros((grid_n, grid_n), dtype=bool)
            occ[i0, j0] = True
            node_free = np.zeros((m, m), dtype=bool)
            node_free[:-1, :-1] |= occ
            node_free[1:, :-1] |= occ
            node_free[:-1, 1:] |= occ
            node_free[1:, 1:] |= occ
            node_free[[0, -1], :] = False
            node_free[:, [0, -1]] = False
            grid_free = node_free
        elif grid_free is None:
            interior1d = np.zeros(m, dtype=bool)
            interior1d[1:-1] = True
            grid_free = interior1d[:, None] & interior1d[None, :]
        free = torch.as_tensor(np.asarray(grid_free, dtype=np.float64), device=device).to(dtype)
        mg = GridMG.build(_grid_stencil(free), coarse_n=min(coarse_n, max(2, grid_n // 4)),
                          nu=mg_nu)

        d = np.asarray(torch.as_tensor(diag).cpu(), dtype=np.float64)
        dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        return cls(torch.as_tensor(idx, device=device),
                   torch.as_tensor(w, device=device).to(dtype),
                   torch.as_tensor(dinv, device=device).to(dtype), mg, omega, grid_n)

    @classmethod
    def build_device(cls, nodes, diag, grid_n: int | None = None,
                     bbox=((0.0, 0.0), (1.0, 1.0)), omega: float = 0.5,
                     coarse_n: int = 32, mg_nu: int = 2, dtype=torch.float32):
        """Setup on diag's device for a box domain (free grid nodes: the
        interior of the static ``bbox``). nodes: (n, 2) tensor or an (x, y)
        tuple of (n,) coordinate tensors. Nodes outside the box are clamped
        to the nearest cell with weights in [0, 1]."""
        soa = isinstance(nodes, (tuple, list))
        xs = nodes[0] if soa else nodes[:, 0]
        ys = nodes[1] if soa else nodes[:, 1]
        n = xs.shape[0]
        if grid_n is None:
            grid_n = int(2 * round(math.sqrt(n) / 2))
        m = grid_n + 1
        lo = tuple(float(v) for v in bbox[0])
        hi = tuple(float(v) for v in bbox[1])
        span = tuple(h - l if h > l else 1.0 for l, h in zip(lo, hi))

        u0 = (xs.to(dtype) - lo[0]) / span[0] * grid_n
        u1 = (ys.to(dtype) - lo[1]) / span[1] * grid_n
        i0 = torch.clamp(torch.floor(u0).to(torch.int32), 0, grid_n - 1)
        j0 = torch.clamp(torch.floor(u1).to(torch.int32), 0, grid_n - 1)
        fx = torch.clamp(u0 - i0.to(dtype), 0.0, 1.0)
        fy = torch.clamp(u1 - j0.to(dtype), 0.0, 1.0)
        idx = torch.stack([i0 * m + j0, (i0 + 1) * m + j0,
                           i0 * m + (j0 + 1), (i0 + 1) * m + (j0 + 1)])
        w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy])
        gid = torch.arange(m, device=xs.device)
        int1d = (gid > 0) & (gid < grid_n)
        free = (int1d[:, None] & int1d[None, :]).to(dtype)
        d = diag.to(dtype)
        dinv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)
        mg = GridMG.build(_grid_stencil(free), coarse_n=min(coarse_n, max(2, grid_n // 4)),
                          nu=mg_nu)
        return cls(idx, w, dinv, mg, omega, grid_n)

    def __call__(self, r):
        rc = self.PT @ r  # P^T r: the 4 bilinear weights per node onto the grid
        z_g = self.mg.v_cycle(rc)
        # P z_g: gather back
        z = (z_g[self.idx] * self.w).sum(dim=0)
        return self.omega * self.dinv * r + z
