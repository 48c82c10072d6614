"""Row-sharded halo CG over 2D-grid stencil (GridDIA) operators.

Port of ``fdapde_core_tpu/parallel/halo_grid.py``, the distributed
counterpart of ``ops/grid_cg.py``: the (mx, my) dof grid is split into
contiguous row blocks, one per shard; a stencil product needs the
neighbours' edge rows (halo height max |di|, typically 1), column shifts
stay local. Dirichlet handling uses the pre-masked operator
(``GridDIAMatrix.with_dirichlet``), so the CG body is the stencil, axpys
and psum'd dot products. The stencils are plain torch, as the port's
``ops/grid_cg.py`` computes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cg import sharded_cg
from .comm import ShardMesh
from .halo import _inv_diag

__all__ = ["HaloGridDIASolver"]


class HaloGridDIASolver:
    """Distributed Jacobi-CG for a (pre-masked) GridDIAMatrix."""

    def __init__(self, G, free_flat, device_mesh: ShardMesh):
        self.offsets2d = tuple(G.offsets2d)
        self.H = max(abs(di) for di, _ in self.offsets2d)
        self.Hc = max(abs(dj) for _, dj in self.offsets2d)
        self.device_mesh = device_mesh
        self.nshards = device_mesh.size
        self.mx, self.my = mx, my = G.shape2d
        self.rows_block = Rb = -(-mx // self.nshards)
        self.mx_pad = Rb * self.nshards
        if self.H > Rb:
            raise ValueError("halo rows exceed the row block")
        dev = device_mesh.device
        data = torch.as_tensor(G.data, device=dev)
        free = torch.as_tensor(free_flat, device=dev).to(data.dtype)
        Gm = type(G)(data, G.offsets2d, G.shape2d).with_dirichlet(free)
        start = device_mesh.rank * Rb
        loc = Gm.data[:, start:start + Rb]
        self.data = F.pad(loc, (0, 0, 0, Rb - loc.shape[1]))
        freeg = free.reshape(mx, my)[start:start + Rb]
        self.free = F.pad(freeg, (0, 0, 0, Rb - freeg.shape[0]))
        self.inv_diag = _inv_diag(self.data[self.offsets2d.index((0, 0))], self.free)
        self.dtype = data.dtype

    def _Ax(self, x):
        """Halo rows exchanged, halo columns zero-padded, stencil summed."""
        H, Hc, Rb, my = self.H, self.Hc, self.rows_block, self.my
        ext = F.pad(self.device_mesh.halo_extend(x, H), (Hc, Hc))
        y = torch.zeros_like(x)
        for k, (di, dj) in enumerate(self.offsets2d):
            y = y + self.data[k] * ext[H + di:H + di + Rb, Hc + dj:Hc + dj + my]
        return y + x * (1 - self.free)

    def solve(self, b_reduced, rtol=1e-10, maxiter=2000):
        """b_reduced: (n,) rhs with the boundary data moved to it
        (``DirichletSystem.rhs``). Returns (x (n,) on every rank, ||r||,
        iterations)."""
        b = torch.as_tensor(b_reduced, device=self.device_mesh.device).to(self.dtype)
        start = self.device_mesh.rank * self.rows_block
        loc = b.reshape(self.mx, self.my)[start:start + self.rows_block]
        b = F.pad(loc, (0, 0, 0, self.rows_block - loc.shape[0]))
        inv_diag = self.inv_diag
        x, rr, k, _ = sharded_cg(self._Ax, lambda r: inv_diag * r, b, self.device_mesh, rtol,
                                 maxiter)
        x = self.device_mesh.all_gather(x)[: self.mx]
        return x.reshape(-1), torch.sqrt(rr), k
