"""Distributed banded-split solve: row-sharded BandedMG-CG.

Port of ``fdapde_core_tpu/parallel/banded.py``. ``BandedMGPreconditioner``
embeds the (R, W) banded grid into a square (m, m) grid with identity
padding, and the embedded operator is the Dirichlet-folded banded operator
plus decoupled identity rows; ``ShardedGridMG`` on that embedded
GridDIAMatrix is therefore the distributed banded solve (halo CG on the
banded product, the BandedMG hierarchy row-split over the shards).

The ELL remainder of a split is row-arbitrary gather work, so the solver
needs a remainder-free split (rem_nnz == 0, true of every banded-accepted
operator measured, ``gen10m`` included); a live remainder raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.dia_split import BandedSplit
from ..ops.grid_dia import GridDIAMatrix
from .mg import ShardedGridMG

__all__ = ["ShardedBandedMGSolver"]


class ShardedBandedMGSolver:
    """MG-preconditioned halo-CG for a Dirichlet-folded, remainder-free
    BandedSplit (``split.fold_dirichlet(mask).drop_empty_remainder()``)
    over a 1D ShardMesh."""

    def __init__(self, F_split: BandedSplit, device_mesh, repl_rows: int = 256,
                 coarse_n: int = 32, omega: float = 0.8, nu: int = 2, coarse_iters: int = 64):
        if F_split.rem is not None:
            raise ValueError("ShardedBandedMGSolver needs a remainder-free split (rem_nnz == 0 + "
                             "drop_empty_remainder()); live-remainder splits stay on the "
                             "halo-ELL path (parallel/halo_ell.py)")
        if any(abs(a) > 1 or abs(b) > 1 for a, b in F_split.G.offsets2d):
            raise ValueError("9-point window required (|a|, |b| <= 1); wider splits have no "
                             "Galerkin chain")
        R, W = F_split.G.shape2d
        self.n = F_split.n
        self.shape2d = (R, W)
        m0 = max(R, W)
        self.m = m = m0 + ((-(m0 - 1)) % 8)
        k0 = F_split.G.offsets2d.index((0, 0))
        src = torch.as_tensor(F_split.G.data, device=device_mesh.device)
        data = F.pad(src, (0, m - W, 0, m - R))
        ii = torch.arange(m, device=src.device)
        padmask = (ii[:, None] >= R) | (ii[None, :] >= W)
        data[k0] = torch.where(padmask, 1.0, data[k0])
        self.inner = ShardedGridMG(GridDIAMatrix(data, F_split.G.offsets2d, (m, m)), device_mesh,
                                   repl_rows=repl_rows, coarse_n=coarse_n, omega=omega, nu=nu,
                                   coarse_iters=coarse_iters)

    def solve(self, b, rtol: float = 1e-8, maxiter: int = 60):
        """b: (n,) reduced rhs (Dirichlet dofs pinned to their values).
        Returns (x (n,) on every rank, relative residual estimate,
        iterations); the identity padding rows carry b = 0 -> x = 0."""
        R, W = self.shape2d
        m = self.m
        b = torch.as_tensor(b, device=self.inner.device_mesh.device)
        bp = F.pad(b, (0, R * W - self.n)).reshape(R, W)
        bsq = F.pad(bp, (0, m - W, 0, m - R)).reshape(-1)
        x, rel, k = self.inner.solve(bsq, rtol=rtol, maxiter=maxiter)
        return x.reshape(m, m)[:R, :W].reshape(-1)[: self.n], rel, k
