"""Halo-exchange distributed CG over assembled ELL (general-mesh) operators.

Port of ``fdapde_core_tpu/parallel/halo_ell.py``. Dof rows are split into
contiguous blocks, one per shard. For a banded matrix (any FEM matrix
after RCM, ``parallel/reorder.py``) every nonzero of a row owned by shard
p lies within H = bandwidth of the row, so a product needs only the two
H-wide edge strips of the neighbouring blocks (``ShardMesh.halo``).
Columns are rebased to halo-local indices at set-up, so the local product
is K2's compact form on the shard's (K, block) table over the (block + 2H)
halo-extended vector, a rectangular ``ops/gather_spmv.ELLSoA``. The
halo-local columns move the padding column to local row + H, so where E
carries warp widths the shard's come from the global pattern's row widths,
cut to the shard's rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.gather_spmv import ELLSoA, ell_row_widths, warp_widths
from .cg import sharded_cg
from .comm import ShardMesh
from .halo import _inv_diag, _maybe_escalate

__all__ = ["HaloELLSolver"]


class HaloELLSolver:
    """Distributed Jacobi-CG for an ELLSoA operator over a 1D ShardMesh.

    E: ``ops/gather_spmv.ELLSoA`` (vals/cols (K, n); padded entries carry
    col = row, val = 0), banded with bandwidth H <= n/P: RCM-reorder
    imported meshes first. Dirichlet dofs are pinned by masking
    (free_mask), as in ``HaloDIASolver``.
    """

    def __init__(self, E, device_mesh: ShardMesh):
        self.device_mesh = device_mesh
        self.P = device_mesh.size
        dev = device_mesh.device
        vals = torch.as_tensor(E.vals, device=dev)
        cols = torch.as_tensor(E.cols, device=dev).long()
        self.K, self.n = K, n = vals.shape
        self.block = block = -(-n // self.P)
        self.n_pad = block * self.P
        rows = torch.arange(n, device=dev)
        self.H = H = max(int((cols - rows[None, :]).abs().max()) if n else 0, 1)
        if H > block:
            raise ValueError(f"bandwidth {H} exceeds block size {block}; RCM-reorder the dofs "
                             "(parallel/reorder.py) or use fewer devices")
        # this shard's rows; pad rows past n: identity convention (col = row,
        # val = 0)
        start = device_mesh.rank * block
        lrows = torch.arange(start, start + block, device=dev)
        v, c = vals[:, start:start + block], cols[:, start:start + block]
        self.vals = F.pad(v, (0, block - v.shape[1])).contiguous()
        c = torch.cat([c, lrows[v.shape[1]:].expand(K, -1)], dim=1)
        # halo-local columns in [0, block + 2H)
        self.lcols = torch.clamp(c - start + H, 0, block + 2 * H - 1).to(torch.int32).contiguous()
        # the global rows' widths where E's builder vouches for them (None:
        # all K slots); the pad rows past n hold only padding
        self.warp_w = None
        if E.warp_w is not None:
            row_w = ell_row_widths(cols)[start:start + block]
            self.warp_w = warp_widths(F.pad(row_w, (0, block - row_w.shape[0])))
        self.dtype = self._op().dtype
        self.diag = torch.where(c == lrows[None, :], self.vals, 0.0).sum(dim=0).to(self.dtype)

    def _op(self):
        """This shard's (block, block + 2H) operator over the halo-extended
        vector (built from the current tables: an escalation recasts vals)."""
        return ELLSoA(self.vals, self.lcols, (self.block, self.block + 2 * self.H), self.warp_w)

    def _pad_local(self, v):
        v = torch.as_tensor(v, device=self.device_mesh.device).to(self.dtype)
        start = self.device_mesh.rank * self.block
        loc = v[start:start + self.block]
        return F.pad(loc, (0, self.block - loc.shape[0]))

    def _spmv(self, x):
        """This shard's rows of A x: K2 on the halo-extended vector."""
        return self._op() @ self.device_mesh.halo_extend(x, self.H)

    def _prec(self, free):
        inv_diag = _inv_diag(self.diag, free)
        return lambda r: inv_diag * r

    def _solve(self, b, free, rtol, maxiter):
        def Ax(x):
            return self._spmv(x * free) * free + x * (1 - free)

        x, rr, k, bb = sharded_cg(Ax, self._prec(free), b, self.device_mesh, rtol, maxiter)
        return x, torch.sqrt(rr), k, torch.sqrt(bb)

    def solve(self, b, free_mask, rtol=1e-10, maxiter=1000, recovery=True):
        """Solve A x = b with Dirichlet dofs pinned where free_mask == 0
        (b carries the boundary values). Returns (x[:n] on every rank,
        ||r||, iterations); one escalation as ``HaloDIASolver.solve``."""
        b, free = self._pad_local(b), self._pad_local(free_mask)
        x, res, k, bnorm = self._solve(b, free, rtol, maxiter)
        if recovery:
            x, res, k = _maybe_escalate(self, ("vals", "diag"), (b, free), x, res, k, bnorm, rtol,
                                        maxiter)
        return self.device_mesh.all_gather(x)[: self.n], res, k
