"""Distributed geometric multigrid: row-sharded V-cycle + halo CG.

Port of ``fdapde_core_tpu/parallel/mg.py``, the multi-device counterpart
of ``ops/grid_mg.py`` (plain torch). The (m, m) dof grid is split into
contiguous row blocks over a 1D ShardMesh:

- weighted-Jacobi smoothing has no dot products: one (1, m) halo-row
  exchange per stencil application,
- restriction and prolongation need the same single halo row,
- below ``repl_rows`` grid rows the hierarchy is replicated: entered by
  one all_gather of the transition level's residual per V-cycle, after
  which every shard runs the same coarse tail,
- the outer CG adds two psums an iteration (``cg.sharded_cg``).

Row blocks align 2:1 across levels: shard d owns coarse rows
[d B_{l+1}, (d+1) B_{l+1}) and fine rows [d B_l, (d+1) B_l), B_l = 2
B_{l+1} (B even), so coarse row I's fine parent 2I is local and the +-1
stencil and transfer rows are the one-row halo. Levels are padded to
P * B_l rows with identity rows (diagonal 1, no couplings, zero rhs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.grid_dia import GridDIAMatrix
from ..ops.grid_mg import GridMG, _prolong, _restrict
from .cg import sharded_cg
from .comm import ShardMesh

__all__ = ["ShardedGridMG"]

_W = {-1: 0.5, 0: 1.0, 1: 0.5}


def _even_ceil(a: int, b: int) -> int:
    c = -(-a // b)
    return c + (c % 2)


class ShardedGridMG:
    """MG-preconditioned CG for a (Dirichlet-folded) GridDIAMatrix over a
    1D ShardMesh."""

    def __init__(self, G: GridDIAMatrix, device_mesh: ShardMesh, repl_rows: int = 256,
                 coarse_n: int = 32, omega: float = 0.8, nu: int = 2, coarse_iters: int = 64):
        self.device_mesh = device_mesh
        self.P = P = device_mesh.size
        self.omega, self.nu = omega, nu
        G = GridDIAMatrix(torch.as_tensor(G.data, device=device_mesh.device), G.offsets2d,
                          G.shape2d)
        mg = GridMG.build(G, coarse_n=coarse_n, omega=omega, nu=nu, coarse_iters=coarse_iters)
        if mg.n_levels < 2:
            raise ValueError("grid too small / coarse_n too large to build a hierarchy")
        shapes = mg.shapes
        # transition level: the first level small enough to replicate
        T = next((l for l, m in enumerate(shapes) if m <= repl_rows), len(shapes))
        if T == len(shapes) and shapes[-1] > repl_rows:
            raise ValueError("coarsest level larger than repl_rows; raise repl_rows")
        T = max(min(T, len(shapes) - 1), 1)  # keep the fine level sharded
        self.T = T
        B = [0] * T
        B[T - 1] = max(2, _even_ceil(shapes[T - 1], P))
        for l in range(T - 2, -1, -1):
            B[l] = 2 * B[l + 1]
        self.blocks = tuple(B)
        self.shapes = shapes
        self.offsets = mg.offsets
        self.tail = GridMG(mg.datas[T:], mg.offsets[T:], shapes[T:], omega, nu, coarse_iters)
        # sharded levels: rows padded to P * B with identity rows; this
        # shard's block of them
        self.datas = []
        for l in range(T):
            data, m = mg.datas[l], shapes[l]
            pad = P * B[l] - m
            if pad < 0:
                raise ValueError("row block too small for the level")
            data = F.pad(data, (0, 0, 0, pad))
            if pad:
                data[self.offsets[l].index((0, 0)), m:, :] = 1.0
            r = device_mesh.rank
            self.datas.append(data[:, r * B[l]:(r + 1) * B[l]].contiguous())

    # -- sharded-level primitives ---------------------------------------------
    def _halo(self, x):
        return self.device_mesh.halo_extend(x, 1)

    @staticmethod
    def _stencil_local(data, offs, ext, Bl, m):
        """y over the local (Bl, m) block from the halo-extended (Bl+2, m)."""
        extc = F.pad(ext, (1, 1))
        acc = None
        for k, (di, dj) in enumerate(offs):
            t = data[k] * extc[1 + di:1 + di + Bl, 1 + dj:1 + dj + m]
            acc = t if acc is None else acc + t
        return acc

    def _smooth_local(self, l, x, b):
        data, offs = self.datas[l], self.offsets[l]
        Bl, m = self.blocks[l], self.shapes[l]
        inv_diag = 1.0 / data[offs.index((0, 0))]
        for _ in range(self.nu):
            x = x + self.omega * inv_diag * (b - self._stencil_local(data, offs, self._halo(x), Bl, m))
        return x

    def _restrict_local(self, l, r):
        """Sharded level l residual -> sharded level l+1 local block."""
        Bc, mc = self.blocks[l + 1], self.shapes[l + 1]
        ext = F.pad(self._halo(r), (1, 1))
        acc = None
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                t = _W[a] * _W[b] * ext[1 + a:1 + a + 2 * (Bc - 1) + 1:2,
                                        1 + b:1 + b + 2 * (mc - 1) + 1:2]
                acc = t if acc is None else acc + t
        return acc

    def _prolong_local(self, l, e_c):
        """Sharded level l+1 correction -> sharded level l local block. The
        local frame needs the upsampled rows [d Bl - 1, (d+1) Bl]: the first
        is odd (zero), the last the right neighbour's first coarse row."""
        Bl, Bc = self.blocks[l], self.blocks[l + 1]
        mf, mc = self.shapes[l], self.shapes[l + 1]
        _, nxt = self.device_mesh.halo(e_c, 1)
        uc = e_c.new_zeros((Bl + 2, mf + 2))
        uc[1:2 * (Bc - 1) + 2:2, 1:2 * (mc - 1) + 2:2] = e_c
        uc[Bl + 1, 1:2 * (mc - 1) + 2:2] = nxt[0]
        acc = None
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                t = _W[a] * _W[b] * uc[1 + a:1 + a + Bl, 1 + b:1 + b + mf]
                acc = t if acc is None else acc + t
        return acc

    def _v_sharded(self, l, b):
        T = self.T
        data, offs = self.datas[l], self.offsets[l]
        Bl, m = self.blocks[l], self.shapes[l]
        x = self._smooth_local(l, torch.zeros_like(b), b)
        r = b - self._stencil_local(data, offs, self._halo(x), Bl, m)
        if l + 1 < T:
            ec = self._v_sharded(l + 1, self._restrict_local(l, r))
            x = x + self._prolong_local(l, ec)
        else:
            # transition: gather the fine residual, run the replicated tail
            # on every shard, keep this shard's rows of the prolongation
            r_real = self.device_mesh.all_gather(r)[:m]
            e_T = self.tail._v(0, _restrict(r_real, self.shapes[T]))
            e_fine = F.pad(_prolong(e_T, m), (0, 0, 0, self.P * Bl - m))
            d = self.device_mesh.rank
            x = x + e_fine[d * Bl:(d + 1) * Bl]
        return self._smooth_local(l, x, b)

    def solve(self, b, rtol: float = 1e-8, maxiter: int = 60):
        """b: (n,) rhs (boundary values on pinned dofs, or the reduced rhs).
        Returns (x (n,) on every rank, relative residual estimate,
        iterations)."""
        m, B0 = self.shapes[0], self.blocks[0]
        data0, offs0 = self.datas[0], self.offsets[0]
        b = torch.as_tensor(b, device=self.device_mesh.device).to(data0.dtype).reshape(m, m)
        d = self.device_mesh.rank
        loc = b[d * B0:(d + 1) * B0]
        b = F.pad(loc, (0, 0, 0, B0 - loc.shape[0]))

        def Ax(x):
            return self._stencil_local(data0, offs0, self._halo(x), B0, m)

        x, rr, k, bb = sharded_cg(Ax, lambda r: self._v_sharded(0, r), b, self.device_mesh, rtol,
                                  maxiter)
        x = self.device_mesh.all_gather(x)[:m]
        return x.reshape(-1), torch.sqrt(rr / bb), k
