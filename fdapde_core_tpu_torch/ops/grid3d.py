"""3D grid stencils over the Freudenthal structured tet mesh: the stencil
matrix, its conversion from local tet matrices, and Jacobi CG.

Port of ``fdapde_core_tpu/ops/grid3d.py`` (the 3D counterpart of
grid_dia.py / grid_assembly.py / grid_cg.py). Dofs live on an (mx, my, mz)
node lattice (geometry/structured.unit_cube_mesh numbering: node (i, j, k)
-> i my mz + j mz + k); the P1 operator is a 15-point stencil (offsets in
{-1, 0, 1}^3 along the Kuhn-path directions), applied by slices of a
zero-bordered copy of x. Every (tet type, local row, local col) entry
resolves to one stencil layer and one contiguous (n, n, n) block, so the
conversion is 96 slice-adds in a fixed order. As in JAX this is plain
tensor code, not a kernel.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .closed_form import SYM4_TO_FULL
from .grid_cg import _safe_div

__all__ = ["GridDIA3D", "p1_cube_stencil", "grid_cg3d", "prune_zero_offsets_grid3d"]


def _pad3(x: torch.Tensor, h: int) -> torch.Tensor:
    """Zero border of width h around the last three dimensions."""
    return F.pad(x, (h, h, h, h, h, h))


def _shifted(xp, h: int, o, shape):
    """xp[h + di : h + di + mx, h + dj : ..., h + dk : ...] of a padded xp."""
    (di, dj, dk), (mx, my, mz) = o, shape
    return xp[h + di:h + di + mx, h + dj:h + dj + my, h + dk:h + dk + mz]


@dataclass
class GridDIA3D:
    """Stencil matrix over an (mx, my, mz) dof lattice."""

    data: torch.Tensor  # (K, mx, my, mz): data[k, i, j, l] = A[row, row + offset_k]
    offsets3d: tuple[tuple[int, int, int], ...]
    shape3d: tuple[int, int, int]

    @property
    def n(self):
        mx, my, mz = self.shape3d
        return mx * my * mz

    def __matmul__(self, x):
        xp = _pad3(x.reshape(self.shape3d), 1)
        acc = None
        for k, o in enumerate(self.offsets3d):
            t = self.data[k] * _shifted(xp, 1, o, self.shape3d)
            acc = t if acc is None else acc + t
        return acc.reshape(-1)

    def diagonal(self):
        k = self.offsets3d.index((0, 0, 0))
        return self.data[k].reshape(-1)

    def with_dirichlet_identity(self, free_flat):
        """A' = F A F + (I - F), F = diag(free_flat): the masking and the
        identity rows of pinned dofs folded into the stencil data."""
        freeg = free_flat.reshape(self.shape3d).to(self.data.dtype)
        fp = _pad3(freeg, 1)
        layers = []
        for k, o in enumerate(self.offsets3d):
            lay = self.data[k] * freeg * _shifted(fp, 1, o, self.shape3d)
            if o == (0, 0, 0):
                lay = lay + (1.0 - freeg)
            layers.append(lay)
        return GridDIA3D(torch.stack(layers), self.offsets3d, self.shape3d)


def prune_zero_offsets_grid3d(G: GridDIA3D, tol: float = 0.0) -> GridDIA3D:
    """Drop all-zero stencil layers (one host read of the per-layer max)."""
    absmax = G.data.abs().amax(dim=(1, 2, 3)).cpu()
    keep = [k for k in range(len(G.offsets3d)) if absmax[k] > tol]
    if len(keep) == len(G.offsets3d):
        return G
    idx = torch.tensor(keep, device=G.data.device)
    return GridDIA3D(G.data.index_select(0, idx), tuple(G.offsets3d[k] for k in keep),
                     G.shape3d)


def _tet_positions():
    """Local-vertex lattice offsets per tet type, as unit_cube_mesh numbers
    them: type t is the t-th permutation of itertools.permutations(range(3));
    odd permutations store their vertices as (v0, v2, v1, v3)."""
    evens = {(0, 1, 2), (1, 2, 0), (2, 0, 1)}
    out = []
    for perm in itertools.permutations(range(3)):
        p1 = [0, 0, 0]
        p1[perm[0]] += 1
        p2 = list(p1)
        p2[perm[1]] += 1
        pos = [(0, 0, 0), tuple(p1), tuple(p2), (1, 1, 1)]
        if perm not in evens:
            pos = [pos[0], pos[2], pos[1], pos[3]]
        out.append(tuple(pos))
    return tuple(out)


_POSITIONS = _tet_positions()


def p1_cube_stencil(A10, n: int) -> GridDIA3D:
    """GridDIA3D of the P1 operator from packed local tet matrices.

    A10: (10, >= 6 n^3) packed-symmetric local matrices (SYM4_TO_FULL
    expansion), the cell axis in unit_cube_mesh's 6 permutation blocks of
    n^3 cubes each (cells beyond 6 n^3 are ignored). Returns the (m, m, m)
    stencil, m = n + 1, with its 15 offsets sorted.
    """
    m = n + 1
    A = A10.reshape(10, -1)
    offsets = sorted({tuple(q[d] - p[d] for d in range(3))
                      for pos in _POSITIONS for p in pos for q in pos})
    layers = {o: torch.zeros((m, m, m), dtype=A10.dtype, device=A10.device) for o in offsets}
    for t, pos in enumerate(_POSITIONS):
        vals = A[:, t * n ** 3:(t + 1) * n ** 3].reshape(10, n, n, n)
        for p in range(4):
            for q in range(4):
                o = tuple(pos[q][d] - pos[p][d] for d in range(3))
                di, dj, dk = pos[p]
                layers[o][di:di + n, dj:dj + n, dk:dk + n] += vals[SYM4_TO_FULL[4 * p + q]]
    return GridDIA3D(torch.stack([layers[o] for o in offsets]), tuple(offsets), (m, m, m))


def grid_cg3d(G: GridDIA3D, b, n_iter: int, inv_diag=None):
    """``n_iter`` Jacobi-CG iterations on a 3D stencil (boundary treatment
    folded in); returns (x, |r|). The search direction lives in a
    zero-border frame, so the stencil reads plain slices of it; the
    divisions are guarded, and the loop reads nothing back to the host."""
    shape = G.shape3d
    H = max((max(abs(a), abs(c), abs(d)) for a, c, d in G.offsets3d), default=1)
    b = b.reshape(shape)
    if inv_diag is None:
        inv_diag = 1.0 / G.diagonal().reshape(shape)
    else:
        inv_diag = inv_diag.reshape(shape)

    def stencil(p_pad):
        acc = None
        for k, o in enumerate(G.offsets3d):
            t = G.data[k] * _shifted(p_pad, H, o, shape)
            acc = t if acc is None else acc + t
        return acc

    z0 = inv_diag * b
    x, r, p_pad, rz = torch.zeros_like(b), b, _pad3(z0, H), torch.sum(b * z0)
    for _ in range(n_iter):
        Ap = stencil(p_pad)
        p_c = _shifted(p_pad, H, (0, 0, 0), shape)
        pAp = torch.sum(p_c * Ap)
        alpha = _safe_div(rz, pAp, pAp > 0)
        x = x + alpha * p_c
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = torch.sum(r * z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p_pad = _pad3(z + beta * p_c, H)
        rz = rz_new
    return x.reshape(-1), torch.linalg.norm(r)
