"""3D banded split: a two-spacing offset structure -> a static 3D stencil
plus an ELL remainder.

Port of ``fdapde_core_tpu/ops/dia_split3d.py``, the 3D counterpart of
ops/dia_split.py. A 3D quasi-structured operator (a Freudenthal tet mesh,
jittered or not, or any dof order whose offset histogram concentrates on
two spacings W1 | W2) has flat offsets d = a W2 + b W1 + c with small
(a, b, c): viewing x as an (R, W2/W1, W1) lattice turns every such offset
into a static 3D shift, a ``GridDIA3D`` (slices, no gathers), with a small
ELL remainder for the entries that wrap. ``BandedMGPreconditioner3D`` runs
``GridMG3D`` Galerkin multigrid on the lattice embedded in a cube.

``plan_split_3d`` decides from the matrix alone (offset-histogram
coverage) and rejects scattered bands. The histogram is counted on the
device and read once; the sums run in a fixed order (each stencil layer
takes at most one entry per row; the remainder is compacted by a stable
sort along the slot axis, so its slots equal JAX's), and the remainder's
product is the K2 kernel (an ``ELLSoA``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .grid3d import GridDIA3D
from .matfree_soa import ELLSoA

__all__ = ["BandedSplit3D", "BandedMGPreconditioner3D", "plan_split_3d",
           "build_banded_split_3d"]


def plan_split_3d(E: ELLSoA, cmax: int = 1, min_frac: float = 0.01,
                  max_hist: int = 1 << 24, min_cover: float = 0.98):
    """Choose the two reshape spacings (W1, W2), W1 | W2, from the offset
    histogram of E's real entries. Returns (W1, W2), or (None, None) when
    no dominant two-level band exists. Search: every pair of dominant
    offsets (w1, w2) with w1 > cmax and w2 % w1 == 0, ranked by the share of
    entries in the window {a w2 + b w1 + c : |a|, |b| <= 1, |c| <= cmax};
    the best pair must cover ``min_cover`` of them."""
    n = E.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=E.cols.device)
    d = E.cols.to(torch.int64) - rows[None, :]  # offsets col - row
    B = int(d.abs().max()) if d.numel() else 0
    if B <= cmax or 2 * B + 1 > max_hist:
        return None, None
    # real entries only: padding carries col = row and val = 0
    hist = torch.bincount(d[E.vals != 0] + B, minlength=2 * B + 1).cpu().numpy()
    del d
    total = hist.sum()
    if total == 0:
        return None, None
    center = int(hist[B])
    pos = np.nonzero(hist >= max(1, int(min_frac * n)))[0] - B
    cands = sorted({int(abs(dd)) for dd in pos if abs(dd) > cmax})
    if not cands:
        return None, None

    def cover(w1, w2):
        window = {a * w2 + b * w1 + c
                  for a in (-1, 0, 1) for b in (-1, 0, 1) for c in range(-cmax, cmax + 1)}
        window.discard(0)
        return center + sum(int(hist[dd + B]) for dd in window if -B <= dd <= B)

    best = (0.0, None, None)
    for w2 in cands:
        if w2 <= cands[0]:
            continue
        for w1 in cands:
            if w1 >= w2 or w2 % w1 != 0:
                continue
            c = cover(w1, w2) / total
            if c > best[0]:
                best = (c, w1, w2)
    if best[0] < min_cover:
        return None, None
    return best[1], best[2]


def build_banded_split_3d(E: ELLSoA, W1: int, W2: int, amax: int = 1,
                          bmax: int = 1, cmax: int = 1, max_rem: int = 2):
    """Split an assembled ELLSoA into GridDIA3D((R, W2/W1, W1)) + an ELL
    remainder. Exact: stencil part + remainder == E.

    Returns (BandedSplit3D, overflowed): overflowed (a 0-dim bool tensor)
    means some row has more than ``max_rem`` unclaimed entries, and the
    remainder is truncated.
    """
    K, n = E.vals.shape
    M = W2 // W1
    R = -(-n // W2)
    rows = torch.arange(n, dtype=E.cols.dtype, device=E.cols.device)[None, :]
    d = E.cols - rows
    j0 = rows % W1
    j1 = (rows // W1) % M
    offsets3d = tuple((a, b, c)
                      for a in range(-amax, amax + 1)
                      for b in range(-bmax, bmax + 1)
                      for c in range(-cmax, cmax + 1))
    layers = []
    claimed = torch.zeros_like(E.cols, dtype=torch.bool)
    for (a, b, c) in offsets3d:
        m = ((d == a * W2 + b * W1 + c)
             & (j0 + c >= 0) & (j0 + c < W1) & (j1 + b >= 0) & (j1 + b < M))
        layer = torch.where(m, E.vals, 0.0).sum(dim=0)  # at most one match per row
        claimed |= m
        layers.append(F.pad(layer, (0, R * W2 - n)).reshape(R, M, W1))
    del d, j0, j1
    G = GridDIA3D(torch.stack(layers), offsets3d, (R, M, W1))
    del layers

    # remainder compaction: the unclaimed real entries move to the first
    # max_rem slots by a stable sort of their columns along the slot axis
    # (ELLSoA padding: col = row, val = 0)
    drop = claimed | (E.vals == 0.0)
    del claimed
    rc = torch.where(drop, n, E.cols)
    rv = torch.where(drop, 0.0, E.vals)
    del drop
    rc, order = torch.sort(rc, dim=0, stable=True)
    rv = torch.gather(rv, 0, order)
    del order
    if max_rem < K:
        overflowed = torch.any(rc[max_rem:] < n)
    else:
        overflowed = torch.zeros((), dtype=torch.bool, device=rc.device)
    rc, rv = rc[:max_rem], rv[:max_rem].contiguous()
    cols = torch.where(rc == n, rows.expand_as(rc), rc).to(torch.int32).contiguous()
    return BandedSplit3D(G, ELLSoA(rv, cols, (n, n)), n), overflowed


class BandedSplit3D:
    """y = (GridDIA3D over the (R, M, W1) reshape) x + (ELL remainder) x.

    The operator protocol (@, diagonal, astype, with_added_diagonal,
    fold_dirichlet) of the 2D BandedSplit; rem=None drops the remainder
    (a caller that checked it holds no nonzero entry)."""

    def __init__(self, G: GridDIA3D, rem: ELLSoA | None, n: int):
        self.G = G
        self.rem = rem
        self.n = n

    @property
    def shape(self):
        return (self.n, self.n)

    def _tail(self):
        R, M, W1 = self.G.shape3d
        return R * M * W1 - self.n

    def drop_empty_remainder(self):
        return BandedSplit3D(self.G, None, self.n)

    def __matmul__(self, v):
        y = (self.G @ F.pad(v, (0, self._tail())))[: self.n]
        return y if self.rem is None else y + self.rem @ v

    def diagonal(self):
        k0 = self.G.offsets3d.index((0, 0, 0))
        dd = self.G.data[k0].reshape(-1)[: self.n]
        return dd if self.rem is None else dd + self.rem.diagonal()

    def astype(self, dtype):
        return BandedSplit3D(
            GridDIA3D(self.G.data.to(dtype), self.G.offsets3d, self.G.shape3d),
            None if self.rem is None else self.rem.astype(dtype), self.n,
        )

    def with_added_diagonal(self, d):
        """A + diag(d), the implicit-Euler shift: only the centre layer
        changes."""
        k0 = self.G.offsets3d.index((0, 0, 0))
        dg = F.pad(torch.as_tensor(d, device=self.G.data.device).to(self.G.data.dtype),
                   (0, self._tail())).reshape(self.G.shape3d)
        data = self.G.data.clone()
        data[k0] += dg
        return BandedSplit3D(GridDIA3D(data, self.G.offsets3d, self.G.shape3d), self.rem, self.n)

    def fold_dirichlet(self, mask):
        """A' = F A F + (I - F), F = diag(~mask): the stencil layers through
        GridDIA3D.with_dirichlet_identity (the tail rows beyond n stay
        identity), the remainder's entries by val *= free[row] free[col]."""
        free = F.pad((~mask).to(self.G.data.dtype), (0, self._tail()))
        Gm = self.G.with_dirichlet_identity(free)
        if self.rem is None:
            return BandedSplit3D(Gm, None, self.n)
        fr = free[: self.n].to(self.rem.vals.dtype)
        rv = self.rem.vals * fr[None, :] * fr[self.rem.cols.long()]
        return BandedSplit3D(Gm, ELLSoA(rv, self.rem.cols, self.rem.shape), self.n)


class BandedMGPreconditioner3D:
    """GridMG3D Galerkin multigrid on the (R, M, W1) lattice of a banded
    split: when the two-spacing plan covered the histogram, the lattice is
    an approximate geometric embedding, so trilinear coarsening on it gives
    an SPD V-cycle with no gathers at any level. The apply (a call or
    ``@``) keeps the caller's dtype for the vector arithmetic."""

    def __init__(self, mg, shape3d, n, m):
        self.mg = mg
        self.shape3d = shape3d
        self.n = n
        self.m = m

    @classmethod
    def build(cls, F_split: BandedSplit3D, dtype=torch.float32, coarse_n: int = 8,
              omega: float = 0.8, nu: int = 2, coarse_iters: int = 64):
        """F_split: a Dirichlet-folded BandedSplit3D; None when its window
        is wider than 27 points. The (R, M, W1) lattice embeds into the
        next (m, m, m) cube with (m - 1) % 8 == 0 (identity on the padding),
        which ``GridMG3D.build`` coarsens."""
        from .grid_mg3d import GridMG3D

        G = F_split.G
        if any(abs(a) > 1 or abs(b) > 1 or abs(c) > 1 for a, b, c in G.offsets3d):
            return None
        R, M, W1 = G.shape3d
        m0 = max(R, M, W1)
        m = m0 + ((-(m0 - 1)) % 8)
        k0 = G.offsets3d.index((0, 0, 0))
        fine = torch.zeros((G.data.shape[0], m, m, m), dtype=dtype, device=G.data.device)
        fine[:, :R, :M, :W1] = G.data.to(dtype)
        ii = torch.arange(m, device=G.data.device)
        pad = (ii[:, None, None] >= R) | (ii[None, :, None] >= M) | (ii[None, None, :] >= W1)
        fine[k0] = torch.where(pad, 1.0, fine[k0])
        mg = GridMG3D.build(GridDIA3D(fine, tuple(G.offsets3d), (m, m, m)), coarse_n, omega,
                            nu, coarse_iters)
        return cls(mg, (R, M, W1), F_split.n, m)

    def __call__(self, r):
        R, M, W1 = self.shape3d
        m, n = self.m, self.n
        rp = F.pad(r, (0, R * M * W1 - n)).reshape(R, M, W1)
        rp = F.pad(rp, (0, m - W1, 0, m - M, 0, m - R))
        z = self.mg.v_cycle(rp.reshape(-1))
        return z.reshape(m, m, m)[:R, :M, :W1].reshape(-1)[:n]

    __matmul__ = __call__
