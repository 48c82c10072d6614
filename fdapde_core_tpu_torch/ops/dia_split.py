"""Banded-DIA + ELL-remainder split of assembled general sparse operators.

Port of ``fdapde_core_tpu/ops/dia_split.py``. For a banded matrix (a
quasi-uniform mesh, a tensor grid, any matrix after an RCM reordering):

1. ``plan_split_width`` reads the flat offset histogram d = col - row of
   an assembled ELL and picks a reshape width W, the dominant |offset|
   beyond the lane range.
2. Viewing x as an (R, W) grid (R = ceil(n / W)), every flat offset
   d = a W + b with small (a, b) is a static 2D stencil shift: a
   ``GridDIAMatrix`` over the (R, W) grid, applied by slices.
3. Entries outside the stencil window, or whose lane position wraps
   (j + b outside [0, W)), stay in a small ELL remainder (an ``ELLSoA``,
   whose product is the K2 kernel).

The split is exact: stencil part + remainder == the input operator.
``BandedMGPreconditioner`` runs geometric multigrid on the (R, W) index
grid (bilinear Galerkin coarsening, ``ops/grid_mg.GridMG``), a V-cycle
with no gathers; ``banded_cg`` is a fixed-count Jacobi CG on a
Dirichlet-folded split.

As in JAX, the stencil part is plain tensor code (XLA there, not Pallas).
The sums here run in a fixed order: each stencil layer takes at most one
entry per row, and the remainder is compacted by a stable sort along the
slot axis, so its slots equal JAX's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .grid_cg import stencil_matvec_padded
from .grid_dia import GridDIAMatrix
from .matfree_soa import ELLSoA

__all__ = ["BandedSplit", "BandedMGPreconditioner", "plan_split_width",
           "build_banded_split", "banded_cg"]


def plan_split_width(E, bmax: int = 1, min_frac: float = 0.02,
                     max_hist: int = 1 << 24, max_amax: int = 2,
                     min_cover: float = 0.98, bcap: int = 8192):
    """Choose the reshape width W of a banded split from E's offset
    histogram. Returns (W, amax), or (None, 0) when the matrix has no
    dominant band.

    The plan is accepted only when the window {a*W + b : |a| <= amax,
    |b| <= bmax} covers at least ``min_cover`` of the real entries: a
    scattered band (every offset in [-B, B] appears a little) is rejected.
    ``bcap`` sizes a fused probe on the TPU; here the histogram is always
    exact, with the same result.
    """
    n = E.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=E.cols.device)
    d = E.cols.to(torch.int64) - rows[None, :]  # offsets col - row
    B = int(d.abs().max()) if d.numel() else 0
    if B <= bmax or 2 * B + 1 > max_hist:
        return None, 0
    # histogram of the real entries: padding carries col = row and val = 0
    hist = torch.bincount(d[E.vals != 0] + B, minlength=2 * B + 1).cpu().numpy()
    del d
    total = hist.sum()
    center = hist[B]
    hist[B] = 0  # the main diagonal is always captured; never a W
    offs = np.nonzero(hist >= max(1, int(min_frac * n)))[0] - B
    offs = offs[np.abs(offs) > bmax]
    if offs.size == 0 or total == 0:
        return None, 0
    W = int(np.abs(offs[np.argmax(hist[offs + B])]))
    amax = max(1, int(round(B / W)))
    if amax > max_amax:
        return None, 0
    window = [a * W + b
              for a in range(-amax, amax + 1) for b in range(-bmax, bmax + 1)]
    cover = center + sum(hist[dd + B] for dd in window if -B <= dd <= B and dd != 0)
    if cover < min_cover * total:
        return None, 0
    return W, amax


def build_banded_split(E: ELLSoA, W: int, amax: int = 1, bmax: int = 1,
                       max_rem: int = 2):
    """Split an assembled ELLSoA into GridDIA((R, W)) + an ELL remainder.

    Returns (BandedSplit, overflowed): overflowed (a 0-dim bool tensor)
    means some row has more than ``max_rem`` unclaimed entries, and the
    remainder is truncated (rebuild with a larger bound).
    """
    K, n = E.vals.shape
    R = -(-n // W)
    rows = torch.arange(n, dtype=E.cols.dtype, device=E.cols.device)[None, :]
    d = E.cols - rows
    j = rows % W  # lane position of each row
    offsets2d = tuple((a, b) for a in range(-amax, amax + 1) for b in range(-bmax, bmax + 1))
    layers = []
    claimed = torch.zeros_like(E.cols, dtype=torch.bool)
    for a, b in offsets2d:
        m = (d == a * W + b) & (j + b >= 0) & (j + b < W)
        layer = torch.where(m, E.vals, 0.0).sum(dim=0)  # at most one match per row
        claimed |= m
        layers.append(F.pad(layer, (0, R * W - n)).reshape(R, W))
    del d, j
    G = GridDIAMatrix(torch.stack(layers), offsets2d, (R, W))
    del layers

    # remainder compaction: the unclaimed real entries move to the first
    # max_rem slots by a stable sort of their columns along the slot axis
    # (ELLSoA padding convention: col = row, val = 0)
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
    return BandedSplit(G, ELLSoA(rv, cols, (n, n)), n), overflowed


class BandedSplit:
    """y = (GridDIA over the (R, W) reshape) x + (ELL remainder) x.

    The operator protocol (@, diagonal, astype) of
    fem/solvers.DirichletSystem; ``fold_dirichlet`` bakes the masking into
    the stencil layers so the CG loop (``banded_cg``) touches no masks.
    """

    def __init__(self, G: GridDIAMatrix, rem: ELLSoA | None, n: int):
        self.G = G
        self.rem = rem  # None: the band captured every entry
        self.n = n

    @property
    def shape(self):
        return (self.n, self.n)

    def _tail(self):
        R, W = self.G.shape2d
        return R * W - self.n

    def drop_empty_remainder(self):
        """The band-only operator, for a caller that checked that the
        remainder holds no nonzero entry: its product is then pure slices."""
        return BandedSplit(self.G, None, self.n)

    def __matmul__(self, v):
        y = (self.G @ F.pad(v, (0, self._tail())))[: self.n]
        return y if self.rem is None else y + self.rem @ v

    def diagonal(self):
        k0 = self.G.offsets2d.index((0, 0))
        d = self.G.data[k0].reshape(-1)[: self.n]
        return d if self.rem is None else d + self.rem.diagonal()

    def astype(self, dtype):
        return BandedSplit(
            GridDIAMatrix(self.G.data.to(dtype), self.G.offsets2d, self.G.shape2d),
            None if self.rem is None else self.rem.astype(dtype), self.n,
        )

    def with_added_diagonal(self, d):
        """A + diag(d), the implicit-Euler shift A + M_lumped / dt: only the
        centre layer changes."""
        R, W = self.G.shape2d
        k0 = self.G.offsets2d.index((0, 0))
        dg = F.pad(torch.as_tensor(d, device=self.G.data.device).to(self.G.data.dtype),
                   (0, self._tail())).reshape(R, W)
        data = self.G.data.clone()
        data[k0] += dg
        return BandedSplit(GridDIAMatrix(data, self.G.offsets2d, self.G.shape2d), self.rem, self.n)

    def fold_dirichlet(self, mask):
        """A' = F A F + (I - F), F = diag(~mask): the stencil layers are
        masked by GridDIAMatrix.with_dirichlet_identity (the tail rows
        beyond n stay identity), the remainder's entries by
        val *= free[row] * free[col]."""
        free = F.pad((~mask).to(self.G.data.dtype), (0, self._tail()))
        Gm = self.G.with_dirichlet_identity(free)
        if self.rem is None:
            return BandedSplit(Gm, None, self.n)
        fr = free[: self.n].to(self.rem.vals.dtype)
        rv = self.rem.vals * fr[None, :] * fr[self.rem.cols.long()]
        return BandedSplit(Gm, ELLSoA(rv, self.rem.cols, self.rem.shape), self.n)


class BandedMGPreconditioner:
    """Geometric multigrid on the (R, W) index grid of a banded split.

    For a banded operator consecutive row indices are spatially adjacent
    (that is what a concentrated offset histogram means), so the index grid
    is an approximate geometric embedding: bilinear Galerkin coarsening on
    it (``ops/grid_mg.GridMG``) gives an SPD V-cycle with no gathers at any
    level. ``build`` returns None when the split is not 9-point. The apply
    (a call or ``@``) keeps the caller's dtype for the vector arithmetic.
    """

    def __init__(self, mg, shape2d, n, m):
        self.mg = mg
        self.shape2d = shape2d
        self.n = n
        self.m = m

    @classmethod
    def build(cls, F_split: BandedSplit, dtype=torch.float32, coarse_n: int = 32,
              omega: float = 0.8, nu: int = 2, coarse_iters: int = 64):
        """F_split: a Dirichlet-folded BandedSplit (fold_dirichlet applied);
        None when it is not 9-point (galerkin_coarsen needs that window).
        The (R, W) grid embeds in an (m, m) grid with (m - 1) % 8 == 0
        (three coarsenings at least), identity on the padding, and
        ``GridMG.build`` coarsens it."""
        from .grid_mg import GridMG

        G = F_split.G
        if any(abs(a) > 1 or abs(b) > 1 for a, b in G.offsets2d):
            return None
        R, W = G.shape2d
        m0 = max(R, W)
        m = m0 + ((-(m0 - 1)) % 8)
        k0 = G.offsets2d.index((0, 0))
        fine = torch.zeros((G.data.shape[0], m, m), dtype=dtype, device=G.data.device)
        fine[:, :R, :W] = G.data.to(dtype)
        ii = torch.arange(m, device=G.data.device)
        fine[k0] = torch.where((ii[:, None] >= R) | (ii[None, :] >= W), 1.0, fine[k0])
        mg = GridMG.build(GridDIAMatrix(fine, tuple(G.offsets2d), (m, m)), coarse_n, omega, nu,
                          coarse_iters)
        return cls(mg, (R, W), F_split.n, m)

    def __call__(self, r):
        R, W = self.shape2d
        m, n = self.m, self.n
        rp = F.pad(r, (0, R * W - n)).reshape(R, W)
        z = self.mg.v_cycle(F.pad(rp, (0, m - W, 0, m - R)))
        return z[:R, :W].reshape(-1)[:n]

    __matmul__ = __call__


def banded_cg(op: BandedSplit, b, n_iter: int, inv_diag=None):
    """Fixed-count Jacobi CG on a Dirichlet-folded BandedSplit. The search
    direction lives in a zero-border (R+2H, W+2H) frame, so the stencil
    part reads plain slices; the remainder takes its flat form. Returns
    (x, |r|, ok): ok (a 0-dim bool tensor) is False after a breakdown
    (pAp <= 0, or rz <= 0 with a nonzero right-hand side), where the
    guarded loop froze the iterate instead of corrupting it. No host sync
    inside the loop. A tensor b keeps its device; host input goes to the
    operator's."""
    R, W = op.G.shape2d
    n = op.n
    H = max(max(abs(a), abs(c)) for a, c in op.G.offsets2d)
    data = op.G.data
    tail = R * W - n

    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b), device=data.device)
    if inv_diag is None:
        inv_diag = 1.0 / op.diagonal()

    def apply_pad(p_pad, p_flat):
        Ap = stencil_matvec_padded(data, op.G.offsets2d, p_pad, H).reshape(-1)[:n]
        return Ap if op.rem is None else Ap + op.rem @ p_flat

    def to_pad(v_flat):
        return F.pad(F.pad(v_flat, (0, tail)).reshape(R, W), (H, H, H, H))

    z = inv_diag * b
    x, r, p, p_pad, rz = torch.zeros_like(b), b, z, to_pad(z), torch.sum(b * z)
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    for _ in range(n_iter):
        Ap = apply_pad(p_pad, p)
        pAp = torch.sum(p * Ap)
        # a zero right-hand side (rz == 0 at entry) is convergence, not breakdown
        ok = ok & ((pAp > 0) | (rz == 0))
        alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = z + beta * p
        p_pad = to_pad(p)
        rz = rz_new
    return x, torch.sqrt(torch.sum(r * r)), ok
