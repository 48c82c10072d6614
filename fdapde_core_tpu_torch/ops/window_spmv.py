"""Windowed-ELL SpMV for scattered-banded operators.

Port of ``fdapde_core_tpu/ops/window_spmv.py`` (XLA there, no Pallas).
Rows come in static blocks of R; after RCM every column of block i lies in
[i R - B, i R + R + B) (B the matrix bandwidth, checked at construction),
so the product gathers from per-block windows of R + 2B contiguous x
values instead of the whole vector:

    windows = stack_i x[i R - B : i R + R + B]
    y_blk   = sum_k vals[blk, k, :] * windows[blk, idx_local[blk, k, :]]

The port runs the product on K2's compact form (a ``gather_spmv.ELLSoA``)
over the stacked windows: the window-local columns rebased once by
blk * (R + 2B) into the flattened windows, the slots in JAX's order, so a
product equals ``ELLSoA @ x`` bitwise, in every dtype pair. B stays
128-aligned, as in JAX, so both packages build the same layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gather_spmv import ELLSoA

__all__ = ["WindowedELL", "window_bandwidth"]


def window_bandwidth(cols):
    """max |col - row| over a (K, n) ELL column table (a 0-dim tensor)."""
    n = cols.shape[1]
    rows = torch.arange(n, dtype=cols.dtype, device=cols.device)[None, :]
    return torch.max(torch.abs(cols - rows))


class WindowedELL:
    """Block-windowed view of an ELLSoA for scattered-banded matrices.

    vals (NB, K, R), a view of the one table; idx (NB, K*R) int32
    window-local columns; rows beyond n are padding (val 0, idx clamped in
    range). n, R (block rows) and B (window halo = bandwidth, 128-aligned)
    are static.
    """

    def __init__(self, vals, idx, n: int, R: int, B: int):
        self.idx = idx
        self.n = n
        self.R = R
        self.B = B
        NB, K, _ = vals.shape
        base = torch.arange(NB, dtype=idx.dtype, device=idx.device)[:, None, None] * self.wwin
        # the one table: K2's (K, NB * R) compact ELL over the flattened
        # (NB * wwin,) windows; vals is its (NB, K, R) view
        self._k2 = ELLSoA(vals.permute(1, 0, 2).reshape(K, NB * R),
                          (idx.reshape(NB, K, R) + base).permute(1, 0, 2).reshape(K, NB * R)
                          .to(torch.int32), (NB * R, NB * self.wwin))
        self.vals = self._k2.vals.reshape(K, NB, R).permute(1, 0, 2)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def nb(self):
        return -(-self.n // self.R)

    @property
    def wwin(self):
        return self.R + 2 * self.B

    @classmethod
    def from_ell(cls, E, block_rows: int = 65536, bandwidth: int | None = None):
        """Rebase an ELLSoA into block-window layout on its device
        (``bandwidth`` None: read it from E here)."""
        K, n = E.vals.shape
        if bandwidth is None:
            bandwidth = int(window_bandwidth(E.cols))
        B = -(-max(int(bandwidth), 1) // 128) * 128  # the halo, 128-aligned as in JAX
        R = block_rows
        NB = -(-n // R)
        padn = NB * R - n
        colsb = F.pad(E.cols, (0, padn)).reshape(K, NB, R).transpose(0, 1)
        valsb = F.pad(E.vals, (0, padn)).reshape(K, NB, R).transpose(0, 1)
        base = torch.arange(NB, dtype=E.cols.dtype, device=E.cols.device) * R - B
        loc = torch.clamp(colsb - base[:, None, None], 0, R + 2 * B - 1)
        return cls(valsb, loc.reshape(NB, K * R).to(torch.int32), n, R, B)

    def __matmul__(self, v):
        if v.shape != (self.n,):
            raise ValueError(f"operand must be ({self.n},), got {tuple(v.shape)}")
        xp = F.pad(v, (self.B, self.nb * self.R + self.B - self.n))
        wins = xp.unfold(0, self.wwin, self.R).reshape(-1)  # (NB * wwin,) stacked windows
        return (self._k2 @ wins)[: self.n]

    def diagonal(self):
        """Diagonal via the rebased index: entry (blk, k, r) is on the
        diagonal iff its window-local column equals B + r."""
        NB, K, R = self.vals.shape
        r = torch.arange(R, dtype=self.idx.dtype, device=self.idx.device)[None, None, :]
        isdiag = self.idx.reshape(NB, K, R) == (self.B + r)
        d = torch.sum(torch.where(isdiag, self.vals, 0.0), dim=1)
        return d.reshape(-1)[: self.n]

    def astype(self, dtype):
        return WindowedELL(self.vals.to(dtype), self.idx, self.n, self.R, self.B)
