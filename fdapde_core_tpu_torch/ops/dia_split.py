"""Band detection for assembled general operators.

Port of ``plan_split_width`` from ``fdapde_core_tpu/ops/dia_split.py``: it
decides from the offset histogram of an assembled ELL whether the matrix
has a concentrated band that a banded-DIA split could serve. The split
itself (``build_banded_split``, ``BandedMGPreconditioner``) is not ported
yet (ROADMAP queue 1, slice 3); callers that the plan accepts raise
``NotImplementedError`` instead of taking another path.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plan_split_width"]


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
