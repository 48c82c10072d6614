"""2D-grid stencil operators: DIA specialized to tensor-product dof layouts.

When dofs live on an (mx, my) grid (structured meshes), every
(col - row) offset decomposes as (di, dj) grid displacements and the SpMV
becomes a 2D stencil:

    y = sum_k data[k] * padded(x)[H+di_k : H+di_k+mx, H+dj_k : H+dj_k+my]
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["GridDIAMatrix", "grid_offsets_from_flat", "prune_zero_offsets_grid"]


def grid_offsets_from_flat(offsets: tuple[int, ...], my: int):
    """Decompose flat offsets d = di * my + dj (|dj| < my) into 2D pairs."""
    out = []
    for d in offsets:
        di = round(d / my)
        dj = d - di * my
        if abs(dj) >= my:
            raise ValueError(f"offset {d} does not decompose on a grid of width {my}")
        out.append((di, dj))
    return tuple(out)


def _halo(offsets2d) -> int:
    """Widest grid displacement of the stencil (zero-border width)."""
    return max((max(abs(a), abs(b)) for a, b in offsets2d), default=1)


def _pad2(x: torch.Tensor, h: int) -> torch.Tensor:
    """Zero border of width h around the last two dimensions."""
    return F.pad(x, (h, h, h, h))


@dataclass
class GridDIAMatrix:
    """Stencil matrix over an (mx, my) dof grid."""

    data: torch.Tensor  # (K, mx, my): data[k, i, j] = A[row, row + offset_k]
    offsets2d: tuple[tuple[int, int], ...]
    shape2d: tuple[int, int]

    @classmethod
    def from_dia(cls, dia, shape2d):
        """Reshape a flat DIA matrix (anything with ``n``, ``offsets`` and a
        (K, n) ``data``) onto an (mx, my) grid layout."""
        mx, my = shape2d
        if mx * my != dia.n:
            raise ValueError(f"grid {shape2d} does not hold {dia.n} dofs")
        off2d = grid_offsets_from_flat(dia.offsets, my)
        data = torch.as_tensor(dia.data).reshape(len(dia.offsets), mx, my)
        return cls(data, off2d, tuple(shape2d))

    @property
    def n(self):
        return self.shape2d[0] * self.shape2d[1]

    def __matmul__(self, x):
        mx, my = self.shape2d
        xg = x.reshape(mx, my)
        H = _halo(self.offsets2d)
        xp = _pad2(xg, H)
        y = torch.zeros_like(xg)
        for k, (di, dj) in enumerate(self.offsets2d):
            y = y + self.data[k] * xp[H + di:H + di + mx, H + dj:H + dj + my]
        return y.reshape(-1)

    def matvec_batch(self, X):
        """Batched stencil apply: X (B, n) flat rows -> (B, n); one padded
        slice per layer serves all B rows."""
        mx, my = self.shape2d
        B = X.shape[0]
        Xg = X.reshape(B, mx, my)
        H = _halo(self.offsets2d)
        xp = _pad2(Xg, H)
        y = torch.zeros_like(Xg)
        for k, (di, dj) in enumerate(self.offsets2d):
            y = y + self.data[k][None] * xp[:, H + di:H + di + mx, H + dj:H + dj + my]
        return y.reshape(B, -1)

    def diagonal(self):
        k = self.offsets2d.index((0, 0))
        return self.data[k].reshape(-1)

    def with_dirichlet(self, free_flat):
        """Fold Dirichlet masking into the data: A' = F A F.

        free_flat: (n,) 1.0 on free dofs, 0.0 on pinned ones."""
        mx, my = self.shape2d
        freeg = free_flat.reshape(mx, my)
        H = _halo(self.offsets2d)
        fp = _pad2(freeg, H)
        layers = []
        for k, (di, dj) in enumerate(self.offsets2d):
            shifted = fp[H + di:H + di + mx, H + dj:H + dj + my]
            layers.append(self.data[k] * freeg * shifted)
        return GridDIAMatrix(torch.stack(layers), self.offsets2d, self.shape2d)

    def with_dirichlet_identity(self, free_flat):
        """A' = F A F + (I - F): the masked operator with the identity on
        pinned dofs folded into the centre layer, so solvers need no
        per-iteration mask multiplies."""
        masked = self.with_dirichlet(free_flat)
        mx, my = self.shape2d
        pinned = 1.0 - free_flat.reshape(mx, my)
        k0 = masked.offsets2d.index((0, 0))
        # masked.data is a fresh stack: updating it in place copies nothing
        masked.data[k0] += pinned
        return masked


def prune_zero_offsets_grid(G: GridDIAMatrix, tol: float = 0.0) -> GridDIAMatrix:
    """Drop all-zero stencil layers (one host sync for the per-layer max).

    Right-triangle P1 meshes have zero hypotenuse coupling, so the
    structurally 7-point stencil is numerically 5-point: each dropped layer
    saves a full grid read per SpMV.
    """
    absmax = G.data.abs().amax(dim=(1, 2)).cpu()
    keep = [k for k in range(len(G.offsets2d)) if absmax[k] > tol]
    if len(keep) == len(G.offsets2d):
        return G
    idx = torch.tensor(keep, device=G.data.device)
    return GridDIAMatrix(
        G.data.index_select(0, idx),
        tuple(G.offsets2d[k] for k in keep),
        G.shape2d,
    )
