"""DIA (offset-diagonal) sparse storage: y = sum_k data[k] * shift(x, d_k).

Port of ``fdapde_core_tpu/linear_algebra/dia.py``. A matrix whose nonzero
(col - row) offsets form a small set (banded systems, FEM matrices on
structured or well-numbered meshes) is stored as a (K, n) array with
data[k, i] = A[i, i + offsets[k]]. ``DIAMatrix @ x`` runs the port's DIA
SpMV kernel K7 (``ops/dia_spmv.dia_spmv``: one thread per row, the K
diagonals in order); ``solve_elliptic`` and ``GridDIAMatrix.from_dia`` take
a ``DIAMatrix`` as they take any operator.

Difference from the JAX module, on purpose: ``dia_from_coo`` sums entries
that share a diagonal slot with ``sparse.SegmentSum`` (a host-built gather
table, each slot's entries added in input order) where JAX takes
``segment_sum``, so a DIA assembly is bitwise the same from run to run on
CUDA; values agree with JAX to ~1e-16 relative, not bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.dia_spmv import dia_spmv
from .sparse import SegmentSum, SparseMatrix, _as_device_tensor, _host

__all__ = ["DIAMatrix", "dia_from_coo", "prune_zero_offsets", "unique_offsets"]


def unique_offsets(dofs: np.ndarray) -> tuple[int, ...]:
    """All (col - row) offsets generated by a dof table (host, sorted)."""
    d = np.asarray(dofs, dtype=np.int64)
    offs = (d[:, None, :] - d[:, :, None]).reshape(-1)
    return tuple(int(o) for o in np.unique(offs))


@dataclass
class DIAMatrix:
    """Square sparse matrix in diagonal storage."""

    data: torch.Tensor  # (n_offsets, n); data[k, i] = A[i, i + offsets[k]]
    offsets: tuple[int, ...]
    n: int
    # the offsets as an int64 tensor on data's device, made at the first product
    _offsets_dev: torch.Tensor | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def shape(self):
        return (self.n, self.n)

    def __matmul__(self, x):
        x = torch.as_tensor(x, device=self.data.device)
        if x.shape != (self.n,):
            raise ValueError(f"operand must be ({self.n},), got {tuple(x.shape)}")
        dtype = torch.promote_types(self.data.dtype, x.dtype)
        if self._offsets_dev is None:
            self._offsets_dev = torch.tensor(self.offsets, dtype=torch.int64).to(self.data.device)
        return dia_spmv(self.data.to(dtype).contiguous(), self._offsets_dev,
                        x.to(dtype).contiguous())

    def diagonal(self):
        return self.data[self.offsets.index(0)]

    def to_sparse(self) -> SparseMatrix:
        """The same matrix as a sorted-COO ``SparseMatrix`` on data's device
        (every stored entry whose column lies in [0, n), zeros included)."""
        n, dev = self.n, self.data.device
        order = sorted(range(len(self.offsets)), key=lambda k: self.offsets[k])
        offs = torch.tensor([self.offsets[k] for k in order], dtype=torch.int64).to(dev)
        i = torch.arange(n, device=dev)
        cols = i[:, None] + offs[None, :]  # (n, K): row-major, columns ascending
        valid = (cols >= 0) & (cols < n)
        rows = i[:, None].expand_as(cols)[valid]
        vals = self.data[torch.tensor(order, device=dev)].T[valid]
        cols = cols[valid]
        if len(set(self.offsets)) < len(self.offsets):  # a repeated offset: sum its entries
            return SparseMatrix.from_coo(rows, cols, vals, self.shape)
        return SparseMatrix(rows.to(torch.int32), cols.to(torch.int32), vals, self.shape)


def dia_from_coo(rows, cols, vals, n: int, offsets: tuple[int, ...]) -> DIAMatrix:
    """DIA storage from (possibly duplicated) COO entries on vals' device
    (host vals go to the card).

    ``offsets`` is the SORTED offset set (e.g. ``unique_offsets(space.dofs)``);
    entries whose offset is not listed are dropped, so callers pass a
    complete set. rows and cols are read on the host (numpy arrays or
    tensors) to build the fixed-order sum once.
    """
    offsets = tuple(int(o) for o in offsets)
    if offsets != tuple(sorted(offsets)):
        raise ValueError("offsets must be sorted")
    vals = _as_device_tensor(vals)
    r = _host(rows).astype(np.int64).reshape(-1)
    d = _host(cols).astype(np.int64).reshape(-1) - r
    off = np.asarray(offsets, dtype=np.int64)
    k = np.clip(np.searchsorted(off, d), 0, len(offsets) - 1)
    keep = np.flatnonzero(off[k] == d)
    if keep.size < d.size:
        vals = vals[torch.as_tensor(keep, device=vals.device)]
    seg = (k * n + r)[keep]
    data = SegmentSum.build(seg, len(offsets) * n, vals.device)(vals)
    return DIAMatrix(data.reshape(len(offsets), n), offsets, n)


def prune_zero_offsets(D: DIAMatrix, tol: float = 0.0) -> DIAMatrix:
    """Drop diagonals whose max |entry| is <= tol (one host sync).

    FEM stencils carry structurally present but numerically zero diagonals
    (the hypotenuse coupling of right-triangle P1 meshes is exactly 0), and
    each costs a full n-vector read per product. The default 0 drops exact
    zeros only.
    """
    absmax = D.data.abs().amax(dim=1).cpu()
    keep = [k for k in range(len(D.offsets)) if absmax[k] > tol]
    if len(keep) == len(D.offsets):
        return D
    idx = torch.tensor(keep, device=D.data.device)
    return DIAMatrix(D.data.index_select(0, idx), tuple(D.offsets[k] for k in keep), D.n)
