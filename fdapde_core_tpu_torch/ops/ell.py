"""Element-local (AoS) operators: the ELL incidence table, its combine and
the assembled row-ELL.

Port of ``fdapde_core_tpu/ops/ell.py``. The matrix-free FEM SpMV has three
stages:

    gather   xe = x[dofs]                  (C, nb)
    contract ye = A_loc @ xe               (C, nb)   batched small matvecs
    combine  y[d] = sum of ye over all (cell, slot) incident to dof d

The combine is a gather, not a scatter: a precomputed table ``adj[d, k]``
lists the flat (cell * nb + slot) positions incident to dof d (padded to
the largest degree), so each dof's sum runs in the table's order, with no
atomics. ``ELLMatrix`` is the assembled (n, K) row-ELL of the same
operator; its product is the K2 kernel on the slot-major (K, n) copy of
its tables (``ops/gather_spmv.ell_spmv``).

Name clash: JAX's ``fdapde_core_tpu.ops.ell_spmv`` is this module's
element-local combine. In this package ``ops.ell_spmv`` is K2's wrapper,
which every caller uses; the combine is ``ops.ell.ell_spmv``.
"""

from __future__ import annotations

import torch

from .matfree_soa import ELLSoA, _compact_sorted

__all__ = ["ELLMatrix", "build_ell_adjacency", "ell_spmv", "local_matvec"]


def build_ell_adjacency(dofs, n_dofs: int, max_degree: int):
    """ELL incidence table of a (C, nb) int32 dof table.

    Returns adj (n_dofs, max_degree) int32 positions into the flattened
    (C * nb,) element-local vector (cell-major: cell * nb + slot, each
    dof's in increasing position), mask (n_dofs, max_degree) bool, and
    whether a dof has more than max_degree incidences (a 0-dim bool
    tensor).
    """
    flat = dofs.reshape(-1)
    order = torch.argsort(flat, stable=True).to(torch.int32)
    sorted_d = flat[order]
    ids = torch.arange(n_dofs, dtype=flat.dtype, device=flat.device)
    starts = torch.searchsorted(sorted_d, ids, out_int32=True)
    ends = torch.searchsorted(sorted_d, ids + 1, out_int32=True)
    counts = ends - starts
    k = torch.arange(max_degree, dtype=torch.int32, device=flat.device)
    idx = starts[:, None] + k[None, :]
    mask = k[None, :] < counts[:, None]
    adj = order[torch.clamp(idx, 0, flat.shape[0] - 1)]
    return adj, mask, torch.any(counts > max_degree)


def local_matvec(A_loc, dofs, x):
    """Stages 1 + 2: per-element products ye = A_loc @ x[dofs], (C, nb)."""
    return torch.einsum("cij,cj->ci", A_loc, x[dofs])


def ell_spmv(A_loc, dofs, adj, mask, x):
    """The whole element-local SpMV: y = A x with A given element-locally
    (the combine sums each dof's incidences in the table's order)."""
    ye = local_matvec(A_loc, dofs, x).reshape(-1)
    return (ye[adj] * mask.to(ye.dtype)).sum(dim=1)


class ELLMatrix:
    """Assembled row-ELL sparse matrix: vals/cols (n, K), padded rows carry
    col = row and val = 0 (no mask in the SpMV), no duplicate (row, col)
    pairs (``from_local`` merges them). The product is K2 on the
    slot-major (K, n) copy of the tables."""

    def __init__(self, vals, cols, shape):
        self.vals = vals  # (n, K)
        self.cols = cols  # (n, K) int32
        self.shape = tuple(shape)
        self._slot_major = ELLSoA(vals.T.contiguous(), cols.T.contiguous(), self.shape)

    def __matmul__(self, x):
        return self._slot_major @ x

    def diagonal(self):
        rows = torch.arange(self.shape[0], dtype=self.cols.dtype, device=self.cols.device)
        return torch.where(self.cols == rows[:, None], self.vals, 0.0).sum(dim=1)

    def astype(self, dtype):
        return ELLMatrix(self.vals.to(dtype), self.cols, self.shape)

    def with_added_diagonal(self, d):
        """A + diag(d): only the first (row == col) slot of each row changes
        (the diagonal is in every FEM pattern)."""
        rows = torch.arange(self.shape[0], dtype=self.cols.dtype, device=self.cols.device)
        isdiag = self.cols == rows[:, None]
        first = isdiag & (torch.cumsum(isdiag, dim=1) == 1)
        d = torch.as_tensor(d, device=self.vals.device)
        return ELLMatrix(self.vals + torch.where(first, d[:, None], 0.0), self.cols, self.shape)

    @classmethod
    def from_local(cls, A_loc, dofs, adj, adj_mask, max_cols: int):
        """Assemble from element-local matrices and their incidence table.

        Dof d's incident positions adj[d] = cell * nb + slot contribute the
        local rows A_loc[cell, slot, :] at columns dofs[cell, :]; a stable
        sort of the columns along each row's candidates, then max_cols
        masked sums merge the entries that share a column
        (setFromTriplets, fem_assembler.h:99-112, as a sorted reduction).
        Returns (ELLMatrix, overflowed): overflowed means a row has more
        than max_cols distinct columns and is truncated.
        """
        n, D = adj.shape
        nb = dofs.shape[1]
        a = adj.long()
        c, i = a // nb, a % nb  # (n, D) incident cells and slots
        valid = adj_mask[:, :, None]
        cols_all = torch.where(valid, dofs[c], n).to(torch.int32)  # (n, D, nb)
        vals_all = torch.where(valid, A_loc[c, i], 0.0)
        # candidate e = d * nb + j along the leading axis, JAX's row order
        cols_all = cols_all.reshape(n, D * nb).T
        vals_all = vals_all.reshape(n, D * nb).T
        row_ids = torch.arange(n, dtype=torch.int32, device=adj.device)
        vals, cols, overflowed = _compact_sorted(cols_all, vals_all, row_ids, n, max_cols)
        return cls(vals.T.contiguous(), cols.T.contiguous(), (n, n)), overflowed
