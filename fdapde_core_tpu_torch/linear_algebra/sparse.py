"""Sorted-COO sparse matrices whose sums run in a fixed order.

Port of ``fdapde_core_tpu/linear_algebra/sparse.py``: entries are stored in
(row, col)-sorted COO order with a static shape; the structure (rows, cols)
is computed on the host once per mesh and reused, so only ``vals`` changes
between assemblies.

The JAX package forms A @ x as a gather and a ``segment_sum``, outside any
Pallas kernel. On CUDA, ``index_add_`` adds with atomics in an order that
varies from run to run, and so would the iteration count of every solve
built on it. Every sum here therefore runs in a fixed order:

- ``SegmentSum`` (built on the host once per pattern) lays the positions
  that share an output slot out as a padded (D, n_out) gather table, D the
  largest multiplicity, and reduces it over its first axis: slot s receives
  its positions in increasing order. It sums duplicates in ``from_coo`` and
  scatters local matrices and vectors in ``fem/assembler.py``.
- ``A @ x`` lays each row's entries out once as a (D, n) ELL, D the
  longest row, in column order, and applies it with the port's ELL gather
  SpMV kernel K2 (``ops/gather_spmv.ell_spmv``: one thread per row, its
  slots in order).
- ``A @ X`` for an (n_src, k) block (a vector is one column) runs on K2,
  c columns per launch: the ELL of I_c (x) A (c copies of the table, copy
  j reading column j of X) applied to c columns of X laid end to end. Each
  column's rows take their slots in the order a one-column launch takes
  them, so the result equals k vector products bitwise. c is as large as
  keeps the copied table within ``_BLOCK_ENTRIES`` (and its columns within
  int32), at least 1; the copies are kept per (dtype, c), and c = 1 is the
  ELL itself. ``matmul_reference`` is the plain gather-multiply-sum of
  either form, the oracle the products are held to.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gather_spmv import ell_spmv

__all__ = ["SegmentSum", "SparseMatrix", "coo_sum_duplicates"]

# ELL entries of one multi-column launch: c copies of a (D, n) table hold
# c * D * n <= 2**24 entries (192 MiB of float64 values and int32 columns)
_BLOCK_ENTRIES = 1 << 24
_INT32_MAX = 2**31 - 1


def coo_sum_duplicates(rows, cols, n_rows, n_cols):
    """Host-side: dedupe & sort (row, col) pairs.

    Returns (rows_u, cols_u, inverse) with inverse mapping each input entry
    to its slot (the scatter-add semantics of Eigen's `setFromTriplets`):
    values are later combined with ``SegmentSum.build(inverse, nnz)``.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keys = rows * np.int64(n_cols) + cols
    uniq, inverse = np.unique(keys, return_inverse=True)
    return (
        (uniq // n_cols).astype(np.int32),
        (uniq % n_cols).astype(np.int32),
        inverse.reshape(-1).astype(np.int32),
    )


class SegmentSum:
    """out[s] = sum of src[p] over the positions p with ids[p] == s, added
    in increasing p; slots no position maps to get 0.

    ``table``: (D, n_out) int64 positions into src, ``n_src`` (a zero
    appended to src) filling the unused entries.
    """

    def __init__(self, table: torch.Tensor, n_src: int):
        self.table = table
        self.n_src = n_src

    @classmethod
    def build(cls, ids, n_out: int, device="cuda") -> "SegmentSum":
        """Table for an (n_src,) array of slot ids in [0, n_out)."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        order = np.argsort(ids, kind="stable")
        counts = np.bincount(ids, minlength=n_out)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        sorted_ids = ids[order]
        rank = np.arange(ids.size) - starts[sorted_ids]
        table = np.full((int(counts.max(initial=0)), n_out), ids.size, dtype=np.int64)
        table[rank, sorted_ids] = order
        return cls(torch.as_tensor(table, device=device), int(ids.size))

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        """(n_src, ...) -> (n_out, ...)."""
        if src.shape[0] != self.n_src:
            raise ValueError(f"src must have {self.n_src} rows, got {tuple(src.shape)}")
        ext = torch.cat([src, src.new_zeros((1,) + tuple(src.shape[1:]))])
        return ext[self.table].sum(0)


class SparseMatrix:
    """Sorted-COO sparse matrix: rows (nnz,) int32 sorted, cols (nnz,)
    int32 sorted within each row, vals (nnz,), all on one device."""

    def __init__(self, rows, cols, vals, shape, _row_sum: SegmentSum | None = None):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.shape = tuple(int(s) for s in shape)
        self._row_sum = _row_sum  # the rows' ELL layout, shared by with_vals
        self._ell = None  # (vals, cols) ELL tables, built at the first product
        self._ell_blocks = {}  # (dtype, c) -> ELL of I_c (x) A, see __matmul__
        self._T = None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "SparseMatrix":
        """Build from possibly-duplicated COO triplets (duplicates summed),
        on vals' device."""
        vals = torch.as_tensor(vals)
        r, c, inv = coo_sum_duplicates(_host(rows), _host(cols), *shape)
        v = SegmentSum.build(inv, r.shape[0], vals.device)(vals)
        return cls(torch.as_tensor(r, device=vals.device),
                   torch.as_tensor(c, device=vals.device), v, shape)

    @classmethod
    def from_scipy(cls, m, dtype=torch.float64, device="cuda") -> "SparseMatrix":
        """From any scipy.sparse matrix (duplicates summed), on ``device``."""
        m = m.tocoo()
        vals = torch.as_tensor(np.asarray(m.data, dtype=np.float64), device=device).to(dtype)
        return cls.from_coo(m.row, m.col, vals, m.shape)

    @classmethod
    def from_dense(cls, a, tol: float = 0.0, dtype=torch.float64, device="cuda") -> "SparseMatrix":
        """The entries of a dense host array with |a_ij| > tol, on ``device``."""
        a = np.asarray(a)
        r, c = np.nonzero(np.abs(a) > tol)
        vals = torch.as_tensor(np.asarray(a[r, c], dtype=np.float64), device=device).to(dtype)
        return cls.from_coo(r, c, vals, a.shape)

    # -- algebra ------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    def _ell_tables(self, dtype):
        """The (D, n_rows) ELL of this matrix: values in ``dtype`` and int32
        columns (padding: value 0, column 0)."""
        if self._row_sum is None:
            self._row_sum = SegmentSum.build(_host(self.rows), self.shape[0], self.vals.device)
        if self._ell is None:
            t = self._row_sum.table
            cols_ext = torch.cat([self.cols, self.cols.new_zeros(1)])
            vals_ext = torch.cat([self.vals, self.vals.new_zeros(1)])
            self._ell = (vals_ext[t], cols_ext[t].contiguous())
        vals, cols = self._ell
        return vals.to(dtype).contiguous(), cols

    def _ell_block(self, dtype, c: int):
        """The (D, c n) ELL of I_c (x) A: copy j of the table reads the
        j-th n_src-long block of its operand (c = 1: the ELL itself)."""
        if c == 1:
            return self._ell_tables(dtype)
        key = (dtype, c)
        if key not in self._ell_blocks:
            vals, cols = self._ell_tables(dtype)
            step = torch.arange(c, dtype=torch.int32, device=cols.device) * self.shape[1]
            self._ell_blocks[key] = (
                vals.repeat(1, c).contiguous(),
                (cols[:, None, :] + step[None, :, None]).reshape(cols.shape[0], -1).contiguous(),
            )
        return self._ell_blocks[key]

    def _block_columns(self, dtype, k: int) -> int:
        """Columns per launch of A @ X for an (n_src, k) X."""
        n, n_src = self.shape
        D = self._ell_tables(dtype)[0].shape[0]
        return max(1, min(k, _BLOCK_ENTRIES // max(1, D * n), _INT32_MAX // max(1, n_src)))

    def __matmul__(self, x):
        x = torch.as_tensor(x, device=self.vals.device)
        dtype = torch.promote_types(self.vals.dtype, x.dtype)
        n, n_src = self.shape
        X = x.to(dtype).reshape(n_src, -1)  # a vector is a one-column block
        k = X.shape[1]
        c = self._block_columns(dtype, k)
        xt = X.T.contiguous()  # (k, n_src): column j of X is row j
        out = []
        for j in range(0, k, c):
            cj = min(c, k - j)
            vals, cols = self._ell_block(dtype, cj)
            out.append(ell_spmv(vals, cols, xt[j:j + cj].reshape(-1)).reshape(cj, n))
        y = out[0] if len(out) == 1 else torch.cat(out)
        return y.T if x.dim() == 2 else y.reshape(-1)

    def matmul_reference(self, x):
        """Plain PyTorch A @ x (vector or (n_src, k) block): the row's
        entries gathered, multiplied and summed; the oracle of ``@``."""
        x = torch.as_tensor(x, device=self.vals.device)
        dtype = torch.promote_types(self.vals.dtype, x.dtype)
        vals, cols = self._ell_tables(dtype)
        if x.dim() == 2:
            return (vals[:, :, None] * x.to(dtype)[cols.long()]).sum(0)
        return (vals * x.to(dtype)[cols.long()]).sum(0)

    def row_sums(self, vals=None):
        """Each row's sum of ``vals`` (this matrix's values by default; any
        (nnz,) tensor on its pattern), added in column order."""
        self._ell_tables(self.vals.dtype)  # builds the row layout once
        return self._row_sum(self.vals if vals is None else vals)

    def rmatvec(self, x):
        """x @ A, i.e. A^T applied to x."""
        return self.T @ x

    @property
    def T(self) -> "SparseMatrix":
        if self._T is None:
            # re-sort by (col, row); host-side ordering, values on the device
            order = np.lexsort((_host(self.rows), _host(self.cols)))
            idx = torch.as_tensor(order, device=self.vals.device)
            self._T = SparseMatrix(self.cols[idx], self.rows[idx], self.vals[idx],
                                   (self.shape[1], self.shape[0]))
        return self._T

    def diagonal(self):
        """(n_rows,) diagonal (0 where the pattern has no diagonal entry)."""
        on_diag = self.rows == self.cols
        d = torch.zeros(self.shape[0], dtype=self.vals.dtype, device=self.vals.device)
        d[self.rows[on_diag].long()] = self.vals[on_diag]  # one entry per row: no sums
        return d

    def with_vals(self, vals) -> "SparseMatrix":
        return SparseMatrix(self.rows, self.cols, vals, self.shape, _row_sum=self._row_sum)

    def __add__(self, other: "SparseMatrix") -> "SparseMatrix":
        if self.shape != other.shape:
            raise ValueError(f"shapes differ: {self.shape} and {other.shape}")
        return SparseMatrix.from_coo(
            torch.cat([self.rows, other.rows]),
            torch.cat([self.cols, other.cols]),
            torch.cat([self.vals, other.vals]),
            self.shape,
        )

    def __sub__(self, other: "SparseMatrix") -> "SparseMatrix":
        return self + (other * -1.0)

    def __mul__(self, s) -> "SparseMatrix":
        return self.with_vals(self.vals * s)

    __rmul__ = __mul__

    def scale_rows(self, d) -> "SparseMatrix":
        d = torch.as_tensor(d, device=self.vals.device)
        return self.with_vals(self.vals * d[self.rows.long()])

    def scale_cols(self, d) -> "SparseMatrix":
        d = torch.as_tensor(d, device=self.vals.device)
        return self.with_vals(self.vals * d[self.cols.long()])

    # -- export -------------------------------------------------------------
    def toarray(self) -> np.ndarray:
        vals = _host(self.vals)
        out = np.zeros(self.shape, dtype=vals.dtype)
        np.add.at(out, (_host(self.rows), _host(self.cols)), vals)
        return out

    def to_scipy(self):
        from scipy.sparse import coo_matrix

        return coo_matrix(
            (_host(self.vals), (_host(self.rows), _host(self.cols))), shape=self.shape
        ).tocsr()

    def __repr__(self):
        return f"SparseMatrix(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
