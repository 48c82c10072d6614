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
- ``A @ x`` and ``A @ X`` for an (n_src, k) block run on K2's sliced
  form (``ops/gather_spmv.SlicedELL``, built once per pattern on the
  device from the sorted COO and shared by ``with_vals``): each row's
  entries in column order, summed by one thread slot after slot, each
  slice of 32 rows padded only to its own longest row. A block is read in
  place through its strides, the table once per launch for all k columns,
  and each column equals the vector product of that column bitwise.
  ``matmul_reference`` is the plain gather-multiply-sum of either form,
  the oracle the products are held to.

Gradients. JAX differentiates its ``segment_sum`` product for free; K2
records no graph. So where ``vals`` or the operand requires grad (and grad
mode is on), ``@`` runs through ``SparseProduct``, an autograd Function
whose inputs are the values and the operand: the gradient with respect to
the operand is A^T G on K2's sliced form of the transpose (``T``, whose
sort and layout are built once per pattern and shared by every
``with_vals``), the one with respect to the values G[rows] X[cols] (summed
over a block's columns; plain torch, as JAX's is XLA). The backward calls
the same Function, so double backward works. Without such an input the
product is the plain launch, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gather_spmv
from ..ops.gather_spmv import SlicedELL

__all__ = ["SegmentSum", "SparseMatrix", "SparseProduct", "coo_sum_duplicates"]


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

    def __init__(self, rows, cols, vals, shape, _pattern: list | None = None,
                 _transpose: list | None = None):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.shape = tuple(int(s) for s in shape)
        # [SlicedELL pattern or None]: the rows' sliced layout, built at the
        # first product and shared by every with_vals of this matrix
        self._pattern = [None] if _pattern is None else _pattern
        # [None or (order, rows, cols, pattern list, own transpose list)]:
        # the transpose's entry order (vals[order] are its values), its
        # pattern and its sliced layout, shared by every with_vals
        self._transpose = [None] if _transpose is None else _transpose
        self._sliced = {}  # dtype -> SlicedELL with this matrix's values
        self._T = None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "SparseMatrix":
        """Build from possibly-duplicated COO triplets (duplicates summed),
        on vals' device (host vals go to the card)."""
        vals = _as_device_tensor(vals)
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

    def sliced(self, dtype=None) -> SlicedELL:
        """The sliced ELL the products launch, values in ``dtype`` (this
        matrix's by default)."""
        dtype = self.vals.dtype if dtype is None else dtype
        if dtype not in self._sliced:
            vals = self.vals.detach().to(dtype)
            if self._pattern[0] is None:
                A = SlicedELL.from_coo(self.rows, self.cols, vals, self.shape)
                self._pattern[0] = A.pattern()
            else:
                A = self._pattern[0].with_vals(vals)
            self._sliced[dtype] = A
        return self._sliced[dtype]

    def __matmul__(self, x):
        """A @ x for an (n_src,) vector or an (n_src, k) block, on K2;
        through ``SparseProduct`` where the values or x require grad."""
        x = torch.as_tensor(x, device=self.vals.device)
        dtype = torch.promote_types(self.vals.dtype, x.dtype)
        if torch.is_grad_enabled() and (self.vals.requires_grad or x.requires_grad):
            return SparseProduct.apply(self.vals.to(dtype), x.to(dtype), self)
        return self.sliced(dtype) @ x.to(dtype)

    def matmul_reference(self, x):
        """Plain PyTorch A @ x (vector or (n_src, k) block): the row's
        entries gathered, multiplied and summed; the oracle of ``@``."""
        x = torch.as_tensor(x, device=self.vals.device)
        dtype = torch.promote_types(self.vals.dtype, x.dtype)
        n, dev = self.shape[0], self.vals.device
        if self.nnz == 0:
            return torch.zeros((n,) + tuple(x.shape[1:]), dtype=dtype, device=dev)
        ptr = torch.searchsorted(self.rows.long(), torch.arange(n + 1, device=dev))
        lens = ptr[1:] - ptr[:-1]
        q = torch.arange(int(lens.max()), device=dev)[:, None]
        live = q < lens[None, :]
        idx = torch.where(live, ptr[:-1][None, :] + q, 0)  # (D, n) ELL of entry ids
        vals = torch.where(live, self.vals.to(dtype)[idx], 0.0)
        X = x.to(dtype)[self.cols[idx].long()]
        if x.dim() == 2:
            return (vals[:, :, None] * X).sum(0)
        return (vals * X).sum(0)

    def row_sums(self, vals=None):
        """Each row's sum of ``vals`` (this matrix's values by default; any
        (nnz,) tensor on its pattern), added in column order: the product
        with a vector of ones, each slot adding v * 1 = v exactly."""
        M = self if vals is None else self.with_vals(vals)
        return M @ torch.ones(self.shape[1], dtype=M.vals.dtype, device=M.vals.device)

    def rmatvec(self, x):
        """x @ A, i.e. A^T applied to x."""
        return self.T @ x

    def transpose_order(self) -> torch.Tensor:
        """(nnz,) int64: the transpose's entries are this matrix's entries
        in this order. Built once per pattern (a stable device sort)."""
        if self._transpose[0] is None:
            # rows are sorted, so a stable sort by column gives (col, row)
            # order, on the device
            order = torch.sort(self.cols, stable=True).indices
            back = torch.empty_like(order).index_put_(
                (order,), torch.arange(order.shape[0], device=order.device))
            own = [None]
            self._transpose[0] = (order, self.cols[order], self.rows[order], [None], own)
            # the transpose's transpose is this pattern
            own[0] = (back, self.rows, self.cols, self._pattern, self._transpose)
        return self._transpose[0][0]

    def transpose_with(self, vals_t) -> "SparseMatrix":
        """The transpose with ``vals_t`` (nnz,) in its entry order (this
        matrix's values gathered by ``transpose_order``), on the shared
        transposed pattern."""
        self.transpose_order()
        _, rows, cols, pattern, tpose = self._transpose[0]
        return SparseMatrix(rows, cols, vals_t, (self.shape[1], self.shape[0]),
                            _pattern=pattern, _transpose=tpose)

    @property
    def T(self) -> "SparseMatrix":
        if self._T is None:
            self._T = self.transpose_with(self.vals[self.transpose_order()])
        return self._T

    def diagonal(self):
        """(n_rows,) diagonal (0 where the pattern has no diagonal entry)."""
        on_diag = self.rows == self.cols
        d = torch.zeros(self.shape[0], dtype=self.vals.dtype, device=self.vals.device)
        d[self.rows[on_diag].long()] = self.vals[on_diag]  # one entry per row: no sums
        return d

    def with_vals(self, vals) -> "SparseMatrix":
        return SparseMatrix(self.rows, self.cols, vals, self.shape, _pattern=self._pattern,
                            _transpose=self._transpose)

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


class SparseProduct(torch.autograd.Function):
    """Y = A X on K2 with gradients: ``apply(vals, X, A[, backward])``, vals
    (nnz,) the values of the ``SparseMatrix`` A's pattern in X's dtype
    (equal to A.vals), X an (n_src,) vector or (n_src, k) block;
    ``backward`` counts the launch as a backward's.

    Backward: dX = A^T G on the transpose's sliced form (A.T's, cached,
    when vals is A.vals and no graph over vals is asked for), through this
    Function again under ``create_graph``; dvals = G[rows] X[cols], summed
    over a block's columns."""

    @staticmethod
    def forward(ctx, vals, X, A, backward=False):
        ctx.A, ctx.own = A, vals is A.vals
        ctx.save_for_backward(vals, X)
        S = A.sliced(vals.dtype) if ctx.own else A.with_vals(vals).sliced(vals.dtype)
        return gather_spmv.sliced_ell_spmm(S, X, backward=backward)

    @staticmethod
    def backward(ctx, G):
        vals, X = ctx.saved_tensors
        A = ctx.A
        d_vals = d_X = None
        if ctx.needs_input_grad[1]:
            graph = torch.is_grad_enabled()
            if ctx.own and not (graph and vals.requires_grad):
                At = A.T
            else:
                At = A.transpose_with(vals[A.transpose_order()])
            if graph and (At.vals.requires_grad or G.requires_grad):
                d_X = SparseProduct.apply(At.vals, G, At, True)
            else:
                d_X = gather_spmv.sliced_ell_spmm(At.sliced(), G, backward=True)
        if ctx.needs_input_grad[0]:
            prod = G[A.rows.long()] * X[A.cols.long()]
            d_vals = prod.sum(1) if prod.dim() == 2 else prod
        return d_vals, d_X, None, None


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _as_device_tensor(a, device="cuda") -> torch.Tensor:
    """A tensor as it is; host input (NumPy, lists, scalars) on ``device``,
    the card by default, as JAX's ``jnp.asarray`` puts it on the
    accelerator."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a), device=device)
