"""ELL gather SpMV (K2) and the ``LaneRoutedELL`` operator built on it.

Port of ``fdapde_core_tpu/ops/pallas_gather_spmv.py``. On the TPU the
SpMV of a scattered-band matrix (the numbering ``plan_split_width``
rejects: imported meshes after RCM, P2 numberings, block-scrambled
relabellings) had to be composed out of 128-lane shuffles driven by
precomputed routing tables (``schedule_lane_routed``), with a COO
remainder and a 16384-wide band limit. A GPU thread gathers from anywhere,
so the port keeps what ``_spmv`` computes and drops the routing:

- ``ell_spmv(vals, cols, x)`` is the kernel wrapper. On a CUDA tensor it
  launches the hand-written kernel ``csrc/ell_spmv.cu`` (built at first
  use, see ``_build.py``) and counts the launch in ``ell_spmv_launches``;
  on a CPU tensor it runs the plain version ``ell_spmv_reference``.
- ``LaneRoutedELL`` keeps the JAX class's contract (``from_ell``, ``@``,
  ``diagonal``, ``astype``, ``shape``, ``with_vals``, ``n_src``,
  ``n_remainder``) over the assembled (K, n) table itself. The routing
  arguments of ``from_ell`` are accepted and ignored, nothing falls to a
  remainder (``n_remainder == 0``), and neither the 16384 band limit nor
  the rectangular window limit applies.

The same wrapper serves ``ops/matfree_soa.ELLSoA.__matmul__``.

K2's second form serves every ``SparseMatrix`` product and the aux grid's
P^T: ``SlicedELL``, a sliced ELL (SELL-C-sigma) that pads each slice of 32
rows only to its own longest row, with ``sliced_ell_spmm(A, X)`` as its
wrapper (a vector, or an (n_src, k) block read in place through its
strides; the kernel is the second family of ``csrc/ell_spmv.cu``) and
``sliced_ell_spmm_reference`` as its plain version. Both forms count their
launches in ``ell_spmv_launches``.
"""

from __future__ import annotations

import torch

__all__ = ["LaneRoutedELL", "SlicedELL", "ell_spmv", "ell_spmv_reference", "sliced_ell_spmm",
           "sliced_ell_spmm_reference"]

# kernel launches of either form since import (or since a caller last reset
# it to 0)
ell_spmv_launches = 0

SLICE = 32  # rows per slice of a SlicedELL: the lanes of a warp (kC in the source)
# rows are sorted by length within windows of this many positions before
# they are cut into slices (1: no sort)
SLICE_SORT_WINDOW = 256

# value dtype -> accumulation (x and y) dtype the kernel takes
_ACC = {
    torch.float32: torch.float32,
    torch.float64: torch.float64,
    torch.bfloat16: torch.float32,
}


def accumulation_dtype(vals_dtype, x_dtype=None):
    """The dtype y = A x is computed in: the value type's accumulation type
    (float32 for bfloat16 tables), promoted with x's dtype when given."""
    if vals_dtype not in _ACC:
        raise TypeError(f"ELL values must be float32, float64 or bfloat16, got {vals_dtype}")
    acc = _ACC[vals_dtype]
    return acc if x_dtype is None else torch.promote_types(acc, x_dtype)


def ell_spmv_reference(vals, cols, x):
    """Plain PyTorch version: y = sum_k vals[k] * x[cols[k]], one gather per
    slot, accumulated in x's dtype (bfloat16 values widened per product)."""
    K, n = vals.shape
    acc = None
    for k in range(K):
        t = vals[k].to(x.dtype) * x[cols[k]]
        acc = t if acc is None else acc + t
    if acc is None:
        return torch.zeros(n, dtype=x.dtype, device=x.device)
    return acc


def _check(vals, cols, x):
    if vals.dim() != 2:
        raise ValueError(f"vals must be (K, n), got shape {tuple(vals.shape)}")
    acc = accumulation_dtype(vals.dtype)
    if cols.dtype != torch.int32 or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(
            f"cols must be int32 of vals' shape {tuple(vals.shape)}, got "
            f"{cols.dtype} {tuple(cols.shape)}"
        )
    if x.dim() != 1 or x.dtype != acc:
        raise ValueError(f"x must be 1-D {acc} for {vals.dtype} values, got {x.dtype} {tuple(x.shape)}")
    if not (vals.is_contiguous() and cols.is_contiguous() and x.is_contiguous()):
        raise ValueError("vals, cols and x must be contiguous")
    if cols.device != vals.device or x.device != vals.device:
        raise ValueError("vals, cols and x must share a device")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vals.device}")
    return acc


def ell_spmv(vals, cols, x):
    """y = A x for a slot-major (K, n) ELL: ``vals`` float32, float64 or
    bfloat16; ``cols`` int32, every entry in [0, len(x)); ``x`` contiguous
    in the accumulation dtype (float32 for float32 and bfloat16 values,
    float64 for float64). Returns a new (n,) tensor of x's dtype."""
    global ell_spmv_launches
    acc = _check(vals, cols, x)
    K, n = vals.shape
    if vals.device.type == "cpu":
        return ell_spmv_reference(vals, cols, x)

    from .._build import library

    y = torch.empty(n, dtype=acc, device=vals.device)
    if n == 0:
        return y
    lib = library()
    fn = {
        torch.float32: lib.ell_spmv_f32,
        torch.float64: lib.ell_spmv_f64,
        torch.bfloat16: lib.ell_spmv_bf16,
    }[vals.dtype]
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), K, n, stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: cudaError {err}")
    ell_spmv_launches += 1
    return y


class SlicedELL:
    """An (n, n_src) sparse matrix as a sliced ELL, the layout of K2's
    second form (see ``csrc/ell_spmv.cu``).

    Position p holds row ``perm[p]`` (``perm`` None: row p). Positions are
    cut into slices of ``SLICE``; slice s holds ``slice_w[s]`` slots, slot-
    major from ``slice_off[s]``: slot q of the row at lane l is entry
    ``slice_off[s] + q * SLICE + l`` of ``vals`` and ``cols``, padded with
    value 0, column 0. ``dest`` maps each entry of the COO the matrix was
    built from to its slot, so ``with_vals`` lays out new values on the same
    pattern."""

    def __init__(self, vals, cols, slice_off, slice_w, perm, dest, shape, width: int):
        self.vals = vals  # (slots,) float32 or float64
        self.cols = cols  # (slots,) int32
        self.slice_off = slice_off  # (n_slices + 1,) int64, entries before each slice
        self.slice_w = slice_w  # (n_slices,) int32
        self.perm = perm  # (n,) int32 or None
        self.dest = dest  # (nnz,) int64
        self.shape = tuple(int(s) for s in shape)
        self.width = width  # the longest row

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, sigma: int = SLICE_SORT_WINDOW) -> "SlicedELL":
        """The layout of a COO matrix whose rows are sorted and each row's
        entries in the order they are to be summed (``SparseMatrix``'s
        order), built on vals' device with no host round trip but the sizes.
        ``sigma`` (1 or a multiple of ``SLICE``): rows are sorted by length,
        longest first, within windows of ``sigma`` positions (stable), where
        that cuts the slots the kernel reads by at least 1/8: the sort
        scatters each window's writes of y, which a small cut does not
        repay (on Psi^T, wider windows that cut the slots by another 12 %
        ran slower, PERF.md section 6)."""
        if sigma != 1 and sigma % SLICE:
            raise ValueError(f"sigma must be 1 or a multiple of {SLICE}, got {sigma}")
        n, n_src = (int(s) for s in shape)
        dev = vals.device
        rows = rows.to(device=dev, dtype=torch.int64)
        ptr = torch.searchsorted(rows, torch.arange(n + 1, device=dev))
        lens = ptr[1:] - ptr[:-1]
        n_slices = -(-n // SLICE)

        def widths(pos_lens):
            padded = torch.zeros(n_slices * SLICE, dtype=torch.int64, device=dev)
            padded[:n] = pos_lens
            return padded.reshape(n_slices, SLICE).amax(1)

        perm, slice_w = None, widths(lens)
        if sigma > 1 and n > 0:
            key = torch.arange(n, device=dev) // sigma * (n + 1) + (n - lens)
            order = torch.sort(key, stable=True).indices
            sorted_w = widths(lens[order])
            if 8 * int(sorted_w.sum()) <= 7 * int(slice_w.sum()):
                perm, slice_w = order, sorted_w
        slice_off = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
        slice_off[1:] = torch.cumsum(slice_w * SLICE, 0)
        n_slots = int(slice_off[-1])
        pos = torch.arange(n, device=dev)
        if perm is not None:
            pos = torch.empty_like(pos).index_put_((perm,), pos)  # row -> position
        p = pos[rows]
        q = torch.arange(rows.shape[0], device=dev) - ptr[rows]
        dest = slice_off[p // SLICE] + q * SLICE + p % SLICE
        scols = torch.zeros(n_slots, dtype=torch.int32, device=dev).index_put_(
            (dest,), cols.to(device=dev, dtype=torch.int32))
        A = cls(None, scols, slice_off, slice_w.to(torch.int32),
                None if perm is None else perm.to(torch.int32), dest, (n, n_src),
                int(lens.max()) if n else 0)
        return A.with_vals(vals)

    def with_vals(self, vals) -> "SlicedELL":
        """The matrix with ``vals`` (nnz,) on this pattern (float32 or float64)."""
        if vals.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"sliced ELL values must be float32 or float64, got {vals.dtype}")
        svals = torch.zeros(self.cols.shape[0], dtype=vals.dtype, device=self.cols.device)
        svals.index_put_((self.dest,), vals.to(self.cols.device))
        return SlicedELL(svals, self.cols, self.slice_off, self.slice_w, self.perm, self.dest,
                         self.shape, self.width)

    def pattern(self) -> "SlicedELL":
        """This layout without its values (for ``with_vals``)."""
        return SlicedELL(None, self.cols, self.slice_off, self.slice_w, self.perm, self.dest,
                         self.shape, self.width)

    def padding_ratio(self) -> float:
        """Slots the kernel reads per entry: every row's slice width (the
        positions past the last row of a partial slice are never read)."""
        w = self.slice_w.long()
        if w.numel() == 0:
            return 1.0
        read = SLICE * int(w.sum()) - (w.numel() * SLICE - self.shape[0]) * int(w[-1])
        return read / max(1, self.dest.shape[0])

    def __matmul__(self, X):
        return sliced_ell_spmm(self, X)


def _check_sliced(A, X):
    if A.vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sliced ELL values must be float32 or float64, got {A.vals.dtype}")
    if X.dtype != A.vals.dtype:
        raise ValueError(f"X must be {A.vals.dtype} like the values, got {X.dtype}")
    if X.dim() not in (1, 2) or X.shape[0] != A.shape[1]:
        raise ValueError(f"X must be ({A.shape[1]},) or ({A.shape[1]}, k), got {tuple(X.shape)}")
    if X.device != A.vals.device:
        raise ValueError("the matrix and X must share a device")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")


def _sliced_out(X, n):
    """Y for Y = A X, laid out as X is: a block whose rows are its
    unit-stride axis gets rows as Y's unit-stride axis too."""
    if X.dim() == 1:
        return X.new_empty(n)
    k = X.shape[1]
    if X.stride(0) == 1 and k > 1:
        return X.new_empty((k, n)).T
    return X.new_empty((n, k))


def sliced_ell_spmm_reference(A, X):
    """Plain PyTorch version of ``sliced_ell_spmm``: slot after slot, the
    slot's value times X's row at its column added to every position's sum
    (a slot past a slice's width adds nothing), then each position's sum
    put in its row."""
    n = A.shape[0]
    dev = A.vals.device
    p = torch.arange(n, device=dev)
    s = p // SLICE
    w = A.slice_w.long()[s]
    base = A.slice_off[s] + p % SLICE
    acc = X.new_zeros((n,) + tuple(X.shape[1:]))
    for q in range(A.width):
        live = q < w
        idx = torch.where(live, base + q * SLICE, 0)
        a = A.vals[idx]
        t = (a[:, None] if X.dim() == 2 else a) * X[A.cols[idx].long()]
        acc = acc + torch.where(live[:, None] if X.dim() == 2 else live, t, 0.0)
    if A.perm is None:
        return acc
    return torch.empty_like(acc).index_put_((A.perm.long(),), acc)


def sliced_ell_spmm(A, X):
    """Y = A X for a ``SlicedELL`` A and an (n_src,) vector or (n_src, k)
    block X of A's dtype, read where it lies through its strides (no copy).
    Returns a new (n,) or (n, k) tensor; a block is laid out as X is. On a
    CUDA tensor it launches the kernel (``csrc/ell_spmv.cu``, sell_spmm) and
    counts the launch in ``ell_spmv_launches``; on a CPU tensor it runs the
    plain version."""
    global ell_spmv_launches
    _check_sliced(A, X)
    if X.device.type == "cpu":
        return sliced_ell_spmm_reference(A, X)

    from .._build import library

    n = A.shape[0]
    Y = _sliced_out(X, n)
    k = 1 if X.dim() == 1 else X.shape[1]
    if n == 0 or k == 0:
        return Y
    sxr = X.stride(0)
    sxc = 0 if X.dim() == 1 else X.stride(1)
    syr = Y.stride(0)
    syc = 0 if Y.dim() == 1 else Y.stride(1)
    lib = library()
    fn = lib.sell_spmm_f32 if A.vals.dtype == torch.float32 else lib.sell_spmm_f64
    perm = None if A.perm is None else A.perm.data_ptr()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(A.vals.data_ptr(), A.cols.data_ptr(), A.slice_off.data_ptr(),
                 A.slice_w.data_ptr(), perm, n, X.data_ptr(), sxr, sxc, Y.data_ptr(), syr, syc,
                 k, stream)
    if err != 0:
        raise RuntimeError(f"sliced ELL kernel launch failed: cudaError {err}")
    ell_spmv_launches += 1
    return Y


def _square_diagonal(E):
    """E's diagonal when E is square; zeros for a rectangular operator."""
    n_rows, n_src = E.shape
    if n_src == n_rows:
        return E.diagonal()
    return torch.zeros(n_rows, dtype=E.vals.dtype, device=E.vals.device)


class LaneRoutedELL:
    """Operator protocol (@, diagonal, astype, shape) over an assembled
    (K, n) ELL, applied by the K2 kernel. Build with ``from_ell``."""

    def __init__(self, vals, cols, diag, n: int, n_src: int | None = None,
                 keep_remap: bool = False):
        self.vals = vals  # (K, n) float32, float64 or bfloat16
        self.cols = cols  # (K, n) int32
        self._diag = diag
        self.n = n
        self.n_src = n if n_src is None else n_src
        self.n_remainder = 0  # no routing, so nothing falls to a remainder
        self._keep_remap = keep_remap

    @property
    def shape(self):
        return (self.n, self.n_src)

    @classmethod
    def from_ell(cls, E, p_max=None, rounds: int = 16, bandwidth=None,
                 keep_remap: bool = False, fuse=None):
        """Operator over E's table (no copy). ``p_max``, ``rounds``,
        ``bandwidth`` and ``fuse`` tune the TPU routing schedule and are
        ignored. ``keep_remap`` enables ``with_vals``. Raises ValueError
        when a column lies outside [0, n_src)."""
        n_rows, n_src = E.shape
        accumulation_dtype(E.vals.dtype)
        if E.cols.numel() and (int(E.cols.min()) < 0 or int(E.cols.max()) >= n_src):
            raise ValueError(f"ELL columns must lie in [0, {n_src})")
        return cls(E.vals.contiguous(), E.cols.contiguous(), _square_diagonal(E), n_rows,
                   n_src=n_src, keep_remap=keep_remap)

    def __matmul__(self, v):
        if v.shape != (self.n_src,):
            raise ValueError(f"operand must be ({self.n_src},), got {tuple(v.shape)}")
        acc = accumulation_dtype(self.vals.dtype)
        return ell_spmv(self.vals, self.cols, v.to(acc).contiguous())

    def with_vals(self, E):
        """The operator with E's values on this operator's sparsity (E must
        have the same cols: reaction- or mass-augmented, re-coefficiented
        or time-stepping matrices). Requires ``from_ell(...,
        keep_remap=True)``."""
        if not self._keep_remap:
            raise ValueError(
                "schedule remap not retained: build the base operator "
                "with from_ell(..., keep_remap=True)"
            )
        if tuple(E.shape) != self.shape or not torch.equal(E.cols, self.cols):
            raise ValueError("E must have this operator's shape and cols")
        return LaneRoutedELL(E.vals.contiguous(), self.cols, _square_diagonal(E), self.n,
                             n_src=self.n_src, keep_remap=True)

    def diagonal(self):
        return self._diag

    def astype(self, dtype):
        return LaneRoutedELL(self.vals.to(dtype), self.cols, self._diag.to(dtype),
                             self.n, n_src=self.n_src)
