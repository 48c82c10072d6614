"""ELL gather SpMV (K2), ``ELLSoA`` (the one owner of its compact form's
product) and ``LaneRoutedELL`` (JAX's name for it).

Port of ``fdapde_core_tpu/ops/pallas_gather_spmv.py``. On the TPU the
SpMV of a scattered-band matrix (the numbering ``plan_split_width``
rejects: imported meshes after RCM, P2 numberings, block-scrambled
relabellings) had to be composed out of 128-lane shuffles driven by
precomputed routing tables (``schedule_lane_routed``), with a COO
remainder and a 16384-wide band limit. A GPU thread gathers from anywhere,
so the port keeps what ``_spmv`` computes and drops the routing:

- ``ell_spmv(vals, cols, x, warp_w)`` is the kernel wrapper. On a CUDA
  tensor it launches the hand-written kernel ``csrc/ell_spmv.cu`` (built
  at first use, see ``_build.py``) and counts the launch in
  ``ell_spmv_launches``; on a CPU tensor it runs the plain version
  ``ell_spmv_reference``. ``warp_w`` (``ell_warp_widths``) gives each
  group of 32 rows the slots its widest row uses, so the kernel reads the
  table in place without its padding (SELL-32 with no sort); tables built
  with at most one entry per (row, col) carry them (``to_ell``,
  ``ELLMatrix.from_local``), computed once per pattern and shared by the
  operators made from them; any other table reads all K slots.
- ``ELLSoA`` is the (K, n) table as an operator, and every compact product
  of the package goes through it: the assembled ELLs (``to_ell``), the
  banded splits' remainders, ``ELLMatrix`` (a view of one ``ELLSoA``),
  ``LaneRoutedELL``, ``WindowedELL``'s stacked windows, the aux grid's P
  and the shards of ``parallel.HaloELLSolver`` / ``HaloLaneSolver``. It
  alone decides the dtype a product is computed in (``__matmul__``).
- ``LaneRoutedELL`` keeps the JAX class's contract (``from_ell``, ``@``,
  ``diagonal``, ``astype``, ``shape``, ``with_vals``, ``n_src``,
  ``n_remainder``) over the assembled (K, n) table itself. The routing
  arguments of ``from_ell`` are accepted and ignored, nothing falls to a
  remainder (``n_remainder == 0``), and neither the 16384 band limit nor
  the rectangular window limit applies.

K2's second form serves every ``SparseMatrix`` product and the aux grid's
P^T: ``SlicedELL``, a sliced ELL (SELL-C-sigma) that pads each slice of 32
rows only to its own longest row, with ``sliced_ell_spmm(A, X)`` as its
wrapper (a vector, or an (n_src, k) block read in place through its
strides; the kernel is the second family of ``csrc/ell_spmv.cu``) and
``sliced_ell_spmm_reference`` as its plain version. Both forms count their
launches in ``ell_spmv_launches``.
"""

from __future__ import annotations

import copy

import torch

__all__ = ["ELLSoA", "LaneRoutedELL", "SlicedELL", "ell_row_widths", "ell_spmv",
           "ell_spmv_reference", "ell_warp_widths", "sliced_ell_spmm", "sliced_ell_spmm_reference",
           "warp_widths"]

# kernel launches of either form since import (or since a caller last reset
# it to 0)
ell_spmv_launches = 0
# those of them made for the backward of a differentiable SparseMatrix
# product (linear_algebra.sparse.SparseProduct: ``backward=True``)
ell_spmv_backward_launches = 0
# compact launches with float32 values on a float64 x (widened per product)
ell_spmv_widened_launches = 0

# the lanes of a warp (kC in the source): the rows of each entry of a
# compact table's warp widths, and of each slice of a SlicedELL
WARP = SLICE = 32
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


def ell_row_widths(cols):
    """Each row's width in a compact (K, n) table whose padding is (col =
    row, val = 0) after the row's entries: 1 + max(the last slot whose col
    != row, the first slot whose col == row), as (n,) int32. It reads cols
    only, so tables that keep cols (new values, another dtype, an added
    diagonal) share it, and a real diagonal whose value is 0 is never cut
    off. It holds for a table with at most one entry per (row, col), as
    every merged table is."""
    K, n = cols.shape
    rows = torch.arange(n, dtype=cols.dtype, device=cols.device)
    last_off = torch.zeros(n, dtype=torch.int32, device=cols.device)
    first_on = torch.zeros_like(last_off)
    for k in range(K):
        on = cols[k] == rows
        last_off = torch.where(on, last_off, k + 1)
        first_on = torch.where(on & (first_on == 0), k + 1, first_on)
    return torch.maximum(last_off, first_on)


def warp_widths(row_w):
    """(ceil(n / 32),) int32: the widest of each 32 consecutive rows of the
    (n,) row widths, the kernel's slot count for that warp."""
    padded = torch.nn.functional.pad(row_w, (0, -row_w.shape[0] % WARP))
    return padded.reshape(-1, WARP).amax(1).to(torch.int32).contiguous()


def ell_warp_widths(cols):
    """The warp widths of a compact table's pattern (``ell_row_widths``)."""
    return warp_widths(ell_row_widths(cols))


def ell_spmv_reference(vals, cols, x):
    """Plain PyTorch version: y = sum_k vals[k] * x[cols[k]] over all K
    slots, one gather per slot, accumulated in x's dtype (bfloat16 and
    float32 values widened per product)."""
    K, n = vals.shape
    acc = None
    for k in range(K):
        t = vals[k].to(x.dtype) * x[cols[k]]
        acc = t if acc is None else acc + t
    if acc is None:
        return torch.zeros(n, dtype=x.dtype, device=x.device)
    return acc


def _check(vals, cols, x, warp_w):
    if vals.dim() != 2:
        raise ValueError(f"vals must be (K, n), got shape {tuple(vals.shape)}")
    acc = accumulation_dtype(vals.dtype)
    if vals.dtype == torch.float32 and x.dtype == torch.float64:
        acc = torch.float64  # widened per product, summed in float64
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
    if warp_w is not None:
        n_warps = -(-vals.shape[1] // WARP)
        if warp_w.dtype != torch.int32 or tuple(warp_w.shape) != (n_warps,):
            raise ValueError(f"warp_w must be int32 of shape ({n_warps},), got {warp_w.dtype} "
                             f"{tuple(warp_w.shape)}")
        if warp_w.device != vals.device or not warp_w.is_contiguous():
            raise ValueError("warp_w must be contiguous on vals' device")
    return acc


def ell_spmv(vals, cols, x, warp_w=None):
    """y = A x for a slot-major (K, n) ELL: ``vals`` float32, float64 or
    bfloat16; ``cols`` int32, every entry in [0, len(x)); ``x`` contiguous
    in the accumulation dtype (float32 for float32 and bfloat16 values,
    float64 for float64), or float64 for float32 values (widened per
    product). ``warp_w``: None (every row reads all K slots) or
    ``ell_warp_widths(cols)``-like (ceil(n / 32),) int32 widths, every slot
    at or past its warp's width holding value 0; the kernel then reads each
    warp's slots only up to its width, with the same result on finite x.
    Returns a new (n,) tensor of x's dtype."""
    global ell_spmv_launches, ell_spmv_widened_launches
    acc = _check(vals, cols, x, warp_w)
    K, n = vals.shape
    if vals.device.type == "cpu":
        return ell_spmv_reference(vals, cols, x)

    from .._build import library

    y = torch.empty(n, dtype=acc, device=vals.device)
    if n == 0:
        return y
    lib = library()
    fn = {
        (torch.float32, torch.float32): lib.ell_spmv_f32,
        (torch.float64, torch.float64): lib.ell_spmv_f64,
        (torch.bfloat16, torch.float32): lib.ell_spmv_bf16,
        (torch.float32, torch.float64): lib.ell_spmv_f32_f64,
    }[vals.dtype, acc]
    widths = None if warp_w is None else warp_w.data_ptr()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(vals.data_ptr(), cols.data_ptr(), widths, x.data_ptr(), y.data_ptr(), K, n,
                 stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: cudaError {err}")
    ell_spmv_launches += 1
    ell_spmv_widened_launches += acc != accumulation_dtype(vals.dtype)
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
        perm, slice_w = None, warp_widths(lens)
        if sigma > 1 and n > 0:
            key = torch.arange(n, device=dev) // sigma * (n + 1) + (n - lens)
            order = torch.sort(key, stable=True).indices
            sorted_w = warp_widths(lens[order])
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
        A = cls(None, scols, slice_off, slice_w,
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


def sliced_ell_spmm(A, X, backward: bool = False):
    """Y = A X for a ``SlicedELL`` A and an (n_src,) vector or (n_src, k)
    block X of A's dtype, read where it lies through its strides (no copy).
    Returns a new (n,) or (n, k) tensor; a block is laid out as X is. On a
    CUDA tensor it launches the kernel (``csrc/ell_spmv.cu``, sell_spmm) and
    counts the launch in ``ell_spmv_launches``, and with ``backward`` also in
    ``ell_spmv_backward_launches``; on a CPU tensor it runs the plain
    version."""
    global ell_spmv_launches, ell_spmv_backward_launches
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
    ell_spmv_backward_launches += backward
    return Y


class ELLSoA:
    """An (n, n_src) sparse matrix as a compact row-ELL in slot-major
    layout, the table of K2's compact form, and the one owner of its
    product. vals (K, n) float32, float64 or bfloat16 and cols (K, n) int32
    are kept contiguous; a row's padding carries col = row and val = 0 after
    its entries (no mask in the product). ``warp_w``: the pattern's warp
    widths (``ell_warp_widths``), given only for a table that holds at most
    one entry per (row, col) (``to_ell``, ``ELLMatrix.from_local``) and
    shared by every operator made from this one (``astype``,
    ``with_added_diagonal``, ``LaneRoutedELL``'s ``with_vals``); None reads
    all K slots.

    ``A @ x`` takes an (n_src,) x and computes y in
    ``accumulation_dtype(vals, x)``: float32 values on a float64 x go to the
    kernel's widening entry with no table copy, and the table is converted
    only where the kernel has no entry for the pair (bfloat16 values on a
    float64 x). The table passed to ``ell_spmv`` is the same tensor from
    product to product."""

    def __init__(self, vals, cols, shape, warp_w=None):
        self.vals = vals.contiguous()
        self.cols = cols.contiguous()
        self.shape = tuple(shape)
        self.warp_w = warp_w

    @property
    def dtype(self):
        """The dtype of a product on an operand of the table's own precision
        (float32 for bfloat16 values)."""
        return accumulation_dtype(self.vals.dtype)

    def __matmul__(self, x):
        if x.shape != (self.shape[1],):
            raise ValueError(f"operand must be ({self.shape[1]},), got {tuple(x.shape)}")
        acc = accumulation_dtype(self.vals.dtype, x.dtype)
        vals = self.vals
        if acc != self.dtype and vals.dtype != torch.float32:
            vals = vals.to(acc)
        return ell_spmv(vals, self.cols, x.to(acc).contiguous(), self.warp_w)

    def _with(self, vals):
        """This operator with new (K, n) values on its pattern: cols and
        warp widths shared."""
        E = copy.copy(self)
        E.vals = vals.contiguous()
        return E

    def diagonal(self):
        """The (n,) diagonal in the values' dtype; zeros for a rectangular
        operator."""
        n, n_src = self.shape
        if n != n_src:
            return torch.zeros(n, dtype=self.vals.dtype, device=self.vals.device)
        rows = torch.arange(n, dtype=self.cols.dtype, device=self.cols.device)
        return torch.where(self.cols == rows[None, :], self.vals, 0.0).sum(dim=0)

    def astype(self, dtype):
        return self._with(self.vals.to(dtype))

    def with_added_diagonal(self, d):
        """A + diag(d): only the first (row == col) slot of each row changes
        (padding also carries col = row, with val 0, after the real
        entries; the diagonal is always structurally present in FEM
        operators)."""
        rows = torch.arange(self.shape[0], dtype=self.cols.dtype, device=self.cols.device)
        isdiag = self.cols == rows[None, :]
        first = isdiag & (torch.cumsum(isdiag, dim=0) == 1)
        d = torch.as_tensor(d, device=self.vals.device)
        return self._with(self.vals + torch.where(first, d[None, :], 0.0))


class LaneRoutedELL(ELLSoA):
    """JAX's lane-routed operator: an ``ELLSoA`` over an assembled (K, n)
    ELL (its product, diagonal, astype and warp widths) under the JAX
    class's contract (``from_ell``, ``n``, ``n_src``, ``n_remainder``,
    ``with_vals``). Build with ``from_ell``."""

    n_remainder = 0  # no routing, so nothing falls to a remainder
    _keep_remap = False

    @property
    def n(self):
        return self.shape[0]

    @property
    def n_src(self):
        return self.shape[1]

    @classmethod
    def from_ell(cls, E, p_max=None, rounds: int = 16, bandwidth=None,
                 keep_remap: bool = False, fuse=None):
        """Operator over E's table (no copy) and E's warp widths (None:
        all K slots). ``p_max``, ``rounds``, ``bandwidth`` and
        ``fuse`` tune the TPU routing schedule and are ignored.
        ``keep_remap`` enables ``with_vals``. Raises ValueError when a
        column lies outside [0, n_src)."""
        n_src = E.shape[1]
        accumulation_dtype(E.vals.dtype)
        if E.cols.numel() and (int(E.cols.min()) < 0 or int(E.cols.max()) >= n_src):
            raise ValueError(f"ELL columns must lie in [0, {n_src})")
        op = cls(E.vals, E.cols, E.shape, E.warp_w)
        op._keep_remap = keep_remap
        return op

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
        return self._with(E.vals)
