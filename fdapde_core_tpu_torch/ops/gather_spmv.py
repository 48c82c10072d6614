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
"""

from __future__ import annotations

import torch

__all__ = ["LaneRoutedELL", "ell_spmv", "ell_spmv_reference"]

# kernel launches since import (or since a caller last reset it to 0)
ell_spmv_launches = 0

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
