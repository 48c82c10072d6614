"""Binary (boolean) matrices with expression-style operations.

Port of ``fdapde_core_tpu/linear_algebra/binary.py``, the counterpart of
fdaPDE-core's fdaPDE/linear_algebra/binary_matrix.h:32-667. The reference
bit-packs into uintmax_t words with an expression-template layer; here, as
in the JAX package, `BinaryMatrix` is a thin wrapper over a boolean array,
a torch bool tensor on a device (default "cuda"; the device of the tensor
it is given), providing the reference's API surface: logical ops, blocks,
repeat/reshape, visitors (all/any/count), and `select` masking of dense or
sparse operands.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BinaryMatrix", "BinaryVector"]


class BinaryMatrix:
    """Dense boolean matrix with the reference's operation surface."""

    def __init__(self, data, device=None):
        if isinstance(data, torch.Tensor):
            data = data.to(device=device or data.device, dtype=torch.bool)
        else:
            data = torch.as_tensor(np.asarray(data).astype(bool), device=device or "cuda")
        self.data = data

    # -- constructors (binary_matrix.h Ones/Zeros) ----------------------------
    @classmethod
    def ones(cls, *shape, device="cuda"):
        return cls(torch.ones(shape, dtype=torch.bool, device=device))

    @classmethod
    def zeros(cls, *shape, device="cuda"):
        return cls(torch.zeros(shape, dtype=torch.bool, device=device))

    @property
    def shape(self):
        return self.data.shape

    # -- bitwise expression ops ----------------------------------------------
    def __and__(self, o):
        return BinaryMatrix(self.data & o.data)

    def __or__(self, o):
        return BinaryMatrix(self.data | o.data)

    def __xor__(self, o):
        return BinaryMatrix(self.data ^ o.data)

    def __invert__(self):
        return BinaryMatrix(~self.data)

    def __getitem__(self, idx):
        out = self.data[idx]
        return BinaryMatrix(out) if out.dim() > 0 else bool(out)

    def set(self, idx, value=True):
        self.data[idx] = value
        return self

    # -- views ----------------------------------------------------------------
    def block(self, i, j, rows, cols):
        return BinaryMatrix(self.data[i : i + rows, j : j + cols])

    def repeat(self, r, c):
        return BinaryMatrix(self.data.repeat(r, c))

    def reshape(self, *shape):
        return BinaryMatrix(self.data.reshape(shape))

    # -- visitors (binary_matrix.h:238-270) ------------------------------------
    def all(self) -> bool:
        return bool(self.data.all())

    def any(self) -> bool:
        return bool(self.data.any())

    def count(self) -> int:
        return int(self.data.sum())

    # -- masking (binary_matrix.h:549-599 select) ------------------------------
    def select(self, M):
        """Zero the entries of M where the mask is false."""
        from .sparse import SparseMatrix

        if isinstance(M, SparseMatrix):
            data = self.data.to(M.vals.device)
            keep = data[M.rows.long(), M.cols.long()]
            return M.with_vals(torch.where(keep, M.vals, 0.0))
        M = torch.as_tensor(M, device=self.data.device)
        return torch.where(self.data, M, torch.zeros((), dtype=M.dtype, device=M.device))

    def __repr__(self):
        return f"BinaryMatrix({tuple(self.data.shape)}, count={self.count()})"


def BinaryVector(data, device=None) -> BinaryMatrix:
    """1D convenience alias (binary_matrix.h BinaryVector = Nx1)."""
    if isinstance(data, torch.Tensor):
        return BinaryMatrix(data.reshape(-1), device=device)
    return BinaryMatrix(np.asarray(data).reshape(-1), device=device)
