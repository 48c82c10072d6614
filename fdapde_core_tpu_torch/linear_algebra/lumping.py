"""Row-sum mass lumping.

Port of ``fdapde_core_tpu/linear_algebra/lumping.py`` (fdaPDE's
lumping.h:30-51): a (mass) matrix is replaced by the diagonal of its row
sums, returned as a vector. JAX sums a SparseMatrix's rows with
``segment_sum``; here they come from ``SparseMatrix.row_sums``, which adds
each row in column order on K2, so the result repeats bitwise on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse import SparseMatrix

__all__ = ["lump"]


def lump(M):
    """Diagonal (as a vector) of the row-sum lumped matrix: a SparseMatrix
    or a dense square matrix. A tensor keeps its device; a host matrix goes
    to the card, as JAX puts it on the accelerator."""
    if isinstance(M, SparseMatrix):
        if M.shape[0] != M.shape[1]:
            raise ValueError(f"lumping requires a square matrix, got {M.shape}")
        return M.row_sums()
    if not isinstance(M, torch.Tensor):
        M = torch.as_tensor(np.asarray(M), device="cuda")
    if M.dim() != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"lumping requires a square matrix, got {tuple(M.shape)}")
    return M.sum(dim=1)
