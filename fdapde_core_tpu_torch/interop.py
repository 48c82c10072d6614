"""Carry operators read out of the JAX package (``np.asarray``) across into
this package's objects, so one operator can feed both solvers."""

from __future__ import annotations

import numpy as np
import torch

from .linear_algebra.sparse import SparseMatrix
from .ops.grid_dia import GridDIAMatrix
from .ops.grid_mg import GridMG
from .ops.matfree_soa import ELLSoA

__all__ = ["ell_from_numpy", "grid_dia_from_numpy", "grid_mg_from_numpy", "sparse_from_numpy"]


def _tensor(a, device):
    return torch.tensor(np.asarray(a), device=device)


def _offsets(offsets2d):
    return tuple((int(a), int(b)) for a, b in offsets2d)


def grid_dia_from_numpy(data, offsets2d, shape2d, device="cuda") -> GridDIAMatrix:
    """GridDIAMatrix from a (K, mx, my) array and its offsets and shape."""
    return GridDIAMatrix(
        _tensor(data, device), _offsets(offsets2d), tuple(int(s) for s in shape2d)
    )


def grid_mg_from_numpy(datas, offsets, shapes, omega, nu, coarse_iters,
                       device="cuda") -> GridMG:
    """GridMG from per-level (K_l, m_l, m_l) arrays and the hierarchy's
    parameters (the fields of the JAX ``GridMG``)."""
    return GridMG(
        [_tensor(d, device) for d in datas],
        tuple(_offsets(o) for o in offsets),
        tuple(int(s) for s in shapes),
        float(omega), int(nu), int(coarse_iters),
    )


def ell_from_numpy(vals, cols, shape, device="cuda") -> ELLSoA:
    """ELLSoA from (K, n) values and int32 columns and its (n, n_src) shape
    (the fields of the JAX ``ELLSoA``)."""
    return ELLSoA(
        torch.tensor(np.ascontiguousarray(vals), device=device),
        torch.tensor(np.ascontiguousarray(cols, dtype=np.int32), device=device),
        tuple(int(s) for s in shape),
    )


def sparse_from_numpy(rows, cols, vals, shape, device="cuda") -> SparseMatrix:
    """SparseMatrix from sorted-COO (nnz,) rows, cols and vals and its
    shape (the fields of the JAX ``SparseMatrix``)."""
    return SparseMatrix(
        torch.tensor(np.asarray(rows, dtype=np.int32), device=device),
        torch.tensor(np.asarray(cols, dtype=np.int32), device=device),
        _tensor(vals, device),
        tuple(int(s) for s in shape),
    )
