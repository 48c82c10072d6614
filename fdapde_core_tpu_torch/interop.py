"""Carry operators and fitted models read out of the JAX package
(``np.asarray``) across into this package's objects, so one operator can
feed both solvers and a fit made in JAX predicts the same values here."""

from __future__ import annotations

import numpy as np
import torch

from .linear_algebra.sparse import SparseMatrix
from .ops.grid_dia import GridDIAMatrix
from .ops.grid_mg import GridMG
from .ops.matfree_soa import ELLSoA

__all__ = ["ell_from_numpy", "grid_dia_from_numpy", "grid_mg_from_numpy",
           "smoothing_regression_from_numpy", "space_time_smoothing_from_numpy",
           "sparse_from_numpy"]


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


def smoothing_regression_from_numpy(mesh, penalty_op, coefficients, order: int = 1,
                                    device="cuda"):
    """A fitted ``models.SmoothingRegression`` over ``mesh`` (a port
    Triangulation on the same nodes and cells as the JAX model's) whose
    coefficients are a fitted JAX model's ``coefficients_`` as numpy."""
    from .models.regression import SmoothingRegression

    model = SmoothingRegression(mesh, penalty_op, order=order, device=device)
    model.coefficients_ = _tensor(np.asarray(coefficients, dtype=np.float64), device)
    return model


def space_time_smoothing_from_numpy(mesh, time_interval, coefficients, fem_order: int = 1,
                                    spline_order: int = 3, device="cuda"):
    """A fitted ``models.SpaceTimeSmoothing`` whose (n_t, n_s) coefficients
    are a fitted JAX model's ``coefficients_`` as numpy."""
    from .models.space_time import SpaceTimeSmoothing

    model = SpaceTimeSmoothing(mesh, time_interval, fem_order=fem_order,
                               spline_order=spline_order, device=device)
    model.coefficients_ = _tensor(np.asarray(coefficients, dtype=np.float64), device)
    return model
