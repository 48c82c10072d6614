"""Carry meshes, operators, preconditioners and fitted models read out of
the JAX package (``np.asarray``) across into this package's objects, so one
operator can feed both solvers and a fit made in JAX predicts the same
values here."""

from __future__ import annotations

import numpy as np
import torch

from .linear_algebra.dia import DIAMatrix
from .linear_algebra.sparse import SparseMatrix
from .ops.auxgrid import AuxGridPreconditioner3D
from .ops.dia_split3d import BandedSplit3D
from .ops.grid3d import GridDIA3D
from .ops.grid_dia import GridDIAMatrix
from .ops.grid_mg import GridMG
from .ops.grid_mg3d import GridMG3D
from .ops.matfree_soa import ELLSoA

__all__ = ["aux_grid_3d_from_numpy", "banded_split_3d_from_numpy", "dia_from_numpy",
           "ell_from_numpy",
           "grid_dia_3d_from_numpy", "grid_dia_from_numpy", "grid_mg_3d_from_numpy",
           "grid_mg_from_numpy", "mesh_from_numpy", "smoothing_regression_from_numpy",
           "space_time_smoothing_from_numpy", "sparse_from_numpy"]


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


def mesh_from_numpy(*arrays, device="cuda"):
    """A device mesh tuple, stacked (nodes, cells, boundary) or SoA (x, y,
    [z,] c0, ..., boundary): float arrays keep their dtype, index arrays
    become int32, the boundary bool."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int32)
        out.append(torch.tensor(np.ascontiguousarray(a), device=device))
    return tuple(out)


def _offsets3(offsets3d):
    return tuple((int(a), int(b), int(c)) for a, b, c in offsets3d)


def grid_dia_3d_from_numpy(data, offsets3d, shape3d, device="cuda") -> GridDIA3D:
    """GridDIA3D from a (K, mx, my, mz) array and its offsets and shape."""
    return GridDIA3D(_tensor(data, device), _offsets3(offsets3d),
                     tuple(int(s) for s in shape3d))


def grid_mg_3d_from_numpy(datas, offsets, shapes, omega, nu, coarse_iters,
                          device="cuda") -> GridMG3D:
    """GridMG3D from per-level (K_l, m_l, m_l, m_l) arrays and the
    hierarchy's parameters (the fields of the JAX ``GridMG3D``)."""
    return GridMG3D([_tensor(d, device) for d in datas], tuple(_offsets3(o) for o in offsets),
                    tuple(int(s) for s in shapes), float(omega), int(nu), int(coarse_iters))


def banded_split_3d_from_numpy(data, offsets3d, shape3d, n, rem=None,
                               device="cuda") -> BandedSplit3D:
    """BandedSplit3D from its stencil's fields and, unless None, its
    remainder's (vals (K, n), cols (K, n)) arrays."""
    G = grid_dia_3d_from_numpy(data, offsets3d, shape3d, device)
    R = None if rem is None else ell_from_numpy(rem[0], rem[1], (n, n), device)
    return BandedSplit3D(G, R, int(n))


def aux_grid_3d_from_numpy(idx, w, dinv, mg_levels, omega, n_grid,
                           device="cuda") -> AuxGridPreconditioner3D:
    """AuxGridPreconditioner3D from the JAX object's idx (8, n), w (8, n),
    dinv (n,), its GridMG3D's (datas, offsets, shapes, omega, nu,
    coarse_iters) and its omega and n_grid; P^T is rebuilt from idx and w."""
    mg = grid_mg_3d_from_numpy(*mg_levels, device=device)
    return AuxGridPreconditioner3D(
        torch.tensor(np.ascontiguousarray(idx, dtype=np.int32), device=device),
        _tensor(w, device), _tensor(dinv, device), mg, float(omega), int(n_grid))


def dia_from_numpy(data, offsets, device="cuda") -> DIAMatrix:
    """DIAMatrix from a (K, n) array and its K offsets (the fields of the
    JAX ``DIAMatrix``)."""
    data = _tensor(data, device)
    return DIAMatrix(data, tuple(int(d) for d in offsets), int(data.shape[1]))


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
