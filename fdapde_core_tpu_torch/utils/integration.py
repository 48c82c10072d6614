"""Numerical integration of callables over meshes.

A host NumPy copy of ``fdapde_core_tpu/utils/integration.py``, the
counterpart of fdaPDE-core's Integrator facade (fdaPDE/utils/integration/
integrator.h:36-123): integrate a callable (or per-quadrature array) over
one cell or a whole mesh with the standard FEM rule.
"""

from __future__ import annotations

import numpy as np

from .quadrature import standard_fem_quadrature

__all__ = ["integrate", "integrate_cells", "quadrature_points"]


def quadrature_points(mesh, order: int = 1):
    """(points (C, nq, N), weights (nq,), measures (C,)) of the standard rule."""
    from ..geometry.affine import affine_maps_np

    quad = standard_fem_quadrature(mesh.local_dim, order)
    J, _, measure = affine_maps_np(mesh.nodes, mesh.cells)
    p0 = mesh.nodes[mesh.cells[:, 0]]
    phys = p0[:, None, :] + np.einsum("cnm,qm->cqn", J, quad.nodes)
    return phys, quad.weights, measure


def integrate_cells(mesh, f, order: int = 1) -> np.ndarray:
    """Per-cell integrals of f: (C,). `f` is a callable of the physical
    point, or an array of values at quadrature nodes (C, nq) / (C*nq,)."""
    phys, w, measure = quadrature_points(mesh, order)
    C, nq, N = phys.shape
    if callable(f):
        from .callables import eval_at_points

        vals = eval_at_points(f, phys.reshape(-1, N)).reshape(C, nq)
    else:
        vals = np.asarray(f, dtype=np.float64).reshape(C, nq)
    return (vals @ w) * measure


def integrate(mesh, f, order: int = 1) -> float:
    """Integral of f over the whole mesh (integrator.h:62-69)."""
    return float(integrate_cells(mesh, f, order).sum())
