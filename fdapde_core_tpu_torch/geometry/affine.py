"""Batched affine maps reference-simplex -> physical cell.

Port of ``fdapde_core_tpu/geometry/affine.py`` (counterpart of fdaPDE-core's
`Simplex::initialize`, simplex.h:184-195), vectorized over all cells:

- J[c]    (N, M): columns are node(j+1) - node(0),
- invJ[c] (M, N): exact inverse when M == N, Moore-Penrose pseudo-inverse
  (J^T J)^{-1} J^T on manifolds (2.5D / 1.5D),
- measure[c]: |det J| / M! when M == N, Gram form on manifolds
  (0.5 ||J_0 x J_1|| for M=2,N=3; ||J_0|| for M=1).

``affine_maps`` works on torch tensors (the device path of assembly);
``affine_maps_np`` is its NumPy twin for host preprocessing. Both use the
closed-form cofactor determinants and inverses of the JAX module, so the
two packages round alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["affine_maps", "affine_maps_np"]


class _TorchOps:
    """The few array functions the shared code needs, for torch tensors."""

    @staticmethod
    def stack(arrays, axis):
        return torch.stack(arrays, dim=axis)

    @staticmethod
    def swapaxes(a, i, j):
        return a.transpose(i, j)

    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)


def _det_small(xp, A):
    """Batched determinant of (C, k, k) for k in {1,2,3}, closed form."""
    k = A.shape[-1]
    if k == 1:
        return A[:, 0, 0]
    if k == 2:
        return A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    if k == 3:
        return (
            A[:, 0, 0] * (A[:, 1, 1] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 1])
            - A[:, 0, 1] * (A[:, 1, 0] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 0])
            + A[:, 0, 2] * (A[:, 1, 0] * A[:, 2, 1] - A[:, 1, 1] * A[:, 2, 0])
        )
    raise ValueError(k)


def _inv_small(xp, A, det):
    """Batched inverse of (C, k, k) for k in {1,2,3} via adjugate / det."""
    k = A.shape[-1]
    d = det[:, None, None]
    if k == 1:
        return 1.0 / A
    if k == 2:
        adj = xp.stack(
            [
                xp.stack([A[:, 1, 1], -A[:, 0, 1]], axis=-1),
                xp.stack([-A[:, 1, 0], A[:, 0, 0]], axis=-1),
            ],
            axis=-2,
        )
        return adj / d
    if k == 3:
        c = lambda i1, j1, i2, j2: A[:, i1, j1] * A[:, i2, j2] - A[:, i1, j2] * A[:, i2, j1]  # noqa: E731
        adj = xp.stack(
            [
                xp.stack([c(1, 1, 2, 2), -c(0, 1, 2, 2), c(0, 1, 1, 2)], axis=-1),
                xp.stack([-c(1, 0, 2, 2), c(0, 0, 2, 2), -c(0, 0, 1, 2)], axis=-1),
                xp.stack([c(1, 0, 2, 1), -c(0, 0, 2, 1), c(0, 0, 1, 1)], axis=-1),
            ],
            axis=-2,
        )
        return adj / d
    raise ValueError(k)


def _affine_maps(xp, nodes, cells):
    coords = nodes[cells]  # (C, M+1, N)
    M = cells.shape[1] - 1
    N = nodes.shape[1]
    J = xp.swapaxes(coords[:, 1:, :] - coords[:, :1, :], 1, 2)  # (C, N, M)
    if M == N:
        detJ = _det_small(xp, J)
        invJ = _inv_small(xp, J, detJ)
        measure = xp.abs(detJ) / math.factorial(M)
    else:
        Jt = xp.swapaxes(J, 1, 2)  # (C, M, N)
        G = Jt @ J  # (C, M, M) Gram matrix
        detG = _det_small(xp, G)
        invJ = _inv_small(xp, G, detG) @ Jt  # pseudo-inverse (simplex.h:190)
        if M == 2:  # 2.5D surface: cross-product area (simplex.h:191)
            a, b = J[:, :, 0], J[:, :, 1]
            cr = xp.stack(
                [
                    a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                    a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                    a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
                ],
                axis=-1,
            )
            measure = 0.5 * xp.sqrt((cr * cr).sum(1))
        elif M == 1:  # 1.5D network: segment length (simplex.h:192)
            measure = xp.sqrt((J[:, :, 0] * J[:, :, 0]).sum(1))
        else:
            measure = xp.sqrt(xp.abs(detG)) / math.factorial(M)
    return J, invJ, measure


def affine_maps_np(nodes: np.ndarray, cells: np.ndarray):
    """Host (NumPy) batched affine maps: returns (J, invJ, measure)."""
    return _affine_maps(np, np.asarray(nodes, np.float64), np.asarray(cells))


def affine_maps(nodes: torch.Tensor, cells: torch.Tensor):
    """Batched affine maps on nodes' device: returns (J, invJ, measure).

    nodes: (n, N) float tensor; cells: (C, M+1) integer tensor on the same
    device. Every output takes nodes' dtype and device.
    """
    return _affine_maps(_TorchOps, nodes, cells.long())
