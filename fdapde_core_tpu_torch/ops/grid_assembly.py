"""Scatter-free stencil conversion for tensor-product (structured) meshes.

On a structured criss-cross mesh every (triangle type, local_row,
local_col) combination maps to one static stencil layer and one contiguous
(n, n) block of it, so the global scatter becomes slice-adds. Valid for any
coordinates: only the connectivity is structured.

Mesh convention: quad (i, j), i, j in [0, n), lower-left node a = i*m + j
with m = n+1 nodes per side, split into type-A (a, b, a+1) and type-B
(b, b+1, a+1), b = a + m. Cell arrays list all n^2 type-A cells first, then
all n^2 type-B cells.

``p1_grid_stencil``, ``p1_grid_stencil_offdiag`` and
``stencil_from_offdiag_planes`` are plain torch (test oracles);
``stencil_from_coords`` is the main path and runs the fused assembly kernel
(``ops/assembly_kernels.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .assembly_kernels import p1_stencil_layers_into
from .closed_form import SYM_TO_FULL
from .grid_dia import GridDIAMatrix

__all__ = [
    "p1_grid_stencil",
    "p1_grid_stencil_offdiag",
    "stencil_from_offdiag_planes",
    "stencil_from_coords",
    "GRID_OFFSETS2D",
]

# local-dof grid positions relative to the quad's lower-left node
_POS_A = ((0, 0), (1, 0), (0, 1))  # a, b, a+1
_POS_B = ((1, 0), (1, 1), (0, 1))  # b, b+1, a+1

# the 7 stencil offsets generated by the criss-cross split
GRID_OFFSETS2D = (
    (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0),
)


def _type_blocks(A, rows, n):
    A = A.reshape(rows, -1)
    return {
        "A": A[:, : n * n].reshape(rows, n, n),
        "B": A[:, n * n: 2 * n * n].reshape(rows, n, n),
    }


def p1_grid_stencil(A6, n: int) -> GridDIAMatrix:
    """GridDIAMatrix of the P1 operator from packed local matrices.

    A6: (6, >= 2 n^2) packed-symmetric local matrices (rows
    [a11,a12,a13,a22,a23,a33]), cell axis ordered type-A block then type-B
    block (padding beyond 2 n^2 ignored). Returns the (m, m)-grid stencil.
    """
    m = n + 1
    vals = _type_blocks(A6, 6, n)
    layers = {
        o: torch.zeros((m, m), dtype=A6.dtype, device=A6.device)
        for o in GRID_OFFSETS2D
    }
    for t, pos in (("A", _POS_A), ("B", _POS_B)):
        for p in range(3):
            for q in range(3):
                o = (pos[q][0] - pos[p][0], pos[q][1] - pos[p][1])
                di, dj = pos[p]
                layers[o][di:di + n, dj:dj + n] += vals[t][SYM_TO_FULL[3 * p + q]]
    data = torch.stack([layers[o] for o in GRID_OFFSETS2D])
    return GridDIAMatrix(data, GRID_OFFSETS2D, (m, m))


# packed off-diagonal row index for unordered local pair {p, q}
_OFFDIAG_ROW = {(0, 1): 0, (0, 2): 1, (1, 2): 2}


def p1_grid_stencil_offdiag(A3, n: int) -> GridDIAMatrix:
    """GridDIAMatrix from off-diagonal-only local matrices.

    A3: (3, >= 2 n^2) rows [a12, a13, a23] per cell. The centre layer is
    -(sum of the six off-diagonal layers): the row-sum-zero identity of
    gradient-form stiffness matrices, exact.
    """
    m = n + 1
    vals = _type_blocks(A3, 3, n)
    layers = {
        o: torch.zeros((m, m), dtype=A3.dtype, device=A3.device)
        for o in GRID_OFFSETS2D
    }
    for t, pos in (("A", _POS_A), ("B", _POS_B)):
        for p in range(3):
            for q in range(3):
                if p == q:
                    continue
                o = (pos[q][0] - pos[p][0], pos[q][1] - pos[p][1])
                di, dj = pos[p]
                row = _OFFDIAG_ROW[(min(p, q), max(p, q))]
                layers[o][di:di + n, dj:dj + n] += vals[t][row]
    center = None
    for o in GRID_OFFSETS2D:
        if o == (0, 0):
            continue
        center = layers[o] if center is None else center + layers[o]
    layers[(0, 0)] = -center
    data = torch.stack([layers[o] for o in GRID_OFFSETS2D])
    return GridDIAMatrix(data, GRID_OFFSETS2D, (m, m))


# quad-grid plane layout: planes[k] (n, n) over quads, k: 0=a12, 1=a13,
# 2=a23, 3=b12, 4=b13, 5=b23. Each stencil layer at node (I, J) is the sum
# of exactly two plane values at quad (I - di, J - dj).
_LAYER_SOURCES = {
    (1, 0): ((0, 0, 0), (5, 0, 1)),    # a12(I,J)     + b23(I,J-1)
    (-1, 0): ((0, 1, 0), (5, 1, 1)),   # a12(I-1,J)   + b23(I-1,J-1)
    (0, 1): ((1, 0, 0), (3, 1, 0)),    # a13(I,J)     + b12(I-1,J)
    (0, -1): ((1, 0, 1), (3, 1, 1)),   # a13(I,J-1)   + b12(I-1,J-1)
    (-1, 1): ((2, 1, 0), (4, 1, 0)),   # a23(I-1,J)   + b13(I-1,J)
    (1, -1): ((2, 0, 1), (4, 0, 1)),   # a23(I,J-1)   + b13(I,J-1)
}


def stencil_from_offdiag_planes(planes, n: int) -> GridDIAMatrix:
    """GridDIAMatrix from (6, n, n) quad-grid off-diagonal planes; the
    centre layer is -(sum of the six off-diagonal layers)."""
    m = n + 1

    def placed(k, di, dj):
        return F.pad(planes[k], (dj, 1 - dj, di, 1 - di))

    layers = {}
    for off, ((k1, d1, e1), (k2, d2, e2)) in _LAYER_SOURCES.items():
        layers[off] = placed(k1, d1, e1) + placed(k2, d2, e2)
    center = None
    for off in _LAYER_SOURCES:
        center = layers[off] if center is None else center + layers[off]
    layers[(0, 0)] = -center
    data = torch.stack([layers[o] for o in GRID_OFFSETS2D])
    return GridDIAMatrix(data, GRID_OFFSETS2D, (m, m))


def stencil_from_coords(X, Y, n: int) -> GridDIAMatrix:
    """GridDIAMatrix of the P1 -laplacian operator straight from node
    coordinate planes X, Y (>= n+1 rows and columns, node (i, j) at row i,
    column j): one fused kernel pass writes the compact (7, m, m) layers."""
    m = n + 1
    data = torch.empty((7, m, m), dtype=X.dtype, device=X.device)
    p1_stencil_layers_into(X, Y, n, data)
    return GridDIAMatrix(data, GRID_OFFSETS2D, (m, m))
