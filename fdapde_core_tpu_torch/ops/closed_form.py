"""Closed-form P1 local stiffness (2D).

The P1/2D stiffness of the form int grad.grad has the closed form

    A = (b b^T + c c^T) / (4 area),  b = (y2-y3, y3-y1, y1-y2),
                                     c = (x3-x2, x1-x3, x2-x1)

Only the 6 unique entries of the symmetric 3x3 local matrix are produced;
``SYM_TO_FULL`` expands row-major (i, j) -> packed index.
"""

from __future__ import annotations

import torch

__all__ = ["p1_stiffness_2d_sym", "SYM_TO_FULL"]

# row-major (3,3) index -> packed symmetric index [a11,a12,a13,a22,a23,a33]
SYM_TO_FULL = (0, 1, 2, 1, 3, 4, 2, 4, 5)


def p1_stiffness_2d_sym(coords: torch.Tensor) -> torch.Tensor:
    """Packed symmetric local stiffness of the (positive) form int grad.grad.

    coords: (6, ...) rows are x1,y1,x2,y2,x3,y3 over any trailing cell-axis
    shape. Returns (6, ...) packed rows [a11, a12, a13, a22, a23, a33].
    """
    x1, y1, x2, y2, x3, y3 = (coords[i] for i in range(6))
    b1, b2, b3 = y2 - y3, y3 - y1, y1 - y2
    c1, c2, c3 = x3 - x2, x1 - x3, x2 - x1
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    inv = 1.0 / (2.0 * torch.abs(det))
    return torch.stack(
        [
            (b1 * b1 + c1 * c1) * inv,
            (b1 * b2 + c1 * c2) * inv,
            (b1 * b3 + c1 * c3) * inv,
            (b2 * b2 + c2 * c2) * inv,
            (b2 * b3 + c2 * c3) * inv,
            (b3 * b3 + c3 * c3) * inv,
        ]
    )
