"""Reference-element node tables for Lagrange bases of order R on the unit
M-simplex (host-only NumPy; a copy of
``fdapde_core_tpu/fem/reference_element.py``).

Counterpart of fdaPDE-core fdaPDE/finite_elements/basis/reference_element.h:
node ordering is (vertices, then edge nodes in the lexicographic edge order of
`combinations(2, M+1)`, then interior nodes). This matches the reference for
M=1,2 (reference_element.h:30-80). For (M,R)=(3,2) the reference's hardcoded
midpoint order (reference_element.h:91-97) disagrees with its own P2 dof-slot
order (lagrangian_basis.h:106, lex edge pattern); we use the self-consistent
lex-edge order (3D P2 is untested upstream).
"""

from __future__ import annotations

import numpy as np

from ..utils.combinatorics import combinations

__all__ = ["reference_nodes", "n_basis"]


def n_basis(M: int, R: int) -> int:
    from math import comb

    return comb(M + R, R)


def reference_nodes(M: int, R: int) -> np.ndarray:
    """Nodes of the order-R Lagrange element on the unit M-simplex, (nb, M)."""
    verts = np.zeros((M + 1, M))
    for i in range(M):
        verts[i + 1, i] = 1.0
    nodes = [verts]
    if R >= 2:
        # edge nodes: R-1 per edge, lex edge order; for R=2 the midpoint, for
        # R=3 points at 1/3 and 2/3 (reference_element.h:69-79 groups both
        # nodes of an edge together before moving to the next edge)
        for a, b in combinations(2, M + 1):
            for t in range(1, R):
                nodes.append(
                    ((1 - t / R) * verts[a] + (t / R) * verts[b])[None, :]
                )
    if R >= 3 and M >= 2:
        # interior (face) nodes: barycenter-like points; for (M,R)=(2,3) the
        # single interior node (1/3, 1/3) (reference_element.h:72)
        if M == 2 and R == 3:
            nodes.append(np.array([[1 / 3, 1 / 3]]))
        else:
            raise NotImplementedError(f"reference nodes for M={M}, R={R}")
    out = np.concatenate(nodes, axis=0)
    assert out.shape == (n_basis(M, R), M)
    return out
