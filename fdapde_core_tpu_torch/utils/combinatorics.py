"""Combinatoric utilities (host-only NumPy; a copy of
``fdapde_core_tpu/utils/combinatorics.py``).

Semantics match the reference (fdaPDE-core fdaPDE/utils/combinatorics.h):
`combinations(k, n)` returns all k-subsets of {0..n-1} as rows, in
lexicographic order — the reference produces this order via
`std::prev_permutation` over a descending bitmask (combinatorics.h:37-51).
The row order is load-bearing: mesh edge/face extraction and P2 dof slots are
keyed by it (geometry/triangulation.h:150, finite_elements/lagrangian_basis.h:106).
"""

from __future__ import annotations

from itertools import combinations as _combinations
from math import comb, factorial as _factorial

import numpy as np


def factorial(n: int) -> int:
    """n! (reference: ct_factorial, combinatorics.h:29)."""
    return _factorial(n)


def binomial(n: int, k: int) -> int:
    """Binomial coefficient (reference: ct_binomial_coefficient, combinatorics.h:32)."""
    return comb(n, k)


def combinations(k: int, n: int) -> np.ndarray:
    """All k-subsets of {0..n-1}, one per row, lexicographic order.

    >>> combinations(2, 3)
    array([[0, 1],
           [0, 2],
           [1, 2]])
    """
    return np.array(list(_combinations(range(n), k)), dtype=np.int32).reshape(
        binomial(n, k), k
    )
