"""Symmetric quadrature rules on reference simplices (host-only NumPy; a
copy of ``fdapde_core_tpu/utils/quadrature.py``).

Counterpart of the reference integrator tables
(fdaPDE-core fdaPDE/utils/integration/integrator_tables.h). Conventions
match the reference exactly:

- nodes are given in cartesian coordinates of the unit reference simplex
  (1D: [0,1]; 2D: (0,0),(1,0),(0,1); 3D: unit tetrahedron),
- weights sum to 1: `integral over cell e = e.measure * sum_q w_q f(x_q)`
  (integrator.h:93-106),
- the *node ordering* inside each rule is identical to the reference tables —
  it is part of the public API, because discretized forcings/coefficients are
  passed as arrays indexed by `num_quad * cell_id + q`
  (integrator.h:52-55, pde/pde.h forcing protocol),
- the rule selected per (dim, fem_order) follows
  `standard_fem_quadrature_rule` (integrator_tables.h:24-54).

Values are stored at full double precision (the reference truncates at 15
digits; the difference is below every reference test tolerance).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "SimplexQuadrature",
    "simplex_quadrature",
    "standard_fem_quadrature",
    "gauss_legendre_1d",
]


@dataclass(frozen=True)
class SimplexQuadrature:
    """A quadrature rule over the unit reference simplex of dimension `dim`."""

    dim: int
    nodes: np.ndarray  # (num_nodes, dim) float64
    weights: np.ndarray  # (num_nodes,) float64, summing to 1

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]


def _rule(dim, nodes, weights) -> SimplexQuadrature:
    nodes = np.asarray(nodes, dtype=np.float64).reshape(-1, dim)
    weights = np.asarray(weights, dtype=np.float64)
    nodes.setflags(write=False)
    weights.setflags(write=False)
    return SimplexQuadrature(dim, nodes, weights)


_S3 = math.sqrt(3.0)
_S35 = math.sqrt(3.0 / 5.0)

# --- 1D rules on [0, 1] (integrator_tables.h:64-93) ---------------------------
_TABLE_1D = {
    2: _rule(1, [[(3 - _S3) / 6], [(3 + _S3) / 6]], [0.5, 0.5]),
    3: _rule(
        1,
        [[(1 - _S35) / 2], [0.5], [(1 + _S35) / 2]],
        [5 / 18, 8 / 18, 5 / 18],
    ),
}

# --- 2D rules on the unit triangle (integrator_tables.h:131-236) --------------
# 6-point, degree 4 (Dunavant); node triples listed in reference order.
_a4, _b4, _w4 = 0.4459484909159649, 0.1081030181680702, 0.2233815896780115
_a5, _b5, _w5 = 0.0915762135097707, 0.8168475729804586, 0.1099517436553219
# 7-point, degree 5.
_a7, _b7, _w7 = 0.1012865073234563, 0.7974269853530873, 0.1259391805448271
_c7, _d7, _v7 = 0.4701420641051151, 0.0597158717897698, 0.1323941527885062
# 12-point, degree 6.
_g1, _h1, _u1 = 0.0630890144915022, 0.8738219710169956, 0.0508449063702068
_g2, _h2, _u2 = 0.2492867451709104, 0.5014265096581792, 0.1167862757263794
_g3, _h3, _u3 = 0.0531450498448160, 0.6365024991213987, 0.0828510756183736
# (_h3 completes the triple: _g3 + _h3 + 0.3103524510337844 = 1)
_f3 = 0.3103524510337844

_TABLE_2D = {
    1: _rule(2, [[1 / 3, 1 / 3]], [1.0]),
    3: _rule(
        2,
        [[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]],
        [1 / 3, 1 / 3, 1 / 3],
    ),
    6: _rule(
        2,
        [
            [_a4, _a4],
            [_a4, _b4],
            [_b4, _a4],
            [_a5, _a5],
            [_a5, _b5],
            [_b5, _a5],
        ],
        [_w4, _w4, _w4, _w5, _w5, _w5],
    ),
    7: _rule(
        2,
        [
            [1 / 3, 1 / 3],
            [_a7, _a7],
            [_a7, _b7],
            [_b7, _a7],
            [_c7, _c7],
            [_c7, _d7],
            [_d7, _c7],
        ],
        [0.225, _w7, _w7, _w7, _v7, _v7, _v7],
    ),
    12: _rule(
        2,
        [
            [_h1, _g1],
            [_g1, _h1],
            [_g1, _g1],
            [_h2, _g2],
            [_g2, _h2],
            [_g2, _g2],
            [_h3, _f3],
            [_h3, _g3],
            [_f3, _h3],
            [_f3, _g3],
            [_g3, _h3],
            [_g3, _f3],
        ],
        [_u1] * 3 + [_u2] * 3 + [_u3] * 6,
    ),
}

# --- 3D rules on the unit tetrahedron (integrator_tables.h:242-320) -----------
_ta = (5 + 3 * math.sqrt(5.0)) / 20  # 0.585410196624969
_tb = (5 - math.sqrt(5.0)) / 20  # 0.138196601125011
_ka = 11 / 14
_kb = 1 / 14
_kc = (1 + math.sqrt(5.0 / 14.0)) / 4  # 0.399403576166799
_kd = (1 - math.sqrt(5.0 / 14.0)) / 4  # 0.100596423833201

_TABLE_3D = {
    1: _rule(3, [[0.25, 0.25, 0.25]], [1.0]),
    4: _rule(
        3,
        [[_ta, _tb, _tb], [_tb, _tb, _tb], [_tb, _tb, _ta], [_tb, _ta, _tb]],
        [0.25] * 4,
    ),
    5: _rule(
        3,
        [
            [0.25, 0.25, 0.25],
            [0.5, 1 / 6, 1 / 6],
            [1 / 6, 0.5, 1 / 6],
            [1 / 6, 1 / 6, 0.5],
            [1 / 6, 1 / 6, 1 / 6],
        ],
        [-0.8, 0.45, 0.45, 0.45, 0.45],
    ),
    11: _rule(
        3,
        [
            [0.25, 0.25, 0.25],
            [_ka, _kb, _kb],
            [_kb, _kb, _kb],
            [_kb, _kb, _ka],
            [_kb, _ka, _kb],
            [_kd, _kc, _kc],
            [_kc, _kd, _kc],
            [_kc, _kc, _kd],
            [_kc, _kd, _kd],
            [_kd, _kc, _kd],
            [_kd, _kd, _kc],
        ],
        [-148 / 1875] + [343 / 7500] * 4 + [56 / 375] * 6,
    ),
}

_TABLES = {1: _TABLE_1D, 2: _TABLE_2D, 3: _TABLE_3D}


def simplex_quadrature(dim: int, num_nodes: int) -> SimplexQuadrature:
    """The `num_nodes`-point symmetric rule on the dim-dimensional simplex."""
    try:
        return _TABLES[dim][num_nodes]
    except KeyError:
        raise ValueError(
            f"no {num_nodes}-point rule tabulated for dimension {dim}; "
            f"available: {sorted(_TABLES.get(dim, {}))}"
        ) from None


def standard_fem_quadrature(dim: int, fem_order: int) -> SimplexQuadrature:
    """Quadrature rule used for FEM of order `fem_order` in dimension `dim`.

    Mirrors `standard_fem_quadrature_rule` (integrator_tables.h:24-54):
    1D: order1 -> 2pt, order>=2 -> 3pt; 2D: order1 -> 3pt, order2 -> 6pt,
    order>=3 -> 12pt; 3D: order1 -> 4pt, order>=2 -> 5pt.
    """
    if dim == 1:
        return simplex_quadrature(1, 2 if fem_order == 1 else 3)
    if dim == 2:
        return simplex_quadrature(2, {1: 3, 2: 6}.get(fem_order, 12))
    if dim == 3:
        return simplex_quadrature(3, 4 if fem_order == 1 else 5)
    raise ValueError(f"unsupported dimension {dim}")


def gauss_legendre_1d(num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss–Legendre nodes/weights on [-1, 1] (integrator_tables.h:96-126).

    Computed via numpy's Golub–Welsch (full precision; the reference hardcodes
    the same values at 15 digits). Used by the spline assembler
    (splines/spline_assembler.h:64-66, 3-point rule).
    """
    nodes, weights = np.polynomial.legendre.leggauss(num_nodes)
    return nodes, weights
