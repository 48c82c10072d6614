"""Symbolic differential operators and their composition algebra (pure
Python; a copy of ``fdapde_core_tpu/pde/operators.py``).

Counterpart of fdaPDE-core fdaPDE/pde/differential_operators.h:27-52 and
differential_expressions.h:38-135. An operator expression like

    L = -laplacian() + advection(b) + reaction(c)

flattens into a list of `(scale, leaf)` terms. Traits mirror the reference:
`is_symmetric` (differential_operators.h:40-44) — true iff every (non-dt)
leaf is symmetric — and `is_parabolic` (presence of a dt() leaf,
differential_operators.h:46-49).

Coefficients may be:
- scalars / constant arrays (constant-coefficient case),
- callables `f(x) -> value` evaluated at physical quadrature points,
- arrays indexed by global quadrature point `num_quad * cell + q`, matching
  the reference's `DiscretizedScalarField.forward` protocol
  (fields/scalar_expressions.h:98-108).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = [
    "DifferentialOp",
    "Laplacian",
    "Diffusion",
    "Advection",
    "Reaction",
    "Dt",
    "BiLaplacian",
    "laplacian",
    "diffusion",
    "advection",
    "reaction",
    "dt",
    "bilaplacian",
]


class DifferentialOp:
    """An operator expression: a linear combination of operator leaves."""

    def __init__(self, terms):
        self.terms = list(terms)  # [(scale: float, leaf: _Leaf)]

    # -- algebra (differential_expressions.h:76-135) -------------------------
    def __add__(self, other: "DifferentialOp") -> "DifferentialOp":
        return DifferentialOp(self.terms + other.terms)

    def __sub__(self, other: "DifferentialOp") -> "DifferentialOp":
        return DifferentialOp(self.terms + [(-s, op) for s, op in other.terms])

    def __neg__(self) -> "DifferentialOp":
        return DifferentialOp([(-s, op) for s, op in self.terms])

    def __mul__(self, a) -> "DifferentialOp":
        return DifferentialOp([(s * a, op) for s, op in self.terms])

    __rmul__ = __mul__

    # -- traits --------------------------------------------------------------
    @property
    def is_parabolic(self) -> bool:
        return any(isinstance(op, Dt) for _, op in self.terms)

    @property
    def is_symmetric(self) -> bool:
        return all(op.is_symmetric for _, op in self.terms)

    @property
    def spatial_terms(self):
        """Terms entering the spatial discretization (dt only toggles the
        parabolic trait; its spatial weak form is zero, operators/dt.h:28-37)."""
        return [(s, op) for s, op in self.terms if not isinstance(op, Dt)]

    def remove(self, kind) -> "DifferentialOp":
        """Expression surgery (differential_expressions.h remove_operator)."""
        return DifferentialOp(
            [(s, op) for s, op in self.terms if not isinstance(op, kind)]
        )

    def __repr__(self):
        return " + ".join(f"{s}*{op!r}" for s, op in self.terms)


@dataclass(frozen=True)
class _Leaf:
    is_symmetric = True

    def __repr__(self):
        return type(self).__name__


@dataclass(frozen=True, repr=False)
class Laplacian(_Leaf):
    """Weak form -(invJ^T grad psi_i) . (invJ^T grad psi_j)
    (operators/laplacian.h:37-44)."""


@dataclass(frozen=True, repr=False)
class Diffusion(_Leaf):
    """Weak form -(invJ^T grad psi_i) . K (invJ^T grad psi_j), K an (N,N)
    tensor, space-varying or constant (operators/diffusion.h:32-55)."""

    K: Any = None


@dataclass(frozen=True, repr=False)
class Advection(_Leaf):
    """Weak form psi_i * b . (invJ^T grad psi_j), non-symmetric
    (operators/advection.h:33-56)."""

    b: Any = None
    is_symmetric = False


@dataclass(frozen=True, repr=False)
class Reaction(_Leaf):
    """Weak form c * psi_i * psi_j (operators/reaction.h:31-53)."""

    c: Any = 1.0


@dataclass(frozen=True, repr=False)
class Dt(_Leaf):
    """Time derivative marker: zero spatial weak form, flips the parabolic
    trait (operators/dt.h:28-37)."""


@dataclass(frozen=True, repr=False)
class BiLaplacian(_Leaf):
    """4th-order operator, SPLINE discretization only: psi_i'' * psi_j''
    with a leading minus (splines/operators/bilaplacian.h:30-41)."""


def _single(leaf) -> DifferentialOp:
    return DifferentialOp([(1.0, leaf)])


def laplacian() -> DifferentialOp:
    return _single(Laplacian())


def diffusion(K) -> DifferentialOp:
    return _single(Diffusion(K))


def advection(b) -> DifferentialOp:
    return _single(Advection(b))


def reaction(c) -> DifferentialOp:
    return _single(Reaction(c))


def dt() -> DifferentialOp:
    return _single(Dt())


def bilaplacian() -> DifferentialOp:
    return _single(BiLaplacian())
