"""Scalar/vector/matrix fields with automatic or numeric differentiation.

Port of ``fdapde_core_tpu/fields``, the counterpart of `fdaPDE/fields/`:
the C++ expression-template layer (scalar_expressions.h,
vector_expressions.h, matrix_expressions.h) is replaced by Python operator
overloading over torch callables. Derivatives use
`torch.func.grad`/`torch.func.hessian` (``mode="auto"``), or the
reference's central finite differences (field_derivatives.h:35-111, default
step 1e-3, ``mode="fd"``).
"""

from .fields import (  # noqa: F401
    cos,
    exp,
    log,
    sin,
    sqrt,
    tan,
    DifferentiableScalarField,
    DiscretizedField,
    MatrixField,
    ScalarField,
    TwiceDifferentiableScalarField,
    VectorField,
)

__all__ = [
    "ScalarField",
    "VectorField",
    "MatrixField",
    "DifferentiableScalarField",
    "TwiceDifferentiableScalarField",
    "DiscretizedField",
]
