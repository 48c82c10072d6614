"""Field types: callables R^M -> R / R^N / R^(NxK) with algebra and calculus.

Port of ``fdapde_core_tpu/fields/fields.py`` on torch callables: "auto"
derivatives are ``torch.func.grad`` / ``torch.func.hessian`` where JAX takes
its own, the unary wrappers map to torch, and components that return
Python numbers are stacked as tensors of the point's dtype (JAX's stack
accepts numbers). The fields compose with ``torch.func.vmap`` to evaluate
at a batch of points. Mirrors the behavior of the reference field layer:

- `ScalarField` wraps any callable; arithmetic (+, -, *, /), composition with
  torch math, and lazy derivatives (`derive`, `derive_twice`),
  scalar_field.h:29-132, scalar_expressions.h:57-186,
- derivatives: `torch.func.grad` / `torch.func.hessian` when `mode="auto"`; central finite
  differences with the reference's formulas and default step h=1e-3 when
  `mode="fd"` (field_derivatives.h:44-51 first order, :66-93 second order),
- `DifferentiableScalarField` / `TwiceDifferentiableScalarField` let the user
  supply analytic gradients/hessians overriding the numeric path
  (differentiable_field.h:35-78),
- `VectorField` is a vector of scalar fields with `.dot()`
  (vector_field.h:34-92, dot_product.h:28-84), `MatrixField` a grid
  (matrix_field.h:34).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import func as tfunc

__all__ = [
    "ScalarField",
    "VectorField",
    "MatrixField",
    "DifferentiableScalarField",
    "TwiceDifferentiableScalarField",
    "DiscretizedField",
    "sin",
    "cos",
    "tan",
    "exp",
    "log",
    "sqrt",
]


def _as_point(x):
    """A point as a float tensor (float64 unless it already is floating), on
    x's device when it is a tensor and on the card otherwise."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device="cuda")
    return x if x.is_floating_point() else x.to(torch.float64)


def _stack(values, like):
    """torch.stack of values that may be Python numbers, as like's dtype."""
    return torch.stack([v if isinstance(v, torch.Tensor)
                        else torch.tensor(v, dtype=like.dtype, device=like.device)
                        for v in values])


def _lift(value):
    if isinstance(value, ScalarField):
        return value.f
    if callable(value):
        return value
    return lambda x: value


class ScalarField:
    """A field R^M -> R."""

    def __init__(self, f: Callable, step: float = 1e-3):
        self.f = f
        self.step = step  # FD step (scalar_expressions.h:60)

    def __call__(self, x):
        return self.f(_as_point(x))

    # -- algebra (scalar_expressions.h binop nodes) ---------------------------
    def _binop(self, other, op):
        g = _lift(other)
        return ScalarField(lambda x: op(self.f(x), g(x)), self.step)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binop(other, lambda a, b: b / a)

    def __neg__(self):
        return ScalarField(lambda x: -self.f(x), self.step)

    # -- calculus -------------------------------------------------------------
    def derive(self, mode: str = "auto") -> "VectorField":
        """Gradient field (scalar_expressions.h:81, field_derivatives.h:35-54)."""
        if mode == "auto":
            return VectorField.from_callable(tfunc.grad(self.f))
        h = self.step

        def fd_grad(x):
            x = _as_point(x)
            n = x.shape[0]
            eye = torch.eye(n, dtype=x.dtype, device=x.device)
            plus = _stack([self.f(x + h * eye[i]) for i in range(n)], x)
            minus = _stack([self.f(x - h * eye[i]) for i in range(n)], x)
            return (plus - minus) / (2 * h)  # field_derivatives.h:44-51

        return VectorField.from_callable(fd_grad)

    def derive_twice(self, mode: str = "auto") -> "MatrixField":
        """Hessian field (scalar_expressions.h:82, field_derivatives.h:56-111)."""
        if mode == "auto":
            return MatrixField.from_callable(tfunc.hessian(self.f))
        h = self.step
        f = self.f

        def fd_hess(x):
            x = _as_point(x)
            n = x.shape[0]
            eye = torch.eye(n, dtype=x.dtype, device=x.device)
            rows = []
            for i in range(n):
                row = []
                for j in range(n):
                    if i == j:
                        # 5-point pure second derivative (field_derivatives.h:66-77)
                        v = (
                            -f(x + 2 * h * eye[i])
                            + 16 * f(x + h * eye[i])
                            - 30 * f(x)
                            + 16 * f(x - h * eye[i])
                            - f(x - 2 * h * eye[i])
                        ) / (12 * h * h)
                    else:
                        # 4-point mixed derivative (field_derivatives.h:79-93)
                        v = (
                            f(x + h * (eye[i] + eye[j]))
                            - f(x + h * (eye[i] - eye[j]))
                            - f(x - h * (eye[i] - eye[j]))
                            + f(x - h * (eye[i] + eye[j]))
                        ) / (4 * h * h)
                    row.append(v)
                rows.append(_stack(row, x))
            return torch.stack(rows)

        return MatrixField.from_callable(fd_hess)


class DifferentiableScalarField(ScalarField):
    """Scalar field with user-supplied analytic gradient
    (differentiable_field.h:35-53)."""

    def __init__(self, f, grad, step: float = 1e-3):
        super().__init__(f, step)
        self._grad = grad

    def derive(self, mode: str = "auto") -> "VectorField":
        return VectorField.from_callable(_lift(self._grad))


class TwiceDifferentiableScalarField(DifferentiableScalarField):
    """... plus analytic hessian (differentiable_field.h:55-78)."""

    def __init__(self, f, grad, hessian, step: float = 1e-3):
        super().__init__(f, grad, step)
        self._hess = hessian

    def derive_twice(self, mode: str = "auto") -> "MatrixField":
        return MatrixField.from_callable(_lift(self._hess))


class DiscretizedField:
    """A field known only at quadrature nodes, indexed `nq * cell + q`.

    Counterpart of DiscretizedScalarField / DiscretizedVectorField /
    DiscretizedMatrixField (fields/scalar_expressions.h:98-108,
    vector_expressions.h:103, matrix_expressions.h:191): the reference
    smuggles the quadrature index through a `forward(i)` side-channel so
    expression templates can read tabulated coefficient values during
    assembly. In the TPU build the assembler consumes such fields directly
    as arrays shaped (n_cells * n_quad, ...) — this wrapper only carries the
    array plus its value rank for validation and API parity
    (pde/operators.py coefficient protocol).
    """

    def __init__(self, values, rank: int = 0):
        import numpy as np

        self.values = np.asarray(values, dtype=np.float64)
        self.rank = rank  # 0: scalar, 1: vector, 2: matrix coefficient

    def __array__(self, dtype=None, copy=None):
        return self.values if dtype is None else self.values.astype(dtype)

    def forward(self, i: int):
        """Value at global quadrature index i (scalar_expressions.h:105)."""
        return self.values[i]


class VectorField:
    """A field R^M -> R^N (vector_field.h:34)."""

    def __init__(self, components):
        self.components = [c if isinstance(c, ScalarField) else ScalarField(c) for c in components]

    @classmethod
    def from_callable(cls, f):
        obj = cls.__new__(cls)
        obj.components = None
        obj._f = f
        return obj

    def __call__(self, x):
        x = _as_point(x)
        if self.components is None:
            return self._f(x)
        return _stack([c(x) for c in self.components], x)

    def __getitem__(self, i):
        if self.components is not None:
            return self.components[i]
        return ScalarField(lambda x, i=i: self(x)[i])

    def dot(self, other) -> ScalarField:
        """Lazy inner product (dot_product.h:28-84)."""
        if isinstance(other, VectorField):
            return ScalarField(lambda x: torch.dot(self(x), other(x)))
        v = torch.as_tensor(other)
        return ScalarField(lambda x: torch.dot(self(x), v.to(x.device, x.dtype)))

    def __add__(self, other):
        return VectorField.from_callable(lambda x: self(x) + other(x))

    def __sub__(self, other):
        return VectorField.from_callable(lambda x: self(x) - other(x))

    def __neg__(self):
        return VectorField.from_callable(lambda x: -self(x))

    def __mul__(self, s):
        if isinstance(s, ScalarField):
            return VectorField.from_callable(lambda x: self(x) * s(x))
        return VectorField.from_callable(lambda x: self(x) * s)

    __rmul__ = __mul__


class MatrixField:
    """A field R^M -> R^(NxK) (matrix_field.h:34)."""

    def __init__(self, grid):
        self.grid = [
            [c if isinstance(c, ScalarField) else ScalarField(c) for c in row]
            for row in grid
        ]

    @classmethod
    def from_callable(cls, f):
        obj = cls.__new__(cls)
        obj.grid = None
        obj._f = f
        return obj

    def __call__(self, x):
        x = _as_point(x)
        if self.grid is None:
            return self._f(x)
        return torch.stack([_stack([c(x) for c in row], x) for row in self.grid])

    def __getitem__(self, ij):
        i, j = ij
        if self.grid is not None:
            return self.grid[i][j]
        return ScalarField(lambda x: self(x)[i, j])

    def matvec(self, v) -> VectorField:
        """Lazy matrix-vector product -> VectorField
        (matrix_expressions.h:59 MatrixVectorProduct)."""
        if isinstance(v, VectorField):
            return VectorField.from_callable(lambda x: self(x) @ v(x))
        vv = torch.as_tensor(v)
        return VectorField.from_callable(lambda x: self(x) @ vv.to(x.device, x.dtype))

    def __add__(self, other):
        return MatrixField.from_callable(lambda x: self(x) + other(x))

    def __sub__(self, other):
        return MatrixField.from_callable(lambda x: self(x) - other(x))

    def __mul__(self, s):
        return MatrixField.from_callable(lambda x: self(x) * s)

    __rmul__ = __mul__

    def __matmul__(self, other):
        """Lazy matrix-matrix product (matrix_expressions.h:80)."""
        if isinstance(other, MatrixField):
            return MatrixField.from_callable(lambda x: self(x) @ other(x))
        if isinstance(other, VectorField):
            return self.matvec(other)
        arr = torch.as_tensor(other)
        if arr.dim() == 1:
            return self.matvec(arr)
        return MatrixField.from_callable(lambda x: self(x) @ arr.to(x.device, x.dtype))


def _unary(fn):
    def wrapper(field):
        f = _lift(field)
        return ScalarField(lambda x: fn(f(x)))

    return wrapper


# unary math on scalar expressions (scalar_expressions.h sin/cos/tan/exp/log)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
exp = _unary(torch.exp)
log = _unary(torch.log)
sqrt = _unary(torch.sqrt)
