"""Nonlinear unconstrained optimizers.

Port of ``fdapde_core_tpu/optimization``, the counterpart of
`fdaPDE/optimization/`: Grid / GradientDescent / Newton / BFGS (grid.h,
gradient_descent.h, newton.h, bfgs.h) with backtracking and Wolfe line
searches (callbacks/*.h), as host loops on device tensors with eager
autograd derivatives (``optimizers.py``; a finite-difference mode is
available through ``ScalarField.derive(mode="fd")``).
"""

from .optimizers import (
    OptimizeResult,
    bfgs,
    gradient_descent,
    grid_search,
    newton,
)

__all__ = [
    "OptimizeResult",
    "grid_search",
    "gradient_descent",
    "newton",
    "bfgs",
]
