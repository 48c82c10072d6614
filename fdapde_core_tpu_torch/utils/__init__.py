"""Support utilities, host copies of the JAX package's ``utils``:
combinatorics, quadrature tables, batched evaluation of user callables,
integration over meshes (``integration``), CSV / MatrixMarket / mesh IO
(``io``), checkpoints of spaces and AMG hierarchies (``checkpoint``),
binary trees, block frames and the shapefile reader; the torch-side
``profiling`` (timers, ``torch.profiler`` traces) and ``sanitize``
(non-finite checks) layers; and fdaPDE-core's scalar helpers
(utils/symbols.h)."""

import numpy as np
import torch

from . import combinatorics, integration, io, quadrature
from .combinatorics import binomial, combinations, factorial
from .quadrature import (
    SimplexQuadrature,
    gauss_legendre_1d,
    simplex_quadrature,
    standard_fem_quadrature,
)

DOUBLE_TOLERANCE = 50 * 2.220446049250313e-16  # utils/symbols.h:163
MACHINE_EPSILON = 10 * 2.220446049250313e-16  # utils/symbols.h:164


def almost_equal(a, b, epsilon: float = DOUBLE_TOLERANCE) -> bool:
    """Scalar/array closeness test (utils/symbols.h:167-174).

    Absolute-OR-relative: |a-b| < eps or |a-b| < max(|a|,|b|)*eps, applied
    elementwise (arrays compare all entries, mirroring the matrix overload
    in test/src/utils/utils.h). Host values: NumPy arrays, scalars, or
    tensors (read back from their device)."""
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x for x in (a, b))
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    d = np.abs(a - b)
    return bool(np.all((d < epsilon) | (d < np.maximum(np.abs(a), np.abs(b)) * epsilon)))


def log1pexp(x):
    """Numerically stable log(1 + exp(x)) (utils/symbols.h:179-189).

    Piecewise evaluation avoids overflow for large x and cancellation for
    very negative x. A tensor keeps its device; a scalar or an array goes to
    the card, as JAX puts it on the accelerator."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64), device="cuda")
    return torch.where(
        x <= -37.0,
        torch.exp(x),
        torch.where(
            x <= 18.0,
            torch.log1p(torch.exp(torch.clamp(x, max=18.0))),
            torch.where(x <= 33.3, x + torch.exp(-x), x),
        ),
    )
