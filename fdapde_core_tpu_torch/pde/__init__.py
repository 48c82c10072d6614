"""The PDE descriptor (``pde.PDE``, FEM elliptic problems) and the
symbolic differential operators (``operators``, a copy of the JAX
package's)."""

from .operators import (
    DifferentialOp,
    advection,
    bilaplacian,
    diffusion,
    dt,
    laplacian,
    reaction,
)
from .pde import PDE

__all__ = ["PDE", "DifferentialOp", "advection", "bilaplacian", "diffusion", "dt",
           "laplacian", "reaction"]
