"""The PDE descriptor (``pde.PDE``, FEM elliptic problems) and the
symbolic differential operators (``operators``, a copy of the JAX
package's)."""

from .operators import (
    Advection,
    BiLaplacian,
    DifferentialOp,
    Diffusion,
    Dt,
    Laplacian,
    Reaction,
    advection,
    bilaplacian,
    diffusion,
    dt,
    laplacian,
    reaction,
)
from .pde import PDE

__all__ = ["PDE", "Advection", "BiLaplacian", "DifferentialOp", "Diffusion", "Dt", "Laplacian",
           "Reaction", "advection", "bilaplacian", "diffusion", "dt", "laplacian", "reaction"]
