"""B-spline discretization (1D/time): basis, space and assembly.

Port of ``fdapde_core_tpu/splines/``: the reference's compile-time Cox-de
Boor recursion (splines/basis/spline.h) is a vectorized de Boor triangle
over (points x basis) arrays; the per-pair knot-span assembly loop
(spline_assembler.h:56-69) is one Gram product B^T W B over all
Gauss-Legendre points at once. Host NumPy, with matrices and vectors handed
to the caller's device.
"""

from .assembler import assemble_forcing, assemble_mass, assemble_operator
from .basis import SplineBasis, spline_basis_matrix
from .space import SplineSpace

__all__ = [
    "SplineBasis",
    "SplineSpace",
    "assemble_forcing",
    "assemble_mass",
    "assemble_operator",
    "spline_basis_matrix",
]
