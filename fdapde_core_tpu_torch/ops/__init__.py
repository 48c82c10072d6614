"""Device ops of the structured path: closed-form P1 stiffness, grid
stencil operators, the fused coords->stencil assembly kernel, Jacobi CG and
geometric multigrid on grid stencils."""

from .closed_form import SYM_TO_FULL, p1_stiffness_2d_sym
from .grid_assembly import GRID_OFFSETS2D, stencil_from_coords
from .grid_dia import GridDIAMatrix, prune_zero_offsets_grid

__all__ = [
    "GRID_OFFSETS2D",
    "GridDIAMatrix",
    "SYM_TO_FULL",
    "p1_stiffness_2d_sym",
    "prune_zero_offsets_grid",
    "stencil_from_coords",
]
