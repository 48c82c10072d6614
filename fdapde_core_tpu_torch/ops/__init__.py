"""Device ops: closed-form P1 stiffness and its kernels (K4, K5, K6), grid
stencil operators, the fused coords->stencil assembly kernel (K1), Jacobi
CG and geometric multigrid on grid stencils; the general-mesh SoA
pipeline, its assembled ELL and the ELL gather SpMV kernel (K2), band
detection and the auxiliary-grid preconditioner."""

from .auxgrid import AuxGridPreconditioner
from .closed_form import SYM_TO_FULL, p1_stiffness_2d_sym
from .dia_split import plan_split_width
from .gather_spmv import LaneRoutedELL, ell_spmv, ell_spmv_reference
from .grid_assembly import GRID_OFFSETS2D, stencil_from_coords
from .grid_dia import GridDIAMatrix, prune_zero_offsets_grid
from .local_stiffness import p1_stiffness_2d, p1_stiffness_edges, p1_stiffness_edges_offdiag
from .matfree_soa import ELLSoA, MatrixFreeSoA, ell_from_op_blocked

__all__ = [
    "AuxGridPreconditioner",
    "ELLSoA",
    "GRID_OFFSETS2D",
    "GridDIAMatrix",
    "LaneRoutedELL",
    "MatrixFreeSoA",
    "SYM_TO_FULL",
    "ell_from_op_blocked",
    "ell_spmv",
    "ell_spmv_reference",
    "p1_stiffness_2d",
    "p1_stiffness_2d_sym",
    "p1_stiffness_edges",
    "p1_stiffness_edges_offdiag",
    "plan_split_width",
    "prune_zero_offsets_grid",
    "stencil_from_coords",
]
