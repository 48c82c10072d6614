"""Device ops: closed-form P1 stiffness and its kernels (K4, K5, K6), grid
stencil operators, the fused coords->stencil assembly kernel (K1), Jacobi
CG and geometric multigrid on grid stencils; the general-mesh SoA
pipeline (P1 and P2), its assembled ELL and the ELL gather SpMV kernel
(K2), the banded split with its multigrid, and the auxiliary-grid
preconditioner, both its interpolations on K2 (``LaneAuxGrid`` is its
name on the lane path)."""

from .auxgrid import AuxGridPreconditioner, interp_transpose_ell
from .closed_form import SYM_TO_FULL, p1_stiffness_2d_sym
from .dia_split import (
    BandedMGPreconditioner,
    BandedSplit,
    banded_cg,
    build_banded_split,
    plan_split_width,
)
from .gather_spmv import LaneRoutedELL, ell_spmv, ell_spmv_reference
from .grid_assembly import GRID_OFFSETS2D, stencil_from_coords
from .grid_dia import GridDIAMatrix, prune_zero_offsets_grid
from .lane_aux import LaneAuxGrid, lane_friendly_grid_n
from .local_stiffness import p1_stiffness_2d, p1_stiffness_edges, p1_stiffness_edges_offdiag
from .matfree_soa import ELLSoA, MatrixFreeP2SoA, MatrixFreeSoA, ell_from_op_blocked

__all__ = [
    "AuxGridPreconditioner",
    "BandedMGPreconditioner",
    "BandedSplit",
    "ELLSoA",
    "GRID_OFFSETS2D",
    "GridDIAMatrix",
    "LaneAuxGrid",
    "LaneRoutedELL",
    "MatrixFreeP2SoA",
    "MatrixFreeSoA",
    "SYM_TO_FULL",
    "banded_cg",
    "build_banded_split",
    "ell_from_op_blocked",
    "ell_spmv",
    "ell_spmv_reference",
    "interp_transpose_ell",
    "lane_friendly_grid_n",
    "p1_stiffness_2d",
    "p1_stiffness_2d_sym",
    "p1_stiffness_edges",
    "p1_stiffness_edges_offdiag",
    "plan_split_width",
    "prune_zero_offsets_grid",
    "stencil_from_coords",
]
