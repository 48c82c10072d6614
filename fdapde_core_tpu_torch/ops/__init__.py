"""Device ops: closed-form P1 stiffness (2D and tets) and its kernels (K4,
K5, K6), grid stencil operators in 2D and 3D, the fused coords->stencil
assembly kernel (K1), Jacobi CG and geometric multigrid on grid stencils
(2D and 3D); the general-mesh SoA pipeline (P1 and P2 on triangles, P1 on
tets), its assembled ELL and the ELL gather SpMV kernel (K2), the banded
splits with their multigrid (2D and 3D), and the auxiliary-grid
preconditioners (2D and 3D), both interpolations on K2 (``LaneAuxGrid``
is the 2D grid's name on the lane path); the element-local AoS forms
(``ell``, ``matfree``) and the C-last assembly (``soa_assembly``); and
``WindowedELL``, the block-windowed ELL of scattered bands, on K2.

``ell_spmv`` here is K2's wrapper (``gather_spmv.ell_spmv``); the JAX
package's ``ops.ell_spmv``, the element-local combine, is ``ell.ell_spmv``.
"""

from .auxgrid import AuxGridPreconditioner, AuxGridPreconditioner3D, interp_transpose_ell
from .closed_form import (
    SYM4_TO_FULL,
    SYM_TO_FULL,
    p1_stiffness_2d_sym,
    p1_stiffness_3d_sym,
    pack_cell_axis,
)
from .dia_split import (
    BandedMGPreconditioner,
    BandedSplit,
    banded_cg,
    build_banded_split,
    plan_split_width,
)
from .dia_split3d import (
    BandedMGPreconditioner3D,
    BandedSplit3D,
    build_banded_split_3d,
    plan_split_3d,
)
from .ell import ELLMatrix, build_ell_adjacency, local_matvec
from .gather_spmv import ELLSoA, LaneRoutedELL, ell_spmv, ell_spmv_reference
from .grid3d import GridDIA3D, p1_cube_stencil, prune_zero_offsets_grid3d
from .grid_assembly import GRID_OFFSETS2D, stencil_from_coords
from .grid_dia import GridDIAMatrix, prune_zero_offsets_grid
from .grid_mg3d import GridMG3D
from .lane_aux import LaneAuxGrid, lane_friendly_grid_n
from .local_stiffness import p1_stiffness_2d, p1_stiffness_edges, p1_stiffness_edges_offdiag
from .matfree import MatrixFreeLocal, p1_local_stiffness, p1_local_stiffness_3d
from .matfree_soa import (
    MatrixFreeP2SoA,
    MatrixFreeSoA,
    MatrixFreeSoA3D,
    ell_from_op_blocked,
)
from .window_spmv import WindowedELL, window_bandwidth

__all__ = [
    "AuxGridPreconditioner",
    "AuxGridPreconditioner3D",
    "BandedMGPreconditioner",
    "BandedMGPreconditioner3D",
    "BandedSplit",
    "BandedSplit3D",
    "ELLMatrix",
    "ELLSoA",
    "GRID_OFFSETS2D",
    "GridDIA3D",
    "GridDIAMatrix",
    "GridMG3D",
    "LaneAuxGrid",
    "LaneRoutedELL",
    "MatrixFreeLocal",
    "MatrixFreeP2SoA",
    "MatrixFreeSoA",
    "MatrixFreeSoA3D",
    "SYM4_TO_FULL",
    "SYM_TO_FULL",
    "WindowedELL",
    "banded_cg",
    "build_banded_split",
    "build_banded_split_3d",
    "build_ell_adjacency",
    "ell_from_op_blocked",
    "ell_spmv",
    "ell_spmv_reference",
    "interp_transpose_ell",
    "lane_friendly_grid_n",
    "local_matvec",
    "p1_cube_stencil",
    "p1_local_stiffness",
    "p1_local_stiffness_3d",
    "p1_stiffness_2d",
    "p1_stiffness_2d_sym",
    "p1_stiffness_3d_sym",
    "pack_cell_axis",
    "plan_split_3d",
    "plan_split_width",
    "prune_zero_offsets_grid",
    "prune_zero_offsets_grid3d",
    "stencil_from_coords",
    "window_bandwidth",
]
