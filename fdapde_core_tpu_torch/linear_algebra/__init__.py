"""Linear algebra ported so far: the sorted-COO ``SparseMatrix`` with
fixed-order sums (``sparse.py``) and the Krylov solvers (``solvers.py``):
CG, BiCGStab, GMRES, the chunked and split forms, and the Jacobi
preconditioner."""

from .solvers import (
    SolveInfo,
    bicgstab,
    bicgstab_chunked,
    cg,
    cg_chunked,
    cg_split_programs,
    gmres,
    jacobi_preconditioner,
)
from .sparse import SegmentSum, SparseMatrix, coo_sum_duplicates

__all__ = ["SegmentSum", "SolveInfo", "SparseMatrix", "bicgstab", "bicgstab_chunked", "cg",
           "cg_chunked", "cg_split_programs", "coo_sum_duplicates", "gmres",
           "jacobi_preconditioner"]
