"""Linear algebra ported so far: the sorted-COO ``SparseMatrix`` with
fixed-order sums (``sparse.py``), DIA storage on the K7 kernel
(``dia.py``) and the Krylov solvers (``solvers.py``): CG, BiCGStab, GMRES,
the chunked and split forms, and the Jacobi preconditioner."""

from .dia import DIAMatrix, dia_from_coo, prune_zero_offsets, unique_offsets
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

__all__ = ["DIAMatrix", "SegmentSum", "SolveInfo", "SparseMatrix", "bicgstab",
           "bicgstab_chunked", "cg", "cg_chunked", "cg_split_programs", "coo_sum_duplicates",
           "dia_from_coo", "gmres", "jacobi_preconditioner", "prune_zero_offsets",
           "unique_offsets"]
