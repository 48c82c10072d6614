"""Linear algebra ported so far: the sorted-COO ``SparseMatrix`` with
fixed-order sums (``sparse.py``), DIA storage on the K7 kernel
(``dia.py``), the Krylov solvers (``solvers.py``: CG, BiCGStab, GMRES,
the chunked and split forms, the Jacobi preconditioner, ``dense_solve``,
``iterative_refinement``), Kronecker products (``kron.py``), the
Sherman-Morrison-Woodbury solve (``smw.py``), row-sum mass lumping
(``lumping.py``) and smoothed-aggregation AMG (``amg.py``: host set-up,
V-cycle on K2)."""

from .amg import AMG, aggregate, amg_preconditioned_cg, strength_graph
from .dia import DIAMatrix, dia_from_coo, prune_zero_offsets, unique_offsets
from .kron import KroneckerOperator, kron, kron_matvec
from .lumping import lump
from .smw import smw_solve
from .solvers import (
    SolveInfo,
    bicgstab,
    bicgstab_chunked,
    cg,
    cg_chunked,
    cg_split_programs,
    dense_solve,
    gmres,
    iterative_refinement,
    jacobi_preconditioner,
)
from .sparse import SegmentSum, SparseMatrix, coo_sum_duplicates

__all__ = ["AMG", "DIAMatrix", "KroneckerOperator", "SegmentSum", "SolveInfo", "SparseMatrix",
           "aggregate", "amg_preconditioned_cg", "bicgstab", "bicgstab_chunked", "cg",
           "cg_chunked", "cg_split_programs", "coo_sum_duplicates", "dense_solve",
           "dia_from_coo", "gmres", "iterative_refinement", "jacobi_preconditioner", "kron",
           "kron_matvec", "lump", "prune_zero_offsets", "smw_solve", "strength_graph",
           "unique_offsets"]
