"""Krylov solvers ported so far (``solvers.py``): CG, BiCGStab, their
chunked and split forms, and the Jacobi preconditioner."""

from .solvers import (
    SolveInfo,
    bicgstab,
    bicgstab_chunked,
    cg,
    cg_chunked,
    cg_split_programs,
    jacobi_preconditioner,
)

__all__ = ["SolveInfo", "bicgstab", "bicgstab_chunked", "cg", "cg_chunked",
           "cg_split_programs", "jacobi_preconditioner"]
