"""Problem drivers ported so far: ``StructuredPoisson``, the structured-grid
fast path (fused coords->stencil kernel -> stencil operator -> multigrid
CG); the general-mesh gather path, ``MatrixFreePoisson`` and
``MatrixFreeElliptic`` (assembled ELL on the K2 gather SpMV kernel ->
aux-grid preconditioned Krylov solve); and the data-fitting models,
``SmoothingRegression`` (fit, predict, GCV) and the Kronecker-structured
space-time layer (``SeparableOperator``, ``solve_space_time``,
``SpaceTimeSmoothing``), whose sparse products all run on K2."""

from ..pde import PDE
from .matfree import MatrixFreeElliptic, MatrixFreeParabolic, MatrixFreePoisson
from .regression import SmoothingRegression
from .space_time import (
    ModeDiagPreconditioner,
    ModeMGPreconditioner,
    SeparableOperator,
    SpaceTimeSmoothing,
    solve_space_time,
    solve_space_time_fdm,
)
from .structured import StructuredPoisson

__all__ = ["MatrixFreeElliptic", "MatrixFreeParabolic", "MatrixFreePoisson",
           "ModeDiagPreconditioner", "ModeMGPreconditioner", "PDE", "SeparableOperator",
           "SmoothingRegression", "SpaceTimeSmoothing", "StructuredPoisson",
           "solve_space_time", "solve_space_time_fdm"]
