"""Problem drivers ported so far: ``StructuredPoisson``, the structured-grid
fast path (fused coords->stencil kernel -> stencil operator -> multigrid
CG), and the general-mesh gather path, ``MatrixFreePoisson`` and
``MatrixFreeElliptic`` (assembled ELL on the K2 gather SpMV kernel ->
aux-grid preconditioned Krylov solve)."""

from .matfree import MatrixFreeElliptic, MatrixFreeParabolic, MatrixFreePoisson
from .structured import StructuredPoisson

__all__ = ["MatrixFreeElliptic", "MatrixFreeParabolic", "MatrixFreePoisson",
           "StructuredPoisson"]
