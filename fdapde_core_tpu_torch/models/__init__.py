"""Problem drivers ported so far: ``StructuredPoisson``, the structured-grid
fast path (fused coords->stencil kernel -> stencil operator -> multigrid
CG)."""

from .structured import StructuredPoisson

__all__ = ["StructuredPoisson"]
