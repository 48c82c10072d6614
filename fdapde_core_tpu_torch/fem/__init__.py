"""FEM solvers ported so far: ``DirichletSystem`` (symmetric masking)."""

from .solvers import DirichletSystem

__all__ = ["DirichletSystem"]
