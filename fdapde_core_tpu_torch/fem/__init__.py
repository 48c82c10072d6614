"""FEM: reference elements and Lagrange bases (host copies), ``FEMSpace``,
batched assembly into sparse or DIA storage (``assembler``) and the
Dirichlet-masked solvers (``solvers``)."""

from .assembler import assemble_dia, assemble_forcing, assemble_matrix, local_matrices
from .solvers import DirichletSystem, masked_matrix, solve_elliptic
from .space import FEMSpace

__all__ = ["DirichletSystem", "FEMSpace", "assemble_dia", "assemble_forcing", "assemble_matrix",
           "local_matrices", "masked_matrix", "solve_elliptic"]
