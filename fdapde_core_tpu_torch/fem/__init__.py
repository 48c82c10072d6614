"""FEM: reference elements and Lagrange bases (host copies), ``FEMSpace``,
batched assembly into sparse or DIA storage (``assembler``), the
Dirichlet-masked solvers (``solvers``) and basis evaluation at data
locations (``evaluation``)."""

from .assembler import assemble_dia, assemble_forcing, assemble_matrix, local_matrices
from .evaluation import basis_expansion, eval_basis_areal, eval_basis_pointwise
from .solvers import DirichletSystem, masked_matrix, solve_elliptic
from .space import FEMSpace

__all__ = ["DirichletSystem", "FEMSpace", "assemble_dia", "assemble_forcing", "assemble_matrix",
           "basis_expansion", "eval_basis_areal", "eval_basis_pointwise", "local_matrices",
           "masked_matrix", "solve_elliptic"]
