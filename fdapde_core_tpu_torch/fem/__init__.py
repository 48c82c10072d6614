"""FEM: reference elements and Lagrange bases (host copies), ``FEMSpace``,
batched assembly into sparse or DIA storage (``assembler``), the
Dirichlet-masked elliptic and implicit-Euler solvers (``solvers``),
basis evaluation at data locations (``evaluation``), Neumann boundary loads
(``neumann``) and the semilinear Newton solver (``nonlinear``)."""

from . import neumann, nonlinear

from .assembler import assemble_dia, assemble_forcing, assemble_matrix, local_matrices
from .basis import LagrangeBasis, tabulate_basis
from .evaluation import basis_expansion, eval_basis_areal, eval_basis_pointwise
from .reference_element import reference_nodes
from .solvers import DirichletSystem, masked_matrix, solve_elliptic, solve_parabolic
from .space import FEMSpace

__all__ = ["DirichletSystem", "FEMSpace", "LagrangeBasis", "assemble_dia", "assemble_forcing",
           "assemble_matrix", "basis_expansion", "eval_basis_areal", "eval_basis_pointwise",
           "local_matrices", "masked_matrix", "reference_nodes", "solve_elliptic",
           "solve_parabolic", "tabulate_basis"]
