"""High-level multi-device elliptic driver.

Port of ``fdapde_core_tpu/models/sharded_driver.py``: assemble, reduce the
boundary data and pick the communication strategy:

- a small (col - row) offset set (structured or strongly banded dof
  numbering): DIA storage + halo-exchange CG (``parallel/halo.py``, K7,
  two halo strips per product),
- otherwise: element-sharded CG with a full-vector psum per product
  (``parallel/sharded.py``, K6 in its assembly).
"""

from __future__ import annotations

import torch

from ..fem.assembler import assemble_forcing, assemble_matrix
from ..fem.solvers import DirichletSystem
from ..fem.space import FEMSpace
from ..linear_algebra.dia import dia_from_coo, unique_offsets
from ..parallel.comm import make_device_mesh
from ..parallel.halo import HaloDIASolver
from ..parallel.sharded import ShardedPoisson

__all__ = ["solve_elliptic_sharded"]


def solve_elliptic_sharded(mesh, operator, forcing, dirichlet, order: int = 1, device_mesh=None,
                           rtol: float = 1e-10, maxiter: int = 2000, max_dia_offsets: int = 64):
    """Assemble + solve a symmetric elliptic problem over a device mesh.

    Returns (solution on every rank, info dict with strategy, iterations,
    residual and n_dofs)."""
    device_mesh = device_mesh or make_device_mesh()
    dev = device_mesh.device
    space = FEMSpace(mesh, order)
    g = torch.as_tensor(dirichlet, device=dev).to(torch.float64)
    offsets = unique_offsets(space.dofs)
    if len(offsets) <= max_dia_offsets:
        A = assemble_matrix(space, operator, device=dev)
        F = assemble_forcing(space, forcing, device=dev)
        mask = torch.as_tensor(space.boundary_dofs, device=dev)
        rows, cols, _ = space.scatter  # A's pattern on the host
        D = dia_from_coo(rows, cols, A.vals, space.n_dofs, offsets)
        b_mod = DirichletSystem(A, mask).rhs(F, g)
        solver = HaloDIASolver(D, device_mesh)
        x, res, k = solver.solve(b_mod, (~mask).to(D.data.dtype), rtol=rtol, maxiter=maxiter)
        info = {"strategy": "halo_dia", "n_offsets": len(offsets)}
    else:
        sp = ShardedPoisson(mesh, order, device_mesh, operator=operator)
        F = assemble_forcing(space, forcing, device=dev)
        x, res, k = sp.solve(F, g, rtol=rtol, maxiter=maxiter)
        info = {"strategy": "replicated_psum"}
    info.update({"iterations": int(k), "residual": float(res), "n_dofs": space.n_dofs})
    return x, info
