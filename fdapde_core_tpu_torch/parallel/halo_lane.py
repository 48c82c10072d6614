"""Distributed scattered-topology CG with a distributed aux-grid apply.

Port of ``fdapde_core_tpu/parallel/halo_lane.py``. On the TPU each shard's
(block, block + 2H) operator was embedded as a square operator and served
by the lane-routed Pallas SpMV, with routing tables per shard, a COO
remainder and a refusal of bands wider than one 128-lane tile. A GPU
thread gathers from anywhere, so the port keeps the solver's contract and
drops the routing (as ``ops/gather_spmv.LaneRoutedELL`` does):

- dof rows in contiguous blocks with H-wide halo strips, the local product
  K2's compact form on the halo-extended vector (``HaloELLSolver``'s);
  ``p_max`` and ``rounds`` are accepted and ignored, nothing falls to a
  remainder (``n_remainder == 0``), and only the one-hop limit H <= block
  remains;
- the preconditioner is per-shard Jacobi or the DISTRIBUTED aux-grid apply
  (``ops/auxgrid.py``): each shard restricts its residual rows onto the
  replicated grid (P^T of its rows on K2's sliced form), one ``psum``
  assembles the grid residual, the V-cycle runs replicated, and each shard
  prolongs its rows back (P on K2's compact form). One grid-sized psum per
  CG iteration.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..ops.auxgrid import interp_transpose_ell
from ..ops.gather_spmv import ELLSoA
from .comm import ShardMesh
from .halo_ell import HaloELLSolver

__all__ = ["HaloLaneSolver"]


class HaloLaneSolver(HaloELLSolver):
    """Distributed preconditioned CG over per-shard ELL tables.

    E: ``ops/gather_spmv.ELLSoA`` with bandwidth H <= block (RCM first).
    aux: an ``AuxGridPreconditioner`` (or its 3D form) built for this dof
    numbering, applied distributed; None: per-shard Jacobi.
    """

    def __init__(self, E, device_mesh: ShardMesh, aux=None, p_max: int | None = None,
                 rounds: int = 16):
        super().__init__(E, device_mesh)
        self.aux = aux
        self.n_remainder = 0
        self.aux_parts = None
        if aux is not None:
            # this shard's columns of the (k, n) interpolation table, padded
            # past n with weight 0; the grid hierarchy stays replicated
            start, block = device_mesh.rank * self.block, self.block
            idx = aux.idx[:, start:start + block]
            w = aux.w[:, start:start + block]
            dinv = aux.dinv[start:start + block]
            pad = block - idx.shape[1]
            idx = F.pad(idx, (0, pad))
            w = F.pad(w, (0, pad))
            dinv = F.pad(dinv, (0, pad), value=1.0)
            mm = (aux.n_grid + 1) ** aux.DIM
            self.aux_parts = (ELLSoA(w, idx, (block, mm)), dinv, aux.mg,
                              interp_transpose_ell(idx, w, block, mm))

    def _prec(self, free):
        if self.aux_parts is None:
            return super()._prec(free)
        P, dinv, mg, PT = self.aux_parts
        omega = float(self.aux.omega)
        psum = self.device_mesh.psum

        def pre(r):
            rw = r.to(dinv.dtype)
            z = P @ mg.v_cycle(psum(PT @ rw))
            return (omega * dinv * rw + z).to(r.dtype) * free

        return pre

    def solve(self, b, free_mask, rtol=1e-10, maxiter=1000):
        """Solve A x = b with Dirichlet dofs pinned where free_mask == 0
        (b carries the boundary values). Returns (x[:n] on every rank,
        ||r||, iterations)."""
        return super().solve(b, free_mask, rtol, maxiter, recovery=False)
