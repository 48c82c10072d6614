"""Element-sharded FEM assembly and a replicated-vector CG over a ShardMesh.

Port of ``fdapde_core_tpu/parallel/sharded.py``:

- elements are partitioned into contiguous SFC blocks, one per shard
  (``partition.py``); each shard computes its block's local matrices with
  no communication: the 2D P1 Laplacian term on K6 (``p1_stiffness_2d``,
  as ``fem/assembler.py`` takes it), every other term by the einsums of
  ``fem/assembler.local_matrices``;
- the dof vector is replicated; a product is the local gather x[dofs], the
  batched (nb x nb) contraction, a fixed-order combine onto the dof vector
  (``spmv="segment"``: a ``SegmentSum`` of the block's dof ids;
  ``spmv="ell"``: the block's ``build_ell_adjacency`` table, JAX's
  scatter-free form; both add each dof's incidences in increasing
  position) and one ``psum``;
- CG runs replicated: dot products of replicated vectors need no
  collective, so an iteration costs one psum, the product's.

``preconditioner="auxgrid"`` replicates the aux-grid apply on every shard
(``ops/auxgrid.py``: P^T on K2's sliced form, V-cycle, P on K2's compact
form) with the true Jacobi term from the psum'd diagonal. JAX's
``lax.while_loop`` is a host loop (``cg.sharded_cg``).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..fem.assembler import _KIND, _mesh_tensors, _p1_2d_coords, local_matrices, prepare_coefficient
from ..fem.space import FEMSpace
from ..geometry.affine import affine_maps
from ..linear_algebra.sparse import SegmentSum
from ..ops.ell import build_ell_adjacency
from .cg import sharded_cg
from .comm import ShardMesh, make_device_mesh
from .partition import partition_elements

__all__ = ["make_device_mesh", "ShardedPoisson"]

_REPLICATED = ShardMesh(None, "cpu")  # psum of replicated dot products: the identity


class ShardedPoisson:
    """Sharded assemble + solve for diffusion-type operators, P1/P2 Lagrange.

    Partitions the cells over the device mesh; ``solve`` assembles this
    shard's local matrices and runs the preconditioned CG; ``assemble`` and
    ``cg`` are the two stages alone. Every rank returns the full solution.
    """

    def __init__(self, mesh, order: int = 1, device_mesh: ShardMesh | None = None,
                 dtype=None, operator=None, preconditioner: str = "jacobi",
                 spmv: str = "segment", max_degree: int | None = None):
        from ..pde.operators import BiLaplacian, Laplacian, laplacian

        self.mesh = mesh
        self.operator = operator if operator is not None else -laplacian()
        self.space = FEMSpace(mesh, order)
        self.device_mesh = device_mesh or make_device_mesh()
        self.n_shards = self.device_mesh.size
        self.dtype = torch.float64 if dtype is None else dtype
        dev = self.device = self.device_mesh.device

        perm, live, block = partition_elements(mesh, self.n_shards)
        self.block = block
        self._cells = np.ascontiguousarray(mesh.cells[perm])  # (S*B, k), host
        self._dofs = np.ascontiguousarray(self.space.dofs[perm])  # (S*B, nb), host
        self._live = live.astype(np.float64)  # padded copies get weight 0
        self.n_dofs = self.space.n_dofs

        mine = slice(self.device_mesh.rank * block, (self.device_mesh.rank + 1) * block)
        nodes, _, self._phi, self._grad, self._w = _mesh_tensors(self.space, self.dtype, dev)
        self._nodes = nodes
        self._cells_d = torch.as_tensor(self._cells[mine], device=dev).long()
        self._dofs_d = torch.as_tensor(self._dofs[mine], device=dev).long()
        self._live_d = torch.as_tensor(self._live[mine], device=dev).to(self.dtype)
        self._bmask = torch.as_tensor(self.space.boundary_dofs, device=dev)

        self.preconditioner = preconditioner
        self._aux = None
        if preconditioner == "auxgrid":
            from ..ops.auxgrid import AuxGridPreconditioner, AuxGridPreconditioner3D

            coords = self.space.dof_coords
            cls = AuxGridPreconditioner3D if coords.shape[1] == 3 else AuxGridPreconditioner
            # dinv is replaced by the psum'd diagonal's inside the solve
            self._aux = cls.build(coords, np.ones(self.n_dofs), dtype=self.dtype, device=dev)
        elif preconditioner != "jacobi":
            raise ValueError(preconditioner)

        # constant coefficients stay tensors; space-varying ones (callables
        # at quadrature nodes, or arrays in the nq*cell+q layout) become
        # per-cell arrays in SFC order, this shard's block of them
        self._terms = []  # (scale, kind, varying, coeff)
        for scale, leaf in self.operator.spatial_terms:
            if isinstance(leaf, BiLaplacian):
                raise ValueError("bilaplacian is SPLINE-only")
            kind, ckind = _KIND[type(leaf)]
            if isinstance(leaf, Laplacian):
                varying, coeff = False, None
            else:
                cval = leaf.K if kind == "diffusion" else leaf.b if kind == "advection" else leaf.c
                varying, coeff = prepare_coefficient(self.space, cval, ckind, self.dtype, dev)
                if varying:
                    coeff = coeff[torch.as_tensor(perm[mine], device=dev).long()]
            self._terms.append((scale, kind, varying, coeff))
        self._coords_t = _p1_2d_coords(self.space, nodes, self._cells_d)

        self.spmv = spmv
        if spmv == "ell":
            if max_degree is None:
                max_degree = int(np.bincount(self._dofs.reshape(-1), minlength=self.n_dofs).max())
            adj, amask, over = build_ell_adjacency(self._dofs_d.reshape(-1).to(torch.int32),
                                                   self.n_dofs, max_degree)
            if bool(over):
                raise ValueError(f"a dof exceeds max_degree={max_degree} incidences in its shard; "
                                 "rebuild with a larger bound")
            adj = adj.long()

            def combine(ye_flat):
                return (ye_flat[adj] * amask.to(ye_flat.dtype)).sum(dim=1)
        elif spmv == "segment":
            combine = SegmentSum.build(self._dofs[mine].reshape(-1), self.n_dofs, dev)
        else:
            raise ValueError(spmv)
        self._combine = combine

    # -- sharded local assembly ----------------------------------------------
    def _local_matrices(self):
        """(B, nb, nb) local matrices of this shard's block (padded cells 0)."""
        live = self._live_d
        invJ = meff = None
        if any(kind != "laplacian" or self._coords_t is None for _, kind, _, _ in self._terms):
            _, invJ, measure = affine_maps(self._nodes, self._cells_d)
            meff = measure * live
        nb = self.space.n_basis_per_cell
        out = torch.zeros((self.block, nb, nb), dtype=self.dtype, device=self.device)
        for scale, kind, varying, coeff in self._terms:
            if kind == "laplacian" and self._coords_t is not None:  # K6
                term = local_matrices(kind, None, False, None, None, None, None, None,
                                      self._coords_t) * live[:, None, None]
            else:
                term = local_matrices(kind, coeff, varying, self._phi, self._grad, self._w, invJ,
                                      meff)
            out = out + scale * term
        return out

    def assemble(self):
        """The local matrices of every shard, (S*B, nb, nb), on every rank
        (JAX's sharded array, gathered)."""
        return self.device_mesh.all_gather(self._local_matrices())

    def _mine(self, A_loc):
        """This shard's block of an (S*B, nb, nb) array (or the block itself)."""
        if A_loc.shape[0] == self.block:
            return A_loc
        r = self.device_mesh.rank
        return A_loc[r * self.block:(r + 1) * self.block]

    # -- replicated CG ---------------------------------------------------------
    def _partial(self, A_loc, x, free):
        """This shard's partial A @ (x * free), psum'd by the caller."""
        xe = (x * free)[self._dofs_d]  # (B, nb) local gather
        ye = torch.einsum("cij,cj->ci", A_loc, xe)
        return self._combine(ye.reshape(-1))

    def _cg(self, A_loc, b, g, rtol, maxiter):
        psum = self.device_mesh.psum
        bmask = self._bmask
        free = (~bmask).to(b.dtype)
        pinned = bmask.to(b.dtype)

        def Ax(x):
            return psum(self._partial(A_loc, x, free)) * free + x * pinned

        dloc = torch.diagonal(A_loc, dim1=1, dim2=2).reshape(-1)
        diag = psum(self._combine(dloc)) * free + pinned
        inv_diag = 1.0 / torch.where(diag.abs() > 0, diag, 1.0)
        if self._aux is not None:
            aux = self._aux

            def prec(r):
                # the replicated aux-grid apply with the true Jacobi term
                z = aux(r) - aux.omega * aux.dinv * r
                return z + aux.omega * inv_diag * r
        else:
            def prec(r):
                return inv_diag * r

        # boundary data to the right-hand side by the unmasked column action
        gm = g * pinned
        col_action = psum(self._partial(A_loc, gm, torch.ones_like(free)))
        b_mod = (b - col_action) * free + gm
        x, rr, k, _ = sharded_cg(Ax, prec, b_mod, _REPLICATED, rtol, maxiter, x0=gm)
        return x, torch.sqrt(rr), k

    def cg(self, A_loc, b, g, rtol=1e-6, maxiter=200):
        """CG on assembled local matrices (``assemble()``'s, or this shard's
        block of them): (x, ||r||, iterations)."""
        b = torch.as_tensor(b, device=self.device).to(self.dtype)
        g = torch.as_tensor(g, device=self.device).to(self.dtype)
        return self._cg(self._mine(A_loc), b, g, rtol, maxiter)

    def solve(self, b, g, rtol=1e-6, maxiter=200, recovery=True):
        """Assemble + CG: (x, ||r||, iterations), x on every rank.

        Failure recovery: a stalled or non-finite distributed CG gets one
        retry with a 3x iteration budget."""
        b = torch.as_tensor(b, device=self.device).to(self.dtype)
        g = torch.as_tensor(g, device=self.device).to(self.dtype)
        A_loc = self._local_matrices()
        x, res, k = self._cg(A_loc, b, g, rtol, maxiter)
        if recovery and (not math.isfinite(float(res)) or k >= maxiter):
            # k == maxiter is the budget's exit; the loop's tolerance refers to
            # the boundary-reduced rhs, so res alone is not compared to rtol
            warnings.warn(f"sharded solve stalled (||r|| = {float(res):.2e}); escalating "
                          "with a 3x iteration budget", stacklevel=2)
            x, res, k = self._cg(A_loc, b, g, rtol, 3 * maxiter)
        return x, res, k
