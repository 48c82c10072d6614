"""Time-sharded separable space-time solves: sum_k T_k (x) S_k over a mesh.

Port of ``fdapde_core_tpu/parallel/space_time.py``. The dof field u is a
(n_t, n_s) matrix row-sharded over the time axis; each term T_k (x) S_k
applies as T_k X S_k^T (the Kronecker vec identity):

- S_k along space is local to every shard (S_k replicated; a sparse S_k is
  one block product on K2 over the shard's halo-extended time rows, read
  in place through its strides),
- T_k along time is banded (spline Gram and penalty matrices), so the
  sharded-axis apply needs an H-row halo from each neighbour, H = max |band
  offset| over the terms.

CG dot products are psums of local partials; per iteration: two strips of
H n_s values and the dot products, independent of n_t.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..linear_algebra.sparse import SparseMatrix
from ..models.space_time import _apply_space_batch
from .cg import sharded_cg
from .comm import ShardMesh

__all__ = ["banded_offsets", "ShardedSpaceTime"]


def _dense(T):
    if isinstance(T, SparseMatrix):
        return T.toarray()
    return T.cpu().numpy() if isinstance(T, torch.Tensor) else np.asarray(T)


def banded_offsets(T, tol: float = 0.0):
    """Nonzero (col - row) offsets of a dense or sparse time matrix."""
    Td = _dense(T)
    n = Td.shape[0]
    return tuple(d for d in range(-(n - 1), n) if np.any(np.abs(np.diagonal(Td, offset=d)) > tol))


def _to_time_dia(T, offsets, n_pad):
    """(K, n_pad) row-indexed band storage: data[k, i] = T[i, i + off_k]."""
    Td = _dense(T)
    n = Td.shape[0]
    data = np.zeros((len(offsets), n_pad), dtype=Td.dtype)
    for k, d in enumerate(offsets):
        i0, i1 = max(0, -d), min(n, n - d)
        data[k, i0:i1] = Td[np.arange(i0, i1), np.arange(i0, i1) + d]
    return data


class ShardedSpaceTime:
    """Distributed Jacobi-CG for sum_k T_k (x) S_k, time-sharded.

    terms: [(T_k, S_k), ...]: T_k (n_t, n_t) NumPy or SparseMatrix, banded
    in time; S_k (n_s, n_s) SparseMatrix or dense, on the mesh's device.
    ``models.space_time.SeparableOperator`` semantics on one shard.
    """

    def __init__(self, terms, device_mesh: ShardMesh):
        self.device_mesh = device_mesh
        self.Pn = device_mesh.size
        dev = device_mesh.device
        T0, S0 = terms[0]
        self.n_t, self.n_s = T0.shape[0], S0.shape[0]
        self.block = block = -(-self.n_t // self.Pn)
        self.n_t_pad = block * self.Pn
        start = device_mesh.rank * block
        self.offsets, self.datas, self.spaces = [], [], []
        diag = np.zeros((self.n_t_pad, self.n_s))
        for T, S in terms:
            offs = banded_offsets(T)
            data = _to_time_dia(T, offs, self.n_t_pad)
            self.offsets.append(offs)
            self.datas.append(torch.as_tensor(data[:, start:start + block], device=dev))
            if not isinstance(S, SparseMatrix):
                S = torch.as_tensor(S, device=dev)
            self.spaces.append(S)
            if 0 in offs:
                dS = S.diagonal() if isinstance(S, SparseMatrix) else torch.diagonal(S)
                diag += data[offs.index(0)][:, None] * dS.cpu().numpy()[None, :]
        self.H = max((max(abs(d) for d in offs) for offs in self.offsets if offs), default=1)
        if self.H > block:
            raise ValueError(f"time band {self.H} exceeds block {block}; fewer devices")
        diag[self.n_t:, :] = 1.0  # padded time rows idle at the identity
        self.diag = torch.as_tensor(diag[start:start + block], device=dev)

    def _matvec(self, X_loc):
        H, block = self.H, self.block
        ext = self.device_mesh.halo_extend(X_loc, H)  # (block + 2H, n_s)
        out = torch.zeros_like(X_loc)
        for data, offs, S in zip(self.datas, self.offsets, self.spaces):
            V = _apply_space_batch(S, ext)
            for k, d in enumerate(offs):
                out = out + data[k][:, None] * V[H + d:H + d + block]
        return out

    def _solve(self, b, rtol, maxiter):
        inv_diag = 1.0 / self.diag
        x, rz, k, _ = sharded_cg(self._matvec, lambda r: inv_diag * r, b, self.device_mesh, rtol,
                                 maxiter, stop="preconditioned")
        x = self.device_mesh.all_gather(x)[: self.n_t]
        return x.reshape(-1), torch.sqrt(rz.abs()), k

    def solve(self, b, rtol: float = 1e-10, maxiter: int = 20000, recovery=True):
        """Returns (x on every rank, sqrt(final r.z), iterations). A
        non-finite or budget-exhausted solve gets one retry with a 3x
        iteration budget."""
        b = torch.as_tensor(b, device=self.device_mesh.device).to(self.diag.dtype)
        start = self.device_mesh.rank * self.block
        loc = b.reshape(self.n_t, self.n_s)[start:start + self.block]
        b = F.pad(loc, (0, 0, 0, self.block - loc.shape[0]))
        x, res, iters = self._solve(b, rtol, maxiter)
        if recovery and (not math.isfinite(float(res)) or iters >= maxiter):
            warnings.warn(f"time-sharded space-time solve stalled (res = {float(res):.2e}); "
                          "escalating with a 3x iteration budget", stacklevel=2)
            x, res, iters = self._solve(b, rtol, 3 * maxiter)
        return x, res, iters
