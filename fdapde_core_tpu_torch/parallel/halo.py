"""Halo-exchange distributed CG over DIA (offset-diagonal) operators.

Port of ``fdapde_core_tpu/parallel/halo.py``. The dof vector is split into
contiguous blocks, one per shard; a DIA product needs each shard's
neighbours' edge strips of width H = max |offset|, exchanged by
``ShardMesh.halo`` (JAX: two ``ppermute``). CG dot products are psums of
local partials (``cg.sharded_cg``).

The local product is K7 (``ops/dia_spmv.dia_spmv``), which is square: each
shard keeps its (K, block) diagonals padded with H zero columns on either
side, (K, block + 2H), and K7 runs over the halo-extended vector; rows
[H, H + block) of the result are the shard's y (the 2H padded rows cost
2H / block of the launch). ``HaloDIAParabolic``'s time loop is a host loop
where JAX's is a ``lax.scan``.
"""

from __future__ import annotations

import copy
import math
import warnings

import torch
import torch.nn.functional as F

from ..linear_algebra.dia import DIAMatrix
from ..ops.dia_spmv import dia_spmv
from .cg import sharded_cg
from .comm import ShardMesh

__all__ = ["HaloDIASolver", "HaloDIAParabolic"]


def _maybe_escalate(solver, float_attrs, args, x, res, k, bnorm, rtol, maxiter):
    """One escalation of a distributed Krylov solve whose residual is
    non-finite or above tol: an f32 operator is recast to f64 and re-run,
    an f64 one gets a tripled iteration budget (JAX's rule)."""
    resf, bnf = float(res), float(bnorm)
    if math.isfinite(resf) and resf <= rtol * bnf:
        return x, res, k
    if isinstance(float_attrs, str):
        float_attrs = (float_attrs,)
    if getattr(solver, float_attrs[0]).dtype == torch.float32:
        warnings.warn("distributed CG stalled at f32 "
                      f"(||r||/||b|| = {resf / max(bnf, 1e-300):.2e}); "
                      "escalating to an f64 recast of the operator", stacklevel=3)
        s2 = copy.copy(solver)
        for a in float_attrs:
            setattr(s2, a, getattr(solver, a).to(torch.float64))
        s2.dtype = torch.float64
        args = tuple(a.to(torch.float64) if a.dtype in (torch.float32, torch.bfloat16) else a
                     for a in args)
        x, res, k, _ = s2._solve(*args, rtol, maxiter)
    else:
        warnings.warn("distributed CG stalled "
                      f"(||r||/||b|| = {resf / max(bnf, 1e-300):.2e}); "
                      "escalating with a 3x iteration budget", stacklevel=3)
        x, res, k, _ = solver._solve(*args, rtol, 3 * maxiter)
    return x, res, k


def _inv_diag(diag, free):
    """Jacobi inverse on free rows, 1 on pinned ones (JAX's guarded form)."""
    inv = torch.where(diag.abs() > 0, 1.0 / torch.where(diag == 0, 1.0, diag), 1.0)
    return inv * free + (1 - free)


class HaloDIASolver:
    """Distributed Jacobi-CG for a DIAMatrix over a 1D ShardMesh."""

    def __init__(self, dia, device_mesh: ShardMesh):
        self.offsets = tuple(int(d) for d in dia.offsets)
        self.H = max(abs(d) for d in self.offsets)
        self.device_mesh = device_mesh
        self.P = device_mesh.size
        self.n = n = dia.n
        self.block = -(-n // self.P)
        self.n_pad = self.block * self.P
        if self.H > self.block:
            raise ValueError(f"halo width {self.H} exceeds block size {self.block}; "
                             "use fewer devices or reorder dofs")
        self.data = self._local(torch.as_tensor(dia.data, device=device_mesh.device))
        self.dtype = self.data.dtype
        self._offsets_dev = torch.tensor(self.offsets, dtype=torch.int64).to(device_mesh.device)

    def _local(self, data):
        """This shard's (K, block) columns, zero-padded past n and by H
        on either side: (K, block + 2H)."""
        start = self.device_mesh.rank * self.block
        loc = data[:, start:start + self.block]
        return F.pad(loc, (self.H, self.H + self.block - loc.shape[1])).contiguous()

    def _pad_local(self, v):
        """This shard's rows of a global (n, ...) array, zero-padded."""
        v = torch.as_tensor(v, device=self.device_mesh.device).to(self.dtype)
        start = self.device_mesh.rank * self.block
        loc = v[start:start + self.block]
        pad = [0, 0] * (v.dim() - 1) + [0, self.block - loc.shape[0]]
        return F.pad(loc, pad)

    def _spmv(self, data, x):
        """Rows of this shard of A x, from the halo-extended x (K7)."""
        H = self.H
        ext = self.device_mesh.halo_extend(x, H)
        return dia_spmv(data, self._offsets_dev, ext)[H:H + self.block]

    def _solve(self, b, free, rtol, maxiter, x0=None):
        H = self.H
        inv_diag = _inv_diag(self.data[self.offsets.index(0), H:H + self.block], free)

        def Ax(x):
            return self._spmv(self.data, x * free) * free + x * (1 - free)

        x, rr, k, bb = sharded_cg(Ax, lambda r: inv_diag * r, b, self.device_mesh, rtol, maxiter,
                                  x0=x0)
        return x, torch.sqrt(rr), k, torch.sqrt(bb)

    def _gather(self, x):
        return self.device_mesh.all_gather(x)[: self.n]

    def solve(self, b, free_mask, rtol=1e-10, maxiter=1000, recovery=True):
        """Solve A x = b with Dirichlet dofs pinned where free_mask == 0.

        b must already carry boundary values at pinned dofs
        (``fem.solvers.DirichletSystem.rhs``). Returns (x[:n] on every rank,
        ||r||, iterations). A stalled or non-finite solve gets one
        escalation (``_maybe_escalate``)."""
        b = self._pad_local(b)
        free = self._pad_local(free_mask)
        x, res, k, bnorm = self._solve(b, free, rtol, maxiter)
        if recovery:
            x, res, k = _maybe_escalate(self, "data", (b, free), x, res, k, bnorm, rtol, maxiter)
        return self._gather(x), res, k


class HaloDIAParabolic:
    """Distributed implicit-Euler stepping over DIA operators.

    K = M/dt + A (both DIA, same offset set); each step solves
    K u_{t+1} = (M/dt) u_t + F_{t+1} with boundary values pinned, the
    sharded counterpart of ``fem.solvers.solve_parabolic``. Per step: the
    halo strips of the products and psum'd dot products.
    ``step_iterations`` holds the last solve's CG iterations per step.
    """

    def __init__(self, A_dia, M_dia, dt: float, device_mesh: ShardMesh):
        if tuple(A_dia.offsets) != tuple(M_dia.offsets):
            raise ValueError("operators must share offsets")
        self.K = HaloDIASolver(DIAMatrix(A_dia.data + M_dia.data / dt, A_dia.offsets, A_dia.n),
                               device_mesh)
        dev = device_mesh.device
        self.Mdata = self.K._local(torch.as_tensor(M_dia.data, device=dev) / dt).to(self.K.dtype)
        self.device_mesh = device_mesh
        self.step_iterations = []

    def solve(self, F, G, u0, free_mask, rtol=1e-10, maxiter=500):
        """F, G: (n, m) forcing and Dirichlet data at the m instants after
        the initial one; u0: the initial condition. Returns the (n, m)
        trajectory (u0 excluded) on every rank."""
        K = self.K
        Fl, Gl = K._pad_local(F), K._pad_local(G)
        u = K._pad_local(u0)
        free = K._pad_local(free_mask)
        us, self.step_iterations = [], []
        for j in range(Fl.shape[1]):
            gm = Gl[:, j] * (1 - free)
            rhs = K._spmv(self.Mdata, u) + Fl[:, j]
            # boundary columns to the right-hand side (unmasked K action on gm)
            b_mod = (rhs - K._spmv(K.data, gm)) * free + gm
            u, _, k, _ = K._solve(b_mod, free, rtol, maxiter, x0=torch.where(free > 0, u, gm))
            us.append(u)
            self.step_iterations.append(k)
        return K._gather(torch.stack(us, dim=1))
