"""Structured-grid Poisson fast path, end to end on one device.

    node coordinate planes -> fused coords->stencil kernel
    (ops/assembly_kernels.py, csrc/p1_stencil.cu) -> Dirichlet identity fold
    + exact-zero layer pruning (ops/grid_dia) -> geometric-multigrid
    preconditioned CG (ops/grid_mg) with f64 Krylov vectors and the V-cycle
    in the model dtype.

The same capabilities as a general-mesh P1 Poisson solve, specialised to
tensor-product connectivity at the 10M-dof scale.
"""

from __future__ import annotations

import torch

from ..ops.grid_assembly import stencil_from_coords
from ..ops.grid_dia import GridDIAMatrix, prune_zero_offsets_grid
from ..ops.grid_mg import GridMG, _stencil, mg_preconditioned_cg

__all__ = ["StructuredPoisson"]


class StructuredPoisson:
    """-Laplace u = f on the unit square, P1, n x n structured grid.

    Dirichlet data g on the boundary. ``dtype`` is the assembly and
    V-cycle precision; ``device`` holds every tensor the model makes. Use n
    divisible by a few powers of two for deep multigrid coarsening.
    """

    def __init__(self, n: int, dtype=torch.float32, coarse_n: int = 32,
                 device="cuda"):
        self.n = n
        self.m = n + 1
        self.dtype = dtype
        self.coarse_n = coarse_n
        self.device = torch.device(device)
        self._G = None
        self._mg = None

    def _build(self):
        """Node coordinate planes X, Y (m, m) and the free-dof mask."""
        n, m = self.n, self.m
        kw = dict(dtype=self.dtype, device=self.device)
        gi = torch.arange(m, **kw)[:, None]
        gj = torch.arange(m, **kw)[None, :]
        X = (gi / n).expand(m, m).contiguous()
        Y = (gj / n).expand(m, m).contiguous()
        ii = torch.arange(m, device=self.device)
        interior = (ii > 0) & (ii < m - 1)
        free = (interior[:, None] & interior[None, :]).to(self.dtype)
        return X, Y, free

    def operator(self) -> GridDIAMatrix:
        """Assembled, Dirichlet-folded, pruned stencil operator."""
        if self._G is None:
            X, Y, free = self._build()
            self._free = free
            G_raw = stencil_from_coords(X, Y, self.n)
            G = G_raw.with_dirichlet_identity(free.reshape(-1))
            # the raw (unfolded) operator lifts boundary data in rhs(): the
            # folded operator's boundary columns are zeroed
            self._G_raw = prune_zero_offsets_grid(G_raw)
            self._G = prune_zero_offsets_grid(G)
        return self._G

    def multigrid(self) -> GridMG:
        if self._mg is None:
            self._mg = GridMG.build(self.operator(), coarse_n=self.coarse_n)
        return self._mg

    def rhs(self, f_value: float = 1.0, g=None):
        """Load vector of a constant forcing (+ Dirichlet data g, (m*m,) or
        (m, m) node values), flat, in the model dtype."""
        self.operator()
        free = self._free
        m = self.m
        h2 = 1.0 / (self.n * self.n)
        b = free * (f_value * h2)
        if g is not None:
            g = torch.as_tensor(g, dtype=self.dtype, device=self.device).reshape(m, m)
            glift = (1.0 - free) * g
            Gr = self._G_raw
            col = _stencil(Gr.data, Gr.offsets2d, glift, m)
            b = free * (b - col) + glift
        return b.reshape(-1)

    def solve(self, b=None, rtol: float = 1e-8, maxiter: int = 60,
              refine: bool | str = "auto"):
        """MG-preconditioned CG; returns (x, true_rel_residual, iterations).

        refine=True (what "auto" means: torch always has f64): mixed
        precision, f64 CG vectors with the V-cycle in the model dtype. Plain
        f32 MG-CG stalls at a true relative residual of O(eps32 * kappa), so
        refine=False runs the raw model-dtype iteration only.
        """
        if refine == "auto":
            refine = True
        G = self.operator()
        mg = self.multigrid()
        if b is None:
            b = self.rhs()
        b = torch.as_tensor(b, device=self.device)
        if not refine:
            return mg_preconditioned_cg(G, b.to(self.dtype), rtol=rtol,
                                        maxiter=maxiter, mg=mg)
        return mg_preconditioned_cg(
            G, b.to(torch.float64), rtol=rtol, maxiter=maxiter, mg=mg,
            prec_dtype=self.dtype,
        )
