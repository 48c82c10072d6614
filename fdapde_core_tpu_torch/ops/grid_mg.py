"""Geometric multigrid on 2D grid stencils: Galerkin coarsening + V-cycle.

Jacobi-CG iteration counts grow like O(1/h); a multigrid V-cycle
preconditioner makes the preconditioned condition number O(1), so MG-CG
converges in a few tens of iterations at any size. Every ingredient is
strided slices and elementwise work:

- Galerkin coarse operators A_c = P^T A_f P computed directly on the
  stencil layers (variable coefficients and folded Dirichlet boundaries
  coarsen correctly with no rediscretization),
- bilinear prolongation P / full-weighting restriction P^T over the node
  grid (coarse node (I, J) = fine node (2I, 2J)),
- weighted-Jacobi smoothing (symmetric pre/post, so the V-cycle is an SPD
  preconditioner, valid inside CG),
- fixed unpreconditioned CG at the coarsest level.

Each level needs an odd node count m = n+1; coarsening stops when n goes
odd or n // 2 < coarse_n.

A V-cycle's stages are spans (``utils.profiling``) valued by their level
(0 the finest): ``mg.smooth`` (pre and post), ``mg.residual``,
``mg.restrict`` (from the level), ``mg.prolong`` (onto it) and
``mg.coarse``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.profiling import span
from .grid_cg import _safe_div
from .grid_dia import GridDIAMatrix, _pad2

__all__ = ["GridMG", "mg_preconditioned_cg", "galerkin_coarsen"]

_W = {-1: 0.5, 0: 1.0, 1: 0.5}  # bilinear interpolation weights

_NINE_POINT = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))


def _sampled(layer_padded, a: int, b: int, mc: int):
    """layer_padded[(1+2I+a, 1+2J+b)] for coarse (I, J) in [0, mc)^2."""
    end = 2 * (mc - 1) + 1
    return layer_padded[1 + a:1 + a + end:2, 1 + b:1 + b + end:2]


def galerkin_coarsen(G: GridDIAMatrix) -> GridDIAMatrix:
    """A_c = P^T A_f P on an (m, m) grid, m odd, coarse mc = (m+1)//2.

    Fine offsets must satisfy |di|, |dj| <= 1 (true for P1 tensor-product
    stencils and their Galerkin coarsenings, which stay 9-point).
    """
    m = G.shape2d[0]
    if G.shape2d[0] != G.shape2d[1]:
        raise ValueError("square grids only")
    if m % 2 != 1:
        raise ValueError("node count must be odd (cell count even)")
    if not all(abs(a) <= 1 and abs(b) <= 1 for a, b in G.offsets2d):
        raise ValueError("fine offsets must lie within the 9-point stencil")
    mc = (m + 1) // 2
    fine = {o: _pad2(G.data[k], 1) for k, o in enumerate(G.offsets2d)}

    layers = {}
    for (dI, dJ) in _NINE_POINT:
        acc = torch.zeros((mc, mc), dtype=G.data.dtype, device=G.data.device)
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                for (di, dj), lay in fine.items():
                    ap = a + di - 2 * dI
                    bp = b + dj - 2 * dJ
                    if ap in _W and bp in _W:
                        w = _W[a] * _W[b] * _W[ap] * _W[bp]
                        # fine rows outside the grid read the zero padding
                        acc = acc + w * _sampled(lay, a, b, mc)
        layers[(dI, dJ)] = acc
    data = torch.stack([layers[o] for o in _NINE_POINT])
    return GridDIAMatrix(data, _NINE_POINT, (mc, mc))


def _stencil(data, offsets2d, x, m):
    # layers are cast to the vector dtype (bf16 / f32 storage under f32 /
    # f64 vectors)
    xp = _pad2(x, 1)
    acc = None
    for k, (di, dj) in enumerate(offsets2d):
        t = data[k].to(x.dtype) * xp[1 + di:1 + di + m, 1 + dj:1 + dj + m]
        acc = t if acc is None else acc + t
    return acc


def _restrict(r, mc):
    """Full weighting r_c = P^T r_f (coarse (I,J) <- fine (2I, 2J))."""
    rp = _pad2(r, 1)
    acc = None
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            t = _W[a] * _W[b] * _sampled(rp, a, b, mc)
            acc = t if acc is None else acc + t
    return acc


def _prolong(e, m):
    """Bilinear e_f = P e_c onto the (m, m) fine grid."""
    mc = e.shape[0]
    up = torch.zeros((m + 2, m + 2), dtype=e.dtype, device=e.device)
    up[1:2 * (mc - 1) + 2:2, 1:2 * (mc - 1) + 2:2] = e
    acc = None
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            t = _W[a] * _W[b] * up[1 + a:1 + a + m, 1 + b:1 + b + m]
            acc = t if acc is None else acc + t
    return acc


@dataclass
class GridMG:
    """V-cycle hierarchy over a GridDIAMatrix (boundary treatment folded).

    Usage: mg = GridMG.build(G); z = mg.v_cycle(r): an SPD operation
    approximating A^{-1} r (a CG preconditioner).
    """

    datas: list  # (K_l, m_l, m_l) per level
    offsets: tuple  # offset tuple per level
    shapes: tuple  # m_l per level
    omega: float
    nu: int
    coarse_iters: int

    @classmethod
    def build(cls, G: GridDIAMatrix, coarse_n: int = 32, omega: float = 0.8,
              nu: int = 2, coarse_iters: int = 64):
        """Coarsen while the cell count n = m-1 is even and n // 2 >= coarse_n."""
        datas = [G.data]
        offsets = [G.offsets2d]
        shapes = [G.shape2d[0]]
        lvl = G
        while True:
            n = shapes[-1] - 1
            if n % 2 != 0 or n // 2 < coarse_n:
                break
            lvl = galerkin_coarsen(lvl)
            datas.append(lvl.data)
            offsets.append(lvl.offsets2d)
            shapes.append(lvl.shape2d[0])
        return cls(datas, tuple(offsets), tuple(shapes), omega, nu, coarse_iters)

    @property
    def n_levels(self):
        return len(self.shapes)

    def astype(self, dtype):
        """Hierarchy with stencil data stored in ``dtype`` (typically
        bfloat16); vector arithmetic keeps the caller's precision. Sound
        because the V-cycle is only a preconditioner."""
        return GridMG(
            [d.to(dtype) for d in self.datas], self.offsets, self.shapes,
            self.omega, self.nu, self.coarse_iters,
        )

    def _smooth(self, lvl, x, b):
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        inv_diag = 1.0 / data[offs.index((0, 0))].to(b.dtype)
        for _ in range(self.nu):
            x = x + self.omega * inv_diag * (b - _stencil(data, offs, x, m))
        return x

    def _coarse_solve(self, b):
        lvl = self.n_levels - 1
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        with span("mg.coarse", lvl):
            x, r, p, rr = torch.zeros_like(b), b, b, torch.sum(b * b)
            for _ in range(self.coarse_iters):
                Ap = _stencil(data, offs, p, m)
                pAp = torch.sum(p * Ap)
                alpha = _safe_div(rr, pAp, pAp > 0)
                x = x + alpha * p
                r = r - alpha * Ap
                rr_new = torch.sum(r * r)
                beta = _safe_div(rr_new, rr, rr > 0)
                p = p * beta + r
                rr = rr_new
        return x

    def _v(self, lvl, b):
        if lvl == self.n_levels - 1:
            return self._coarse_solve(b)
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        with span("mg.smooth", lvl):
            x = self._smooth(lvl, torch.zeros_like(b), b)
        with span("mg.residual", lvl):
            r = b - _stencil(data, offs, x, m)
        with span("mg.restrict", lvl):
            rc = _restrict(r, self.shapes[lvl + 1])
        e = self._v(lvl + 1, rc)
        with span("mg.prolong", lvl):
            x = x + _prolong(e, m)
        with span("mg.smooth", lvl):
            return self._smooth(lvl, x, b)

    def v_cycle(self, r):
        """One V-cycle on a flat or (m, m) residual; returns the same shape
        and dtype (vector arithmetic in r's dtype)."""
        m = self.shapes[0]
        z = self._v(0, r.reshape(m, m))
        return z.reshape(-1) if r.dim() == 1 else z


def mg_preconditioned_cg(G: GridDIAMatrix, b, rtol=1e-6, maxiter=100,
                         mg: GridMG | None = None, prec_dtype=None,
                         **build_kwargs):
    """CG on G with a V-cycle preconditioner; returns (x, rel_res, iters).

    G must carry its boundary treatment (with_dirichlet_identity). The
    loop's stop test reads one scalar per iteration; the rz-recurrence stop
    is backed by a true-residual evaluation at the end (rel_res is a 0-dim
    tensor, iters a Python int).

    prec_dtype: run the V-cycle in a lower precision than the CG vectors
    (typically f32 under f64): the f32 rounding perturbs the preconditioner,
    not the f64 Krylov recurrence.
    """
    if mg is None:
        mg = GridMG.build(G, **build_kwargs)
    m = G.shape2d[0]
    data, offs = G.data, G.offsets2d
    b = b.reshape(m, m)
    bn2 = torch.sum(b * b)
    tol2 = (rtol * rtol) * bn2

    if prec_dtype is not None:
        vdt = b.dtype

        def prec(r):
            return mg.v_cycle(r.to(prec_dtype)).to(vdt)
    else:
        prec = mg.v_cycle

    z0 = prec(b)
    x, r, p, rz, rr = torch.zeros_like(b), b, z0, torch.sum(b * z0), bn2
    k = 0
    while k < maxiter and bool((rr > tol2) & torch.isfinite(rr)):
        Ap = _stencil(data, offs, p, m)
        pAp = torch.sum(p * Ap)
        alpha = _safe_div(rz, pAp, pAp > 0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p = z + beta * p
        rz, rr = rz_new, torch.sum(r * r)
        k += 1
    true_r = b - _stencil(data, offs, x, m)
    rel = torch.sqrt(torch.sum(true_r * true_r) / bn2)
    return x.reshape(-1), rel, k
