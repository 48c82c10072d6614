"""Geometric multigrid on 3D grid stencils: Galerkin coarsening + V-cycle.

Port of ``fdapde_core_tpu/ops/grid_mg3d.py``, the 3D counterpart of
ops/grid_mg.py for the Freudenthal structured tet path (ops/grid3d.py):

- Galerkin coarse operators A_c = P^T A_f P computed on the stencil layers
  (variable coefficients and folded Dirichlet boundaries coarsen
  correctly); fine offsets in {-1, 0, 1}^3 stay 27-point under coarsening,
- trilinear prolongation P / full-weighting restriction P^T over the node
  lattice (coarse (I, J, K) = fine (2I, 2J, 2K)),
- weighted-Jacobi smoothing (symmetric pre/post, so the V-cycle is SPD),
- a fixed count of unpreconditioned CG iterations at the coarsest level,
  its divisions guarded on the device (no host read per iteration).

Every ingredient is strided slices and elementwise work, as in JAX (XLA
there, no Pallas kernel).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

from .grid3d import GridDIA3D, _pad3
from .grid_cg import _safe_div

__all__ = ["GridMG3D", "mg_preconditioned_cg3d", "galerkin_coarsen3d"]

_W = {-1: 0.5, 0: 1.0, 1: 0.5}  # per-axis linear interpolation weights

_27_POINT = tuple(itertools.product((-1, 0, 1), repeat=3))


def _sampled3(layer_padded, a: int, b: int, c: int, mc: int):
    """layer_padded[(1+2I+a, 1+2J+b, 1+2K+c)] for coarse (I,J,K) in [0,mc)^3."""
    e = 2 * (mc - 1) + 1
    return layer_padded[1 + a:1 + a + e:2, 1 + b:1 + b + e:2, 1 + c:1 + c + e:2]


def galerkin_coarsen3d(G: GridDIA3D) -> GridDIA3D:
    """A_c = P^T A_f P on an (m, m, m) lattice, m odd, coarse mc = (m+1)//2.

    Fine offsets must satisfy |d| <= 1 per axis (true for the Freudenthal
    P1 15-point stencil and its Galerkin coarsenings, which stay 27-point).
    """
    m = G.shape3d[0]
    if not G.shape3d[0] == G.shape3d[1] == G.shape3d[2]:
        raise ValueError("cubic lattices only")
    if m % 2 != 1:
        raise ValueError("node count must be odd (cell count even)")
    if not all(all(abs(d) <= 1 for d in o) for o in G.offsets3d):
        raise ValueError("fine offsets must lie within the 27-point stencil")
    mc = (m + 1) // 2
    fine = {o: _pad3(G.data[k], 1) for k, o in enumerate(G.offsets3d)}

    layers = {}
    for dO in _27_POINT:
        acc = torch.zeros((mc, mc, mc), dtype=G.data.dtype, device=G.data.device)
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                for c in (-1, 0, 1):
                    for (di, dj, dk), lay in fine.items():
                        ap = a + di - 2 * dO[0]
                        bp = b + dj - 2 * dO[1]
                        cp = c + dk - 2 * dO[2]
                        if ap in _W and bp in _W and cp in _W:
                            w = _W[a] * _W[b] * _W[c] * _W[ap] * _W[bp] * _W[cp]
                            # fine rows outside the lattice read the zero padding
                            acc = acc + w * _sampled3(lay, a, b, c, mc)
        layers[dO] = acc
    return GridDIA3D(torch.stack([layers[o] for o in _27_POINT]), _27_POINT, (mc, mc, mc))


def _stencil3(data, offsets3d, x, m):
    # layers are cast to the vector dtype: bf16 or f32 storage under f32 or
    # f64 vectors
    xp = _pad3(x, 1)
    acc = None
    for k, (di, dj, dk) in enumerate(offsets3d):
        t = data[k].to(x.dtype) * xp[1 + di:1 + di + m, 1 + dj:1 + dj + m, 1 + dk:1 + dk + m]
        acc = t if acc is None else acc + t
    return acc


def _restrict3(r, mc):
    """Full weighting r_c = P^T r_f (coarse (I,J,K) <- fine (2I,2J,2K))."""
    rp = _pad3(r, 1)
    acc = None
    for a, b, c in _27_POINT:
        t = _W[a] * _W[b] * _W[c] * _sampled3(rp, a, b, c, mc)
        acc = t if acc is None else acc + t
    return acc


def _prolong3(e, m):
    """Trilinear e_f = P e_c onto the (m, m, m) fine lattice."""
    mc = e.shape[0]
    up = torch.zeros((m + 2, m + 2, m + 2), dtype=e.dtype, device=e.device)
    hi = 2 * (mc - 1) + 2
    up[1:hi:2, 1:hi:2, 1:hi:2] = e
    acc = None
    for a, b, c in _27_POINT:
        t = _W[a] * _W[b] * _W[c] * up[1 + a:1 + a + m, 1 + b:1 + b + m, 1 + c:1 + c + m]
        acc = t if acc is None else acc + t
    return acc


@dataclass
class GridMG3D:
    """V-cycle hierarchy over a GridDIA3D (boundary treatment folded).

    Usage: mg = GridMG3D.build(G); z = mg.v_cycle(r): an SPD operation
    approximating A^{-1} r (a CG preconditioner).
    """

    datas: list  # (K_l, m_l, m_l, m_l) per level
    offsets: tuple  # offset tuple per level
    shapes: tuple  # m_l per level
    omega: float
    nu: int
    coarse_iters: int

    @classmethod
    def build(cls, G: GridDIA3D, coarse_n: int = 8, omega: float = 0.8,
              nu: int = 2, coarse_iters: int = 64):
        """Coarsen while the cell count n = m-1 is even and n // 2 >= coarse_n."""
        datas, offsets, shapes = [G.data], [G.offsets3d], [G.shape3d[0]]
        lvl = G
        while True:
            n = shapes[-1] - 1
            if n % 2 != 0 or n // 2 < coarse_n:
                break
            lvl = galerkin_coarsen3d(lvl)
            datas.append(lvl.data)
            offsets.append(lvl.offsets3d)
            shapes.append(lvl.shape3d[0])
        return cls(datas, tuple(offsets), tuple(shapes), omega, nu, coarse_iters)

    @property
    def n_levels(self):
        return len(self.shapes)

    def astype(self, dtype):
        """Hierarchy with the stencil layers stored in ``dtype`` (bfloat16
        halves the layer traffic); vector arithmetic keeps the caller's
        precision. Sound because the V-cycle is only a preconditioner."""
        return GridMG3D([d.to(dtype) for d in self.datas], self.offsets, self.shapes,
                        self.omega, self.nu, self.coarse_iters)

    def _smooth(self, lvl, x, b):
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        inv_diag = 1.0 / data[offs.index((0, 0, 0))].to(b.dtype)
        for _ in range(self.nu):
            x = x + self.omega * inv_diag * (b - _stencil3(data, offs, x, m))
        return x

    def _coarse_solve(self, b):
        lvl = self.n_levels - 1
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        x, r, p, rr = torch.zeros_like(b), b, b, torch.sum(b * b)
        for _ in range(self.coarse_iters):
            Ap = _stencil3(data, offs, p, m)
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
        x = self._smooth(lvl, torch.zeros_like(b), b)
        r = b - _stencil3(data, offs, x, m)
        e = self._v(lvl + 1, _restrict3(r, self.shapes[lvl + 1]))
        x = x + _prolong3(e, m)
        return self._smooth(lvl, x, b)

    def v_cycle(self, r):
        """One V-cycle on a flat or (m, m, m) residual; returns the same
        shape and dtype (vector arithmetic in r's dtype)."""
        m = self.shapes[0]
        z = self._v(0, r.reshape(m, m, m))
        return z.reshape(-1) if r.dim() == 1 else z


def mg_preconditioned_cg3d(G: GridDIA3D, b, rtol=1e-6, maxiter=100,
                           mg: GridMG3D | None = None, **build_kwargs):
    """CG on G with a 3D V-cycle preconditioner; returns (x, rel_res,
    iters). G must carry its boundary treatment (with_dirichlet_identity).
    The stop test reads one scalar per iteration; the rz-recurrence stop is
    backed by a true-residual evaluation at the end (rel_res a 0-dim
    tensor, iters a Python int)."""
    if mg is None:
        mg = GridMG3D.build(G, **build_kwargs)
    m = G.shape3d[0]
    data, offs = G.data, G.offsets3d
    b = b.reshape(m, m, m)
    bn2 = torch.sum(b * b)
    tol2 = (rtol * rtol) * bn2

    z0 = mg.v_cycle(b)
    x, r, p, rz, rr = torch.zeros_like(b), b, z0, torch.sum(b * z0), bn2
    k = 0
    while k < maxiter and bool((rr > tol2) & torch.isfinite(rr)):
        Ap = _stencil3(data, offs, p, m)
        pAp = torch.sum(p * Ap)
        alpha = _safe_div(rz, pAp, pAp > 0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = mg.v_cycle(r)
        rz_new = torch.sum(r * z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p = z + beta * p
        rz, rr = rz_new, torch.sum(r * r)
        k += 1
    true_r = b - _stencil3(data, offs, x, m)
    rel = torch.sqrt(torch.sum(true_r * true_r) / bn2)
    return x.reshape(-1), rel, k
