"""Padded-state Jacobi-preconditioned CG on 2D grid stencils.

- The search direction p lives in an (mx+2H, my+2H) zero-border frame, so
  the per-iteration SpMV reads plain slices of it.
- Exact-zero stencil layers are pruned beforehand
  (``grid_dia.prune_zero_offsets_grid``).
- Optional reduced-precision stencil storage (``data_dtype=torch.bfloat16``)
  with vector arithmetic in the right-hand side's dtype: lossless on uniform
  structured meshes, ~4e-3 relative perturbation of the operator elsewhere.

The operator must already carry the boundary treatment
(``G.with_dirichlet_identity(free)``), so the CG body touches no masks.
The loops run a fixed iteration count with no host sync inside: the guarded
divisions stay on the device.
"""

from __future__ import annotations

import torch

from .grid_dia import GridDIAMatrix, _halo, _pad2

__all__ = ["grid_cg", "grid_cg_refined", "stencil_matvec_padded"]


def _safe_div(num, den, guard):
    """num / den where ``guard`` holds, else 0 (den == 0 never divides)."""
    return torch.where(guard, num / torch.where(den == 0, 1.0, den), 0.0)


def stencil_matvec_padded(data, offsets2d, x_pad, H: int):
    """y = A x from a zero-border padded operand.

    data: (K, mx, my) stencil layers (any float dtype; accumulation happens
    in the x_pad dtype). x_pad: (mx + 2H, my + 2H) with zero borders.
    """
    mx, my = data.shape[1], data.shape[2]
    acc = None
    for k, (di, dj) in enumerate(offsets2d):
        term = data[k].to(x_pad.dtype) * x_pad[H + di:H + di + mx, H + dj:H + dj + my]
        acc = term if acc is None else acc + term
    return acc


def grid_cg(G: GridDIAMatrix, b, n_iter: int, inv_diag=None, data_dtype=None):
    """Run ``n_iter`` Jacobi-CG iterations; returns (x, |r|).

    G: stencil operator, boundary treatment folded in. b: (mx, my) or flat
    rhs (bc values on pinned entries); its dtype is the vector dtype.
    inv_diag: optional (mx, my) Jacobi preconditioner (defaults to
    1/diag(G)). data_dtype: optional storage dtype for the stencil layers.
    """
    mx, my = G.shape2d
    H = _halo(G.offsets2d)
    data = G.data if data_dtype is None else G.data.to(data_dtype)
    b = b.reshape(mx, my)
    if inv_diag is None:
        inv_diag = 1.0 / G.diagonal().reshape(mx, my)
    else:
        inv_diag = inv_diag.reshape(mx, my)

    z0 = inv_diag * b
    x, r, p_pad, rz = torch.zeros_like(b), b, _pad2(z0, H), torch.sum(b * z0)
    for _ in range(n_iter):
        # guarded divisions: after exact convergence (rz = pAp = 0) the
        # fixed-count loop idles at the solution instead of producing NaN
        Ap = stencil_matvec_padded(data, G.offsets2d, p_pad, H)
        p_c = p_pad[H:H + mx, H:H + my]
        pAp = torch.sum(p_c * Ap)
        alpha = _safe_div(rz, pAp, pAp > 0)
        x = x + alpha * p_c
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = torch.sum(r * z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p_pad = _pad2(z + beta * p_c, H)
        rz = rz_new
    return x.reshape(-1), torch.linalg.norm(r)


def _cg_cycle_lowp(data, offsets2d, inv_diag, r0, n_iter, H, vdt):
    """Fixed-count Jacobi-CG on A d = r0 with all vectors in ``vdt``
    (bfloat16). Dot products accumulate in f32. The attainable residual
    reduction is only O(1e-2): callers wrap this in a refinement loop
    (grid_cg_refined)."""
    mx, my = data.shape[1], data.shape[2]

    def fdot(a, c):
        return torch.sum(a.to(torch.float32) * c.to(torch.float32))

    r0 = r0.to(vdt)
    invd = inv_diag.to(vdt)
    z0 = invd * r0
    d, r, p_pad, rz = torch.zeros_like(r0), r0, _pad2(z0, H), fdot(r0, z0)
    for _ in range(n_iter):
        Ap = stencil_matvec_padded(data, offsets2d, p_pad, H)
        p_c = p_pad[H:H + mx, H:H + my]
        pAp = fdot(p_c, Ap)
        a16 = _safe_div(rz, pAp, pAp > 0).to(vdt)
        d = d + a16 * p_c
        r = r - a16 * Ap
        z = invd * r
        rz_new = fdot(r, z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p_pad = _pad2(z + beta.to(vdt) * p_c, H)
        rz = rz_new
    return d


def grid_cg_refined(G: GridDIAMatrix, b, n_outer: int, n_inner: int,
                    inv_diag=None, inner_dtype=torch.bfloat16):
    """Iterative refinement: f32 outer residual, ``inner_dtype`` inner CG.

    Each outer cycle computes r = b - A x in f32, runs ``n_inner`` CG
    iterations entirely in ``inner_dtype`` on A d = r (scaled by 1/|r|_inf)
    and accumulates x += d in f32. Returns (x, |r|) with r the true f32
    residual. Only for well-conditioned systems: unpreconditioned bf16
    cycles lose conjugacy on ill-conditioned Laplacians (use grid_mg).
    """
    mx, my = G.shape2d
    H = _halo(G.offsets2d)
    data32 = G.data.to(torch.float32)
    data16 = G.data.to(inner_dtype)
    b = b.to(torch.float32).reshape(mx, my)
    if inv_diag is None:
        inv_diag = 1.0 / G.diagonal().reshape(mx, my)
    else:
        inv_diag = inv_diag.to(torch.float32).reshape(mx, my)

    x = torch.zeros_like(b)
    for _ in range(n_outer):
        r = b - stencil_matvec_padded(data32, G.offsets2d, _pad2(x, H), H)
        # scale so the correction enters bf16 near O(1)
        s = torch.max(torch.abs(r))
        sc = _safe_div(torch.ones_like(s), s, s > 0)
        d = _cg_cycle_lowp(data16, G.offsets2d, inv_diag, r * sc, n_inner, H,
                           inner_dtype)
        x = x + d.to(torch.float32) / torch.where(sc == 0, 1.0, sc)
    r_final = b - stencil_matvec_padded(data32, G.offsets2d, _pad2(x, H), H)
    return x.reshape(-1), torch.linalg.norm(r_final)
