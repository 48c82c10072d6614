"""The preconditioned CG loop that every row-sharded solver runs.

Vectors hold this shard's rows; each dot product is a local partial sum
made global by one ``psum`` (JAX: ``jax.lax.psum(jnp.vdot(a, c), "shard")``).
JAX's ``lax.while_loop`` becomes a host loop whose stop test reads one
scalar an iteration (the port's rule for device loops). r.z and r.r are
summed by one ``psum`` of a 2-vector, so an iteration runs two collectives
(JAX's cond recomputes r.r in a third). Divisions are guarded (a zero
denominator gives 0), as ``parallel/mg.py`` guards them in JAX; on an SPD
system the guard never fires.
"""

from __future__ import annotations

import math

import torch

from ..ops.grid_cg import _safe_div

__all__ = ["sharded_cg"]


def sharded_cg(Ax, prec, b, mesh, rtol: float, maxiter: int, x0=None, stop: str = "residual"):
    """PCG on this shard's rows; returns (x, rr, k, bb): the local iterate,
    the global r.r (residual stop) or r.z ("preconditioned" stop, JAX's
    ``parallel/space_time.py``) as a 0-dim tensor, the iterations, and b.b.

    Stops when r.r <= rtol^2 b.b (resp. r.z <= rtol^2 r0.z0), after
    ``maxiter`` iterations, or on a non-finite value."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - Ax(x0)
    z = prec(r)
    rz, rr, bb = mesh.psum(torch.stack([torch.sum(r * z), torch.sum(r * r), torch.sum(b * b)]))
    tol2 = rtol * rtol * float(bb if stop == "residual" else rz)
    p, k = z, 0
    while k < maxiter:
        v = float(rr if stop == "residual" else rz)
        if not (v > tol2 and math.isfinite(v)):
            break
        Ap = Ax(p)
        pAp = mesh.psum(torch.sum(p * Ap)[None])[0]
        alpha = _safe_div(rz, pAp, pAp > 0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new, rr = mesh.psum(torch.stack([torch.sum(r * z), torch.sum(r * r)]))
        beta = _safe_div(rz_new, rz, rz > 0)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, (rr if stop == "residual" else rz), k, bb
