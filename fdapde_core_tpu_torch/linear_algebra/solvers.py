"""Preconditioned Krylov solvers: CG, BiCGStab and restarted GMRES.

Port of ``fdapde_core_tpu/linear_algebra/solvers.py`` ``SolveInfo``,
``cg``, ``bicgstab``, ``gmres``, ``jacobi_preconditioner``,
``dense_solve``, ``iterative_refinement`` and the host-driven forms
``cg_chunked``, ``bicgstab_chunked`` and ``cg_split_programs``. The JAX
package splits a solve into device programs to stay under a TPU
executor's run-time and compile limits; PyTorch runs eagerly, so the
chunked forms are the plain loop with a host hook after every ``chunk``
iterations, and their iterates equal ``cg``'s / ``bicgstab``'s.
``cg_split_programs`` keeps what changes its iterates: the stop test is
read only every ``check_every`` iterations, and guarded divisions make the
iterations past convergence exact no-ops. ``dense_solve`` is Gauss-Jordan
elimination in JAX only because the TPU has no float64 LU; here it is
``torch.linalg.solve``, with the same (n,) / (n, k) contract.

Operators are callables or objects with ``@``. Convergence is
``||r|| <= max(rtol*||b||, atol)`` with an iteration cap; a non-finite
residual stops the loop with ``converged=False``. The loops read one scalar
per iteration on the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["SolveInfo", "cg", "cg_chunked", "cg_split_programs", "bicgstab",
           "bicgstab_chunked", "dense_solve", "gmres", "iterative_refinement",
           "jacobi_preconditioner"]


class SolveInfo(NamedTuple):
    iterations: int
    residual: torch.Tensor  # final ||r||
    converged: bool


def _as_operator(A) -> Callable:
    return A if callable(A) else (lambda x: A @ x)


def _identity(x):
    return x


def _tolerance(b, rtol, atol):
    bnorm = torch.linalg.norm(b)
    return torch.maximum(rtol * bnorm, torch.tensor(atol, dtype=bnorm.dtype, device=b.device))


def _run_chunks(step, state, rnorm_of, tol, maxiter, chunk, on_chunk):
    """Advance ``state`` with ``step`` while the residual is above ``tol``,
    finite and k < maxiter, in chunks of ``chunk`` iterations (the whole
    run when chunk is None), calling on_chunk(k, rnorm) after each chunk.
    Returns (state, k, rnorm)."""
    tolf = float(tol)
    k = 0
    rnorm = rnorm_of(state)
    rn = float(rnorm)
    while True:
        k_before = k
        stop = maxiter if chunk is None else k_before + chunk
        while k < stop and k < maxiter and rn > tolf and math.isfinite(rn):
            state = step(state)
            rnorm = rnorm_of(state)
            rn = float(rnorm)
            k += 1
        if on_chunk is not None:
            on_chunk(k, rn)
        if not rn > tolf or k >= maxiter or k == k_before or not math.isfinite(rn):
            return state, k, rnorm


def _cg(A, b, M_inv, x0, rtol, atol, maxiter, chunk, on_chunk):
    op = _as_operator(A)
    pre = _as_operator(M_inv) if M_inv is not None else _identity
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tolerance(b, rtol, atol)
    r = b - op(x)
    z = pre(r)

    def step(s):
        x, r, p, rz = s
        Ap = op(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        return x, r, z + beta * p, rz_new

    state, k, rnorm = _run_chunks(step, (x, r, z, torch.dot(r, z)),
                                  lambda s: torch.linalg.norm(s[1]),
                                  tol, maxiter, chunk, on_chunk)
    return state[0], SolveInfo(k, rnorm, bool(rnorm <= tol) and math.isfinite(float(rnorm)))


def cg(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0, maxiter=None):
    """Preconditioned conjugate gradients for SPD A. Returns (x, SolveInfo)."""
    return _cg(A, b, M_inv, x0, rtol, atol, maxiter, None, None)


def cg_chunked(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0,
               maxiter=200, chunk=10, on_chunk=None):
    """``cg`` with on_chunk(k_iterations, rnorm) called after every
    ``chunk`` iterations and at the end; the same iterates as ``cg``."""
    return _cg(A, b, M_inv, x0, rtol, atol, maxiter, int(chunk), on_chunk)


def _bicgstab(A, b, M_inv, x0, rtol, atol, maxiter, chunk, on_chunk):
    op = _as_operator(A)
    pre = _as_operator(M_inv) if M_inv is not None else _identity
    if maxiter is None:
        maxiter = 20 * b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tolerance(b, rtol, atol)
    r = b - op(x)
    rhat = r  # shadow residual
    one = torch.ones((), dtype=b.dtype, device=b.device)

    def step(s):
        x, r, p, rho, alpha, omega, v = s
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = pre(p)
        v = op(phat)
        alpha = rho_new / torch.dot(rhat, v)
        s_ = r - alpha * v
        shat = pre(s_)
        t = op(shat)
        tt = torch.dot(t, t)
        omega = torch.where(tt > 0, torch.dot(t, s_) / tt, 0.0)
        x = x + alpha * phat + omega * shat
        return x, s_ - omega * t, p, rho_new, alpha, omega, v

    # p = v = 0 and rho = alpha = omega = 1 make the first step the
    # standard p_1 = r_0 initialisation
    state0 = (x, r, torch.zeros_like(b), one, one, one, torch.zeros_like(b))
    state, k, rnorm = _run_chunks(step, state0, lambda s: torch.linalg.norm(s[1]),
                                  tol, maxiter, chunk, on_chunk)
    return state[0], SolveInfo(k, rnorm, bool(rnorm <= tol) and math.isfinite(float(rnorm)))


def bicgstab(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0, maxiter=None):
    """Preconditioned BiCGStab for general (non-symmetric) systems."""
    return _bicgstab(A, b, M_inv, x0, rtol, atol, maxiter, None, None)


def bicgstab_chunked(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0,
                     maxiter=200, chunk=10, on_chunk=None):
    """``bicgstab`` with the ``cg_chunked`` hook; the same iterates."""
    return _bicgstab(A, b, M_inv, x0, rtol, atol, maxiter, int(chunk), on_chunk)


def gmres(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0, maxiter=None, restart=20):
    """Restarted, right-preconditioned GMRES(m) for general systems
    (residual norms refer to the original system). Per cycle, ``restart``
    Arnoldi steps with twice-iterated classical Gram-Schmidt and a
    Givens-rotation least-squares solve; breakdown steps are guarded (a
    zero divisor counts as 1), so a cycle always runs its m steps, as in
    the JAX function. The (m+1)-sized Hessenberg column, rotations and back
    substitution run on the host in b's precision. Reports iterations =
    completed cycles x restart."""
    op = _as_operator(A)
    pre = _as_operator(M_inv) if M_inv is not None else _identity
    n = b.shape[0]
    m = min(restart, n)
    if maxiter is None:
        maxiter = 20 * n
    max_cycles = max(1, -(-maxiter // m))
    x = torch.zeros_like(b) if x0 is None else x0
    tolf = float(_tolerance(b, rtol, atol))
    hdt = np.float32 if b.dtype == torch.float32 else np.float64

    def safe(z):
        return z if z != 0 else 1.0

    def cycle(x):
        r = b - op(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / safe(float(beta))
        R = np.zeros((m + 1, m), hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = float(beta)
        cs = np.zeros(m, hdt)
        sn = np.zeros(m, hdt)
        for j in range(m):
            w = op(pre(V[j]))
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w  # CGS2 re-orthogonalization
            w = w - Vj.T @ h2
            hnext = torch.linalg.norm(w)
            V[j + 1] = w / safe(float(hnext))
            hcol = np.zeros(m + 1, hdt)
            hcol[:j + 1] = (h1 + h2).cpu().numpy()
            hcol[j + 1] = float(hnext)
            for i in range(j):
                hi, hi1 = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * hi + sn[i] * hi1
                hcol[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            cs[j] = 1.0 if denom == 0 else hcol[j] / denom
            sn[j] = 0.0 if denom == 0 else hcol[j + 1] / denom
            hcol[j], hcol[j + 1] = denom, 0.0
            gj = g[j]
            g[j], g[j + 1] = cs[j] * gj, -sn[j] * gj
            R[:, j] = hcol
        y = np.zeros(m, hdt)
        for i in range(m - 1, -1, -1):
            y[i] = 0.0 if R[i, i] == 0 else (g[i] - R[i, :] @ y) / R[i, i]
        return x + pre(V[:m].T @ torch.as_tensor(y, device=b.device))

    k = 0
    rnorm = torch.linalg.norm(b - op(x))
    while float(rnorm) > tolf and k < max_cycles and math.isfinite(float(rnorm)):
        x = cycle(x)
        k += 1
        rnorm = torch.linalg.norm(b - op(x))
    rn = float(rnorm)
    return x, SolveInfo(k * m, rnorm, rn <= tolf and math.isfinite(rn))


def _guarded_div(num, den):
    """num / den, and 0 where den == 0 (iterations past convergence)."""
    return torch.where(den == 0, 0.0, num / torch.where(den == 0, 1.0, den))


def cg_split_programs(A, b, M_inv, rtol=1e-12, maxiter=200, check_every=10,
                      on_check=None):
    """Preconditioned CG from x0 = 0 whose stop test is read on the host
    only every ``check_every`` iterations (and at maxiter); on_check(k,
    ||r||^2) is called at each read. Iterations past convergence are exact
    no-ops (guarded divisions). Returns (x, SolveInfo)."""
    op = _as_operator(A)
    pre = _as_operator(M_inv)

    def apply_pre(r, p, rz):
        z = pre(r)
        rz_new = torch.dot(r, z)
        return z + _guarded_div(rz_new, rz) * p, rz_new

    bn2 = float(torch.dot(b, b))
    tol2 = (rtol * rtol) * bn2
    one = torch.ones((), dtype=b.dtype, device=b.device)
    # r0 = b (x0 = 0); z0 and p0 from apply_pre with p = 0, rz = 1
    p, rz = apply_pre(b, torch.zeros_like(b), one)
    x = torch.zeros_like(b)
    r = b
    rn2 = torch.dot(b, b)
    k = 0
    while k < maxiter:
        Ap = op(p)
        alpha = _guarded_div(rz, torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rn2 = torch.dot(r, r)
        p, rz = apply_pre(r, p, rz)
        k += 1
        if k % check_every == 0 or k == maxiter:
            v = float(rn2)
            if on_check is not None:
                on_check(k, v)
            if not v > tol2:  # converged or non-finite: stop
                break
    return x, SolveInfo(k, torch.sqrt(rn2), float(rn2) <= tol2)


def dense_solve(A, b):
    """Dense solve of A x = b, b of shape (n,) or (n, k), on A's device
    and in A's dtype (for the framework's small dense systems: SMW
    capacitance matrices, the exact GCV trace)."""
    A = torch.as_tensor(A)
    b = torch.as_tensor(b, device=A.device).to(A.dtype)
    return torch.linalg.solve(A, b)


def iterative_refinement(A, b, inner_solve, n_refine: int = 3):
    """Mixed-precision refinement: residuals in b's (high) precision,
    corrections from inner_solve(residual in float32) (e.g. an f32 CG).
    Returns (x, final residual norm)."""
    op = _as_operator(A)
    x = torch.zeros_like(b)
    for _ in range(n_refine):
        r = b - op(x)
        x = x + torch.as_tensor(inner_solve(r.to(torch.float32))).to(b.dtype)
    return x, torch.linalg.norm(b - op(x))


def jacobi_preconditioner(diag):
    """M^{-1} = 1/diag, with zero entries of diag treated as 1."""
    inv = 1.0 / torch.where(diag.abs() > 0, diag, 1.0)

    def apply(x):
        return inv * x if x.dim() == 1 else inv[:, None] * x

    return apply
