"""Preconditioned Krylov solvers: CG, BiCGStab and restarted GMRES.

Port of ``fdapde_core_tpu/linear_algebra/solvers.py`` ``SolveInfo``,
``cg``, ``bicgstab``, ``gmres``, ``cg_differentiable``, ``jacobi_preconditioner``,
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
per iteration on the host. ``cg`` on an (n, k) block runs the k solves as
one loop (``_block_cg``), as JAX's vmap of ``cg`` does: each column keeps
its own iterates and stops on its own, and the host reads the count of
columns still active.

Spans (``utils.profiling``): each solve of ``cg``, ``bicgstab``, their
chunked forms and ``cg_split_programs`` is a ``krylov.solve`` span whose
value is its iterations (a block solve's: the sum over its columns);
inside it, each operator product is ``krylov.operator``, each
preconditioner apply ``precond.apply`` and each host read of the residual
or the active count ``krylov.read``. A block solve holds them inside a
``krylov.block`` span valued by its column count.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.profiling import span

__all__ = ["SolveInfo", "cg", "cg_chunked", "cg_differentiable", "cg_split_programs", "bicgstab",
           "bicgstab_chunked", "dense_solve", "gmres", "iterative_refinement",
           "jacobi_preconditioner"]


class SolveInfo(NamedTuple):
    iterations: int
    residual: torch.Tensor  # final ||r||
    converged: bool
    # set by ``fem.solvers.solve_elliptic``: the preconditioner's rung (a
    # key of its ``RUNGS``) and whether the escalation to GMRES(50) ran
    rung: str | None = None
    recovered: bool = False


def _as_operator(A) -> Callable:
    return A if callable(A) else (lambda x: A @ x)


def _spanned(name, fn):
    """``fn`` with each call inside a span ``name``."""
    def apply(x):
        with span(name):
            return fn(x)

    return apply


def _read(t) -> float:
    """A device scalar on the host: the loop's wait for the device."""
    with span("krylov.read"):
        return float(t)


def _solve_span(solve):
    """``solve`` inside a ``krylov.solve`` span valued by its iterations."""

    @functools.wraps(solve)
    def spanned(*args, **kwargs):
        with span("krylov.solve") as sp:
            x, info = solve(*args, **kwargs)
            sp.value = info.iterations
        return x, info

    return spanned


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
    tolf = _read(tol)
    k = 0
    rnorm = rnorm_of(state)
    rn = _read(rnorm)
    while True:
        k_before = k
        stop = maxiter if chunk is None else k_before + chunk
        while k < stop and k < maxiter and rn > tolf and math.isfinite(rn):
            state = step(state)
            rnorm = rnorm_of(state)
            rn = _read(rnorm)
            k += 1
        if on_chunk is not None:
            on_chunk(k, rn)
        if not rn > tolf or k >= maxiter or k == k_before or not math.isfinite(rn):
            return state, k, rnorm


@_solve_span
def _cg(A, b, M_inv, x0, rtol, atol, maxiter, chunk, on_chunk):
    op = _spanned("krylov.operator", _as_operator(A))
    pre = _spanned("precond.apply", _as_operator(M_inv) if M_inv is not None else _identity)
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


def _block_active(rnorm, tol, its, maxiter):
    """The columns still to iterate: residual above tolerance and finite,
    fewer than maxiter iterations."""
    return (rnorm > tol) & torch.isfinite(rnorm) & (its < maxiter)


@_solve_span
def _block_cg(A, B, M_inv, X0, rtol, atol, maxiter, check_every):
    """``cg`` on the k columns of an (n, k) block B in one loop. Each column
    has its own alpha, beta, rz, tolerance max(rtol ||b_j||, atol) and
    iteration count; the operator and the preconditioner take the whole
    block. A column stops when its residual is at or below its tolerance,
    not finite, or has had maxiter iterations; from then on its x, r and p
    are selected unchanged. The stop mask stays on the device and the host
    reads its count every ``check_every`` iterations, ending the loop when
    no column is active: the iterates do not depend on how often it reads.
    The blocks keep B's layout. Returns (X, SolveInfo(sum of the columns'
    iterations, (k,) final residual norms, every column converged))."""
    k = B.shape[1]
    with span("krylov.block", k):
        op = _spanned("krylov.operator", _as_operator(A))
        pre = _spanned("precond.apply", _as_operator(M_inv) if M_inv is not None else _identity)
        if maxiter is None:
            maxiter = 10 * B.shape[0]
        tol = torch.clamp_min(rtol * torch.linalg.vector_norm(B, dim=0), atol)
        # X, R, P and the workspace are buffers of their own in B's layout,
        # updated in place (the preconditioner may return R)
        X = torch.zeros_like(B) if X0 is None else torch.empty_like(B).copy_(X0)
        R = torch.sub(B, op(X), out=torch.empty_like(B))
        P = torch.empty_like(B).copy_(pre(R))
        rz = torch.linalg.vecdot(R, P, dim=0)
        rnorm = torch.linalg.vector_norm(R, dim=0)
        its = torch.zeros(k, dtype=torch.int64, device=B.device)
        active = _block_active(rnorm, tol, its, maxiter)
        T = torch.empty_like(B)  # each update's workspace
        step = 0
        while True:
            if step % check_every == 0 and int(_read(active.sum())) == 0:
                break
            Ap = op(P)
            alpha = rz / torch.linalg.vecdot(P, Ap, dim=0)
            torch.mul(P, alpha, out=T).add_(X)  # x + alpha p
            torch.where(active, T, X, out=X)
            torch.sub(R, torch.mul(Ap, alpha, out=T), out=T)  # r - alpha Ap
            torch.where(active, T, R, out=R)
            del Ap
            Z = pre(R)
            rz_new = torch.linalg.vecdot(R, Z, dim=0)
            beta = rz_new / rz
            torch.mul(P, beta, out=T).add_(Z)  # z + beta p
            torch.where(active, T, P, out=P)
            del Z
            rz = torch.where(active, rz_new, rz)
            rnorm = torch.linalg.vector_norm(R, dim=0)
            its += active
            active &= _block_active(rnorm, tol, its, maxiter)
            step += 1
        iterations = int(_read(its.sum()))
        converged = bool(_read(((rnorm <= tol) & torch.isfinite(rnorm)).all()))
    return X, SolveInfo(iterations, rnorm, converged)


def cg(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0, maxiter=None):
    """Preconditioned conjugate gradients for SPD A. Returns (x, SolveInfo).

    A 2-D b of shape (n, k) runs the k solves A x_j = b_j as one block loop
    (``_block_cg``: each column its own scalars, tolerance and stop, the
    operator and preconditioner applied to the block); the SolveInfo then
    holds the sum of the columns' iterations, their (k,) final residual
    norms, and whether every column converged."""
    if b.dim() == 2:
        return _block_cg(A, b, M_inv, x0, rtol, atol, maxiter, 1)
    return _cg(A, b, M_inv, x0, rtol, atol, maxiter, None, None)


def cg_chunked(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0,
               maxiter=200, chunk=10, on_chunk=None):
    """``cg`` with on_chunk(k_iterations, rnorm) called after every
    ``chunk`` iterations and at the end; the same iterates as ``cg``."""
    return _cg(A, b, M_inv, x0, rtol, atol, maxiter, int(chunk), on_chunk)


@_solve_span
def _bicgstab(A, b, M_inv, x0, rtol, atol, maxiter, chunk, on_chunk):
    op = _spanned("krylov.operator", _as_operator(A))
    pre = _spanned("precond.apply", _as_operator(M_inv) if M_inv is not None else _identity)
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


@_solve_span
def cg_split_programs(A, b, M_inv, rtol=1e-12, maxiter=200, check_every=10,
                      on_check=None):
    """Preconditioned CG from x0 = 0 whose stop test is read on the host
    only every ``check_every`` iterations (and at maxiter); on_check(k,
    ||r||^2) is called at each read. Iterations past convergence are exact
    no-ops (guarded divisions). Returns (x, SolveInfo)."""
    op = _spanned("krylov.operator", _as_operator(A))
    pre = _spanned("precond.apply", _as_operator(M_inv))

    def apply_pre(r, p, rz):
        z = pre(r)
        rz_new = torch.dot(r, z)
        return z + _guarded_div(rz_new, rz) * p, rz_new

    bn2 = _read(torch.dot(b, b))
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
            v = _read(rn2)
            if on_check is not None:
                on_check(k, v)
            if not v > tol2:  # converged or non-finite: stop
                break
    return x, SolveInfo(k, torch.sqrt(rn2), float(rn2) <= tol2)


def dense_solve(A, b):
    """Dense solve of A x = b, b of shape (n,) or (n, k), on A's device
    and in A's dtype (for the framework's small dense systems: SMW
    capacitance matrices, the exact GCV trace). A tensor A keeps its
    device; a host matrix goes to the card, as JAX puts it on the
    accelerator."""
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A), device="cuda")
    b = torch.as_tensor(b, device=A.device).to(A.dtype)
    return torch.linalg.solve(A, b)


def cg_differentiable(matvec, b, M_inv=None, rtol=1e-12, maxiter=None, symmetric=True,
                      record=None):
    """CG solve of matvec(x) = b with implicit differentiation (JAX's
    ``lax.custom_linear_solve`` semantics).

    Gradients of the solution with respect to anything ``matvec`` closes
    over, or that enters ``b``, come from ADJOINT SOLVES, never from
    autograd through the iterations (x* is solved under ``no_grad``).
    ``symmetric``: the transpose solve reuses ``matvec``; otherwise
    matvec^T is its vector-Jacobian product. ``record``: a list that each
    solve, forward and adjoint, appends ("forward" | "adjoint", SolveInfo)
    to.

    The result, of value x* exactly, is x~ + S(b - matvec(x~)) with
    x~ = x* + S(b - matvec(x*)), where S is the identity forward and, on
    the way back, a hook that maps the incoming gradient g to
    cg_differentiable(matvec^T, g), itself differentiable. The outer S
    gives the gradient: one adjoint solve. x~ carries the solution's
    derivative into the operator's, which a Hessian through the solve needs
    (JAX's x in d(A x)); in a first backward what reaches the inner S is
    the adjoint solve's residual, which the inner solve meets at once with
    the outer one's accuracy as its absolute tolerance (the larger of
    rtol ||g|| and twice the adjoint's true residual, one more matvec).
    """
    return _cg_differentiable(matvec, b, M_inv, rtol, maxiter, symmetric, record, "forward")


def _cg_differentiable(matvec, b, M_inv, rtol, maxiter, symmetric, record, kind, atol=0.0):
    with torch.no_grad():
        x, info = cg(matvec, b.detach(), M_inv=M_inv, rtol=rtol, atol=atol, maxiter=maxiter)
    if record is not None:
        record.append((kind, info))
    if not torch.is_grad_enabled():
        return x
    r0 = b - matvec(x)
    if not r0.requires_grad:
        return x
    if symmetric:
        transposed = matvec
    else:
        def transposed(v):
            z = torch.zeros_like(x, requires_grad=True)
            with torch.enable_grad():
                return torch.autograd.grad(matvec(z), z, v, create_graph=torch.is_grad_enabled())[0]

    outer_tol = [0.0]  # the outer adjoint solve's accuracy, this backward's

    def adjoint(g):
        lam = _cg_differentiable(transposed, g, M_inv, rtol, maxiter, symmetric, record, "adjoint")
        with torch.no_grad():  # CG stops on its recurrence; the true residual may sit above
            true = float(torch.linalg.norm(g.detach() - transposed(lam.detach())))
        outer_tol[0] = max(rtol * float(torch.linalg.norm(g.detach())), 2.0 * true)
        return lam

    def inner(g):
        return _cg_differentiable(transposed, g, M_inv, rtol, maxiter, symmetric, record,
                                  "adjoint", atol=outer_tol[0])

    r0.register_hook(inner)
    x_tilde = x + (r0 - r0.detach())
    r = b - matvec(x_tilde)
    r.register_hook(adjoint)
    return x_tilde + (r - r.detach())


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
