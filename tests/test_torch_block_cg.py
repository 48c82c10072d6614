"""The port's block CG (``linear_algebra.solvers.cg`` on an (n, k) right-hand
side) against k vector solves, and the Hutchinson trace of
``SmoothingRegression`` that runs its probes through it, against a loop of
vector solves, one a probe.

CPU only, float64, small sizes; no JAX. Tolerances: block columns against
their vector solves 1e-12 relative in x and +-1 in iterations (the dot
products' sums run in another order); the Hutchinson estimate against the
per-probe loop 1e-10 relative; everything said to be equal, bitwise.
"""

import math

import numpy as np
import pytest
import torch

import fdapde_core_tpu_torch as fdt
from fdapde_core_tpu_torch.geometry import unit_square_mesh
from fdapde_core_tpu_torch.linear_algebra import solvers
from fdapde_core_tpu_torch.linear_algebra.solvers import cg, jacobi_preconditioner
from fdapde_core_tpu_torch.models import SmoothingRegression

RTOL = 1e-10
N = 240


def _system(seed=0):
    """An SPD A = Q diag(lam) Q^T with lam spread over [1, 10], and Q."""
    gen = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(N, N, generator=gen, dtype=torch.float64))
    lam = torch.logspace(0, 1, N, dtype=torch.float64)
    return (Q * lam) @ Q.T, Q


def _case(kind, seed=0):
    """(A, preconditioner, B as (k, n) rows, atol): columns that converge at
    different counts."""
    A, Q = _system(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    rand = torch.randn(N, generator=gen, dtype=torch.float64)
    if kind == "eigen":  # unpreconditioned: a column in the span of m eigenvectors takes <= m
        cols = [rand, Q[:, 3:5].sum(1), Q[:, ::40].sum(1), Q[:, ::4] @ torch.rand(
            Q[:, ::4].shape[1], generator=gen, dtype=torch.float64)]
        return A, None, torch.stack(cols), 0.0
    # Jacobi, and columns of falling size against one absolute tolerance
    cols = [torch.randn(N, generator=gen, dtype=torch.float64) * s for s in (1.0, 1e-3, 1e-6, 1.0)]
    return A, jacobi_preconditioner(torch.diagonal(A)), torch.stack(cols), 1e-9


def _layout(rows, layout):
    """The (n, k) block of the rows: the transposed view of the (k, n) rows
    or a row-major copy."""
    return rows.T if layout == "transposed" else rows.T.contiguous()


def _vector_solves(A, pre, B, atol, maxiter=None):
    return [cg(A, B[:, j].contiguous(), M_inv=pre, rtol=RTOL, atol=atol, maxiter=maxiter)
            for j in range(B.shape[1])]


def _tolerances(B, atol):
    return [max(RTOL * float(torch.linalg.norm(B[:, j])), atol) for j in range(B.shape[1])]


CASES = [(kind, layout) for kind in ("eigen", "atol") for layout in ("transposed", "row-major")]


@pytest.mark.parametrize("kind,layout", CASES, ids=[f"{k}-{l}" for k, l in CASES])
def test_block_cg_matches_vector_solves(kind, layout):
    """Each column: x to 1e-12 of its vector solve and its iterations within
    +-1; the SolveInfo sums the iterations, holds the (k,) residuals and
    ANDs convergence; the block keeps its layout."""
    A, pre, rows, atol = _case(kind)
    B = _layout(rows, layout)
    X, info = cg(A, B, M_inv=pre, rtol=RTOL, atol=atol)
    vec = _vector_solves(A, pre, B, atol)
    counts = [v[1].iterations for v in vec]
    assert len(set(counts)) > 2, counts  # the columns stop at different counts
    assert X.shape == B.shape and X.stride() == B.stride()
    for j, (x, _) in enumerate(vec):
        assert float(torch.linalg.norm(X[:, j] - x)) <= 1e-12 * float(torch.linalg.norm(x))
    assert abs(info.iterations - sum(counts)) <= len(counts)
    assert info.converged is True and all(v[1].converged for v in vec)
    assert info.residual.shape == (B.shape[1],)
    tol = _tolerances(B, atol)
    assert all(float(info.residual[j]) <= tol[j] for j in range(B.shape[1]))
    # each column's own count within +-1: converged by maxiter = count + 1,
    # not by count - 2 (the residual of a column cut short is above its tolerance)
    for j, c in enumerate(counts):
        _, hi = cg(A, B, M_inv=pre, rtol=RTOL, atol=atol, maxiter=c + 1)
        assert float(hi.residual[j]) <= tol[j]
        if c >= 2:
            _, lo = cg(A, B, M_inv=pre, rtol=RTOL, atol=atol, maxiter=c - 2)
            assert float(lo.residual[j]) > tol[j] and lo.converged is False


@pytest.mark.parametrize("kind,layout", CASES, ids=[f"{k}-{l}" for k, l in CASES])
def test_block_cg_converged_column_frozen(kind, layout):
    """A column that has stopped keeps its x bitwise while the others go
    on: the whole run's x of the fastest column equals, bitwise, its x in a
    run cut at that column's stop."""
    A, pre, rows, atol = _case(kind)
    B = _layout(rows, layout)
    X, info = cg(A, B, M_inv=pre, rtol=RTOL, atol=atol)
    counts = [v[1].iterations for v in _vector_solves(A, pre, B, atol)]
    fast = int(np.argmin(counts))
    tol = _tolerances(B, atol)[fast]
    # the block's own stop of that column: the least maxiter that converges it
    stop = next(m for m in range(counts[fast] + 2)
                if float(cg(A, B, M_inv=pre, rtol=RTOL, atol=atol, maxiter=m)[1].residual[fast]) <= tol)
    assert stop + 2 < max(counts)  # the other columns run on past it
    Xs, cut = cg(A, B, M_inv=pre, rtol=RTOL, atol=atol, maxiter=stop)
    assert torch.equal(X[:, fast], Xs[:, fast])
    assert torch.equal(info.residual[fast], cut.residual[fast])
    assert cut.iterations < info.iterations and cut.converged is False


@pytest.mark.parametrize("kind,layout", CASES, ids=[f"{k}-{l}" for k, l in CASES])
def test_block_cg_independent_of_host_reads(kind, layout):
    """The stop mask lives on the device: reading it every iteration or
    every 5 gives the same x, residuals and iterations, bitwise."""
    A, pre, rows, atol = _case(kind)
    B = _layout(rows, layout)
    X1, i1 = solvers._block_cg(A, B, pre, None, RTOL, atol, None, 1)
    Xe, ie = solvers._block_cg(A, B, pre, None, RTOL, atol, None, 5)
    assert torch.equal(X1, Xe) and torch.equal(i1.residual, ie.residual)
    assert (i1.iterations, i1.converged) == (ie.iterations, ie.converged)


@pytest.mark.parametrize("layout", ["transposed", "row-major"])
def test_block_cg_maxiter_stops_a_column_only(layout):
    """maxiter stops the columns that reach it; the others converge as in
    the uncapped run, bitwise, and count their own iterations."""
    A, pre, rows, atol = _case("eigen")
    B = _layout(rows, layout)
    X, full = cg(A, B, M_inv=pre, rtol=RTOL)
    counts = [v[1].iterations for v in _vector_solves(A, pre, B, 0.0)]
    m = sorted(counts)[1] + 1  # the two fastest columns finish, the others are cut
    Xm, capped = cg(A, B, M_inv=pre, rtol=RTOL, maxiter=m)
    tol = _tolerances(B, 0.0)
    done = [j for j in range(B.shape[1]) if float(capped.residual[j]) <= tol[j]]
    assert sorted(done) == sorted(np.argsort(counts)[:2].tolist())
    for j in done:
        assert torch.equal(Xm[:, j], X[:, j])
    cut = [j for j in range(B.shape[1]) if j not in done]
    assert capped.converged is False
    assert abs(capped.iterations - (m * len(cut) + sum(counts[j] for j in done))) <= len(done)


@pytest.mark.parametrize("layout", ["transposed", "row-major"])
def test_block_cg_nonfinite_column_stops_alone(layout):
    """A column whose residual turns non-finite stops there, unconverged;
    the other columns' iterates are those of a clean run, bitwise."""
    A, pre, rows, atol = _case("atol")
    B = _layout(rows, layout)
    X, clean = cg(A, B, M_inv=pre, rtol=RTOL, atol=atol)
    calls = [0]

    def poisoned(P):
        calls[0] += 1
        Y = A @ P
        if calls[0] == 4:  # the third iteration's product: column 1 turns NaN
            Y[:, 1] = math.nan
        return Y

    Xp, info = cg(poisoned, B, M_inv=pre, rtol=RTOL, atol=atol)
    assert not bool(torch.isfinite(info.residual[1])) and info.converged is False
    others = [j for j in range(B.shape[1]) if j != 1]
    assert torch.equal(Xp[:, others], X[:, others])
    assert torch.equal(info.residual[others], clean.residual[others])
    # column 1 ran 3 iterations, the rest as in the clean run (which ran column 1 longer)
    (_, one), = _vector_solves(A, pre, B[:, 1:2], atol)
    assert one.iterations > 3
    assert abs(info.iterations - (clean.iterations - one.iterations + 3)) <= 1


def _parent_cg(A, b, M_inv, rtol, maxiter):
    """The vector Jacobi-CG loop as written before the block path: the
    oracle for ``cg`` on a 1-D b."""
    x = torch.zeros_like(b)
    tol = max(rtol * float(torch.linalg.norm(b)), 0.0)
    r = b - A @ x
    z = M_inv(r)
    p, rz = z, torch.dot(r, z)
    rnorm = torch.linalg.norm(r)
    k = 0
    while k < maxiter and float(rnorm) > tol and math.isfinite(float(rnorm)):
        Ap = A @ p
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p, rz = z + beta * p, rz_new
        rnorm = torch.linalg.norm(r)
        k += 1
    return x, k, rnorm


@pytest.mark.parametrize("column", [0, 1, 2, 3])
def test_vector_cg_is_the_parent_loop(column):
    """``cg`` on a vector runs the vector loop: x, iterations and residual
    bitwise those of the loop above."""
    A, pre, rows, atol = _case("atol")
    b = rows[column].contiguous()
    x, info = cg(A, b, M_inv=pre, rtol=RTOL, maxiter=500)
    xo, ko, ro = _parent_cg(A, b, pre, RTOL, 500)
    assert torch.equal(x, xo) and info.iterations == ko and torch.equal(info.residual, ro)


def _per_probe_trace(model, Psi, lam, n_probes, seed, rtol, maxiter):
    """The Hutchinson estimate as a loop of vector solves, one a probe, on
    the same seeded Rademacher probes: the oracle of the block solve."""
    op, pre = model._normal_op(Psi, lam)
    rng = np.random.default_rng(seed)
    V = torch.as_tensor(rng.choice([-1.0, 1.0], size=(n_probes, Psi.shape[0])))
    est = []
    for v in V:
        u = Psi.rmatvec(v)
        w, info = cg(op, u, M_inv=pre, rtol=rtol, maxiter=maxiter)
        assert info.converged
        est.append(float(torch.dot(u, w)))
    return float(np.mean(est))


@pytest.mark.parametrize("lam", [1e-2, 1.0, 1e2])
def test_hutchinson_block_matches_per_probe_loop(lam):
    """The port's Hutchinson trace (one block solve over the probes) against
    the per-probe vector loop: 1e-10 relative."""
    square = unit_square_mesh(12)
    mesh = fdt.Triangulation(square.nodes, square.cells, square.boundary_nodes)
    model = SmoothingRegression(mesh, -fdt.laplacian(), device="cpu")
    rng = np.random.default_rng(3)
    Psi = model._basis(rng.uniform(0.0, 1.0, (400, 2)))
    got = model._trace_smoother_hutchinson(Psi, lam, 6, 11, 1e-10, 2000)
    want = _per_probe_trace(model, Psi, lam, 6, 11, 1e-10, 2000)
    assert abs(got / want - 1) <= 1e-10
