"""Spatial regression with PDE regularization (smoothing).

Port of ``fdapde_core_tpu/models/regression.py``, the downstream use of
fdaPDE-core: estimate a smooth field f from scattered noisy observations
y_i = f(p_i) + eps by minimizing

    ||y - Psi c||^2 + lam * c^T P c

with Psi the basis-evaluation matrix at the data locations
(fem/evaluation.py) and P a differential penalty (e.g. the stiffness of
-laplacian). The normal equations (Psi^T Psi + lam P) c = Psi^T y are SPD
and solved matrix-free with Jacobi CG; every product with Psi, Psi^T and P
runs on K2. lambda is selected by grid search over held-out error or GCV
(the reference's optimization/grid.h, smw.h for the GCV algebra).

Differences from the JAX module:
- the observation points are located on the model's device
  (``DeviceCellLocator``, the same cells as the host locator JAX uses);
- diag(Psi^T Psi) is summed in a fixed order (the row sums of Psi^T,
  ``SparseMatrix.row_sums``) where JAX scatter-adds, so a fit is bitwise the
  same from run to run on CUDA;
- the Hutchinson probes, vmapped in JAX, are one block CG (``cg`` on the
  (n_dofs, n_probes) block U = Psi^T V) whose columns keep their own
  iterates and stop, as under vmap, with the same seeded Rademacher
  probes, so the estimates agree.

Spans (``utils.profiling``): ``fit`` and ``gcv`` are the roots
``regression.fit`` and ``regression.gcv``; the constructor's stages are
``build.space`` (``FEMSpace``) and ``build.assembly`` (the penalty).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.assembler import assemble_matrix
from ..fem.evaluation import eval_basis_pointwise
from ..fem.space import FEMSpace
from ..linear_algebra.solvers import cg, dense_solve, jacobi_preconditioner
from ..utils.profiling import span

__all__ = ["SmoothingRegression"]


class SmoothingRegression:
    """Penalized least-squares field estimation over a FEM space, on
    ``device`` (the card by default) in ``dtype``."""

    def __init__(self, mesh, penalty_op, order: int = 1, dtype=torch.float64, device="cuda"):
        self.device = torch.device(device)
        self.dtype = dtype
        with span("build.space"):
            self.space = FEMSpace(mesh, order)
        with span("build.assembly"):
            self.P = assemble_matrix(self.space, penalty_op, dtype=dtype, device=self.device)

    def _basis(self, locs):
        """Psi at ``locs`` (a SparseMatrix on the model's device)."""
        Psi, _ = eval_basis_pointwise(self.space, np.asarray(locs), device_locate=True,
                                      dtype=self.dtype, device=self.device)
        return Psi

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def fit(self, locs, y, lam: float, rtol: float = 1e-10, maxiter=2000):
        """Solve (Psi^T Psi + lam P) c = Psi^T y; returns coefficients c."""
        with span("regression.fit"):
            return self._fit_psi(self._basis(locs), y, lam, rtol=rtol, maxiter=maxiter)

    def _fit_psi(self, Psi, y, lam: float, rtol: float = 1e-10, maxiter=2000):
        op, pre = self._normal_op(Psi, lam)
        c, info = cg(op, Psi.rmatvec(self._tensor(y)), M_inv=pre, rtol=rtol, maxiter=maxiter)
        self.coefficients_ = c
        self.solve_info_ = info
        return c

    def _normal_op(self, Psi, lam: float):
        """(matvec, preconditioner) of A(lam) = Psi^T Psi + lam P."""
        PsiT = Psi.T

        def op(c):
            return PsiT @ (Psi @ c) + lam * (self.P @ c)

        diag_psi = PsiT.row_sums(PsiT.vals ** 2)
        return op, jacobi_preconditioner(diag_psi + lam * self.P.diagonal())

    def predict(self, locs):
        return self._basis(locs) @ self.coefficients_

    def select_lambda(self, locs, y, lambdas, val_fraction=0.25, seed=0):
        """Pick lambda by held-out validation error over a grid
        (the reference's Grid optimizer workflow, optimization/grid.h)."""
        rng = np.random.default_rng(seed)
        n = len(y)
        idx = rng.permutation(n)
        n_val = int(val_fraction * n)
        val, train = idx[:n_val], idx[n_val:]
        locs = np.asarray(locs)
        y = np.asarray(y)
        errs = []
        for lam in lambdas:
            self.fit(locs[train], y[train], float(lam))
            pred = self.predict(locs[val]).cpu().numpy()
            errs.append(float(((pred - y[val]) ** 2).mean()))
        best = int(np.argmin(errs))
        self.fit(locs, y, float(lambdas[best]))
        return float(lambdas[best]), errs

    # -- GCV ------------------------------------------------------------
    #
    # GCV(lam) = n ||y - S(lam) y||^2 / (n - tr S(lam))^2 with smoother
    # S = Psi (Psi^T Psi + lam P)^{-1} Psi^T, the criterion the downstream
    # fdaPDE models minimize over the reference's Grid optimizer. The
    # smoother is never formed: tr S is either exact via a dense solve
    # (small problems) or a Hutchinson estimate (k Rademacher probes, a
    # CG solve each, run as one block solve).

    def gcv(self, locs, y, lam: float, n_probes: int = 16, seed: int = 0, exact: bool = False,
            rtol: float = 1e-10, maxiter: int = 2000) -> float:
        """Generalized cross-validation score at one lambda."""
        with span("regression.gcv"):
            return self._gcv_psi(self._basis(locs), y, lam, n_probes=n_probes, seed=seed,
                                 exact=exact, rtol=rtol, maxiter=maxiter)

    def _gcv_psi(self, Psi, y, lam, n_probes, seed, exact, rtol, maxiter):
        y = self._tensor(y)
        n = y.shape[0]
        c = self._fit_psi(Psi, y, lam, rtol=rtol, maxiter=maxiter)
        rss = float(torch.sum((y - Psi @ c) ** 2))
        if exact:
            tr = self._trace_smoother_exact(Psi, lam)
        else:
            tr = self._trace_smoother_hutchinson(Psi, lam, n_probes, seed, rtol, maxiter)
        denom = max(n - tr, 1e-12)
        return n * rss / denom**2

    def _trace_smoother_exact(self, Psi, lam: float) -> float:
        """tr S = tr(A^{-1} Psi^T Psi) via one dense multi-rhs solve.

        O(n_dofs^3); validation-scale only."""
        Pd = self.P.toarray()
        Psid = Psi.toarray()
        B = Psid.T @ Psid
        X = dense_solve(self._tensor(B + lam * Pd), self._tensor(B))
        return float(torch.trace(X))

    def _trace_smoother_hutchinson(self, Psi, lam, n_probes, seed, rtol, maxiter) -> float:
        """tr S ~ mean_j v_j^T S v_j, v Rademacher: v^T S v = u^T A^{-1} u
        with u = Psi^T v (S symmetric PSD => nonnegative estimates). The
        probes' solves run as one block CG over the columns of U = Psi^T V,
        each column to rtol on its own ||u_j||."""
        op, pre = self._normal_op(Psi, lam)
        rng = np.random.default_rng(seed)
        V = self._tensor(rng.choice([-1.0, 1.0], size=(n_probes, Psi.shape[0])))
        # the block row-major, where K2 puts a 16-wide block's columns on a
        # warp's lanes: an iteration's Psi, Psi^T and P products take 1.20 ms
        # on an H100 against 3.78 ms with rows on lanes over the (k, n) view
        U = Psi.rmatvec(V.T.contiguous())
        del V
        W, _ = cg(op, U, M_inv=pre, rtol=rtol, maxiter=maxiter)
        return float(torch.linalg.vecdot(U, W, dim=0).mean())

    def select_lambda_gcv(self, locs, y, lambdas, **gcv_kwargs):
        """Minimize GCV over a lambda grid; refits at the argmin.

        Mirrors the reference workflow: Grid optimizer (optimization/grid.h)
        over the GCV functional. Psi is built once for the whole sweep.
        Returns (best_lambda, scores)."""
        Psi = self._basis(locs)
        kw = dict(n_probes=16, seed=0, exact=False, rtol=1e-10, maxiter=2000)
        kw.update(gcv_kwargs)
        scores = [self._gcv_psi(Psi, y, float(lam), **kw) for lam in lambdas]
        best = int(np.argmin(scores))
        self._fit_psi(Psi, y, float(lambdas[best]))
        return float(lambdas[best]), scores
