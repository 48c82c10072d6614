"""FSPAI: factorized sparse approximate inverse preconditioner for SPD matrices.

Port of ``fdapde_core_tpu/linear_algebra/fspai.py``, the counterpart of
fdaPDE-core's fdaPDE/linear_algebra/fspai.h:42-271 (dormant
in the reference umbrella but spec-relevant: it is the natural CG
preconditioner for this framework). Computes a sparse lower-triangular L with
L L^T ~= A^{-1} by K-condition-number minimization with adaptive sparsity
pattern:

- per column k, `alpha` pattern-update steps,
- each step augments the pattern with up to `beta` candidate indices whose
  estimated K-condition reduction tau exceeds `epsilon`,
- column solve: A(J,J) y = A(J,k);  L_kk = 1/sqrt(A_kk - b^T y),
  L(J,k) = -y * L_kk   (fspai.h updateApproximateInverse).

Runs host-side (the native C++ of ``native/fspai.cpp``, or NumPy/SciPy) as
a preprocessing step; the resulting L is returned as a device
`SparseMatrix` so that M^{-1} r = L (L^T r) is two K2 products inside the
Krylov loop. Difference from the JAX module: ``native=True`` raises when the
native library fails to build (JAX silently takes the NumPy path); it takes
the NumPy path only where no g++ is on PATH.
"""

from __future__ import annotations

import numpy as np

import torch

from .sparse import SparseMatrix

__all__ = ["fspai"]

# fspai calls that took the native library since import (a caller may reset
# it to 0)
native_calls = 0


def fspai(A, alpha: int = 10, beta: int = 10, epsilon: float = 0.005,
          native: bool = True) -> SparseMatrix:
    """Approximate inverse Cholesky factor L of SPD matrix A (L L^T ~= A^{-1}),
    float64, on A's device for a ``SparseMatrix`` and on the card for a
    dense array.

    Takes the native C++ implementation (native/fspai.cpp) where a g++ can
    build it; the NumPy path below otherwise, or with ``native=False``.
    """
    from ..native import native_available

    device = A.vals.device if isinstance(A, SparseMatrix) else "cuda"
    As = _host_csr(A)
    if native and native_available():
        return _fspai_native(As, alpha, beta, epsilon, device)
    As = As.tocsc()
    n = As.shape[0]
    Ad = As.diagonal()
    rows_out, cols_out, vals_out = [], [], []

    Acsr = As.tocsr()
    for k in range(n):
        Jk: list[int] = []  # current pattern (indices > k), excluding k itself
        yk = np.zeros(0)
        for _ in range(alpha + 1):
            if Jk:
                sub = As[np.ix_(Jk, Jk)].toarray()
                bk = np.asarray(As[Jk, [k] * len(Jk)]).reshape(-1)
                yk = np.linalg.solve(sub, bk)
                lkk = 1.0 / np.sqrt(max(Ad[k] - bk @ yk, 1e-300))
            else:
                bk = np.zeros(0)
                lkk = 1.0 / np.sqrt(Ad[k])
            # candidate selection (fspai.h selectCandidates): tau_j estimates
            # the K-condition reduction from adding index j to the pattern
            lk = np.zeros(n)
            lk[k] = lkk
            if Jk:
                lk[Jk] = -yk * lkk
            r = Acsr @ lk  # residual A L_k; nonzero rows are candidates
            cand = np.nonzero(r)[0]
            cand = cand[(cand > k) & ~np.isin(cand, Jk)]
            if cand.size == 0:
                break
            tau = r[cand] ** 2 / Ad[cand]
            good = tau > epsilon
            if not good.any():
                break
            cand, tau = cand[good], tau[good]
            take = cand[np.argsort(-tau, kind="stable")[:beta]]
            Jk.extend(int(j) for j in take)
            Jk.sort()
        # final column
        if Jk:
            sub = As[np.ix_(Jk, Jk)].toarray()
            bk = np.asarray(As[Jk, [k] * len(Jk)]).reshape(-1)
            yk = np.linalg.solve(sub, bk)
            lkk = 1.0 / np.sqrt(max(Ad[k] - bk @ yk, 1e-300))
        else:
            lkk = 1.0 / np.sqrt(Ad[k])
        rows_out.append(k)
        cols_out.append(k)
        vals_out.append(lkk)
        for j, y in zip(Jk, yk if len(Jk) else []):
            rows_out.append(j)
            cols_out.append(k)
            vals_out.append(-y * lkk)

    return SparseMatrix.from_coo(
        np.asarray(rows_out), np.asarray(cols_out),
        torch.as_tensor(np.asarray(vals_out, dtype=np.float64), device=device), (n, n)
    )


def _host_csr(A):
    """A as a host scipy CSR matrix."""
    if isinstance(A, SparseMatrix):
        return A.to_scipy().tocsr()
    from scipy.sparse import csr_matrix

    return csr_matrix(np.asarray(A))


def _fspai_native(As, alpha, beta, epsilon, device):
    global native_calls
    from ..native.build import get_lib

    lib = get_lib()
    As = As.tocsr()
    As.sort_indices()
    n = As.shape[0]
    indptr = As.indptr.astype(np.int64)
    indices = As.indices.astype(np.int32)
    values = As.data.astype(np.float64)
    cap = n * (1 + alpha * beta)
    rows = np.empty(cap, dtype=np.int32)
    cols = np.empty(cap, dtype=np.int32)
    vals = np.empty(cap, dtype=np.float64)
    nnz = lib.fspai_csr(
        indptr.ctypes.data, indices.ctypes.data, values.ctypes.data,
        n, alpha, beta, float(epsilon),
        rows.ctypes.data, cols.ctypes.data, vals.ctypes.data,
    )
    if nnz < 0:
        raise RuntimeError("native fspai_csr failed")
    native_calls += 1
    return SparseMatrix.from_coo(rows[:nnz], cols[:nnz],
                                 torch.as_tensor(vals[:nnz], device=device), (n, n))
