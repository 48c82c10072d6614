"""Kronecker products: dense, sparse, and matrix-free structured matvecs.

Port of ``fdapde_core_tpu/linear_algebra/kron.py`` (counterpart of
fdaPDE-core's linear_algebra/kronecker_product.h). The matrix-free form of
a space-time product is the identity

    (A (x) B) vec(X) = vec(B X A^T)

which turns the Kronecker matvec into two products with the factors, never
materializing the n_a*n_b square operator. Sparse factors run on K2
(``SparseMatrix @``, multi-column); dense float32 factors multiply without
TF32 (``matmul_highest``), as JAX asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse import SparseMatrix, _as_device_tensor

__all__ = ["KroneckerOperator", "kron", "kron_matvec", "matmul_highest"]


def matmul_highest(a, b):
    """a @ b for dense tensors, float32 operands never in TF32: their
    product is formed in float64 and rounded once to float32."""
    if a.dtype == torch.float32 or b.dtype == torch.float32:
        out = torch.promote_types(a.dtype, b.dtype)
        return (a.to(torch.float64) @ b.to(torch.float64)).to(out)
    return a @ b


def kron(A, B):
    """Explicit Kronecker product.

    dense x dense -> dense (torch.kron: a tensor keeps its device, a host
    operand goes to the other's, or to the card); SparseMatrix x
    SparseMatrix -> SparseMatrix on A's device (kronecker_product.h:27-80
    semantics).
    """
    if isinstance(A, SparseMatrix) != isinstance(B, SparseMatrix):
        raise TypeError(
            "kron needs both operands sparse or both dense "
            "(kronecker_product.h supports dense x dense and sparse x sparse); "
            "densify one side or use kron_matvec for the matrix-free product"
        )
    if isinstance(A, SparseMatrix):
        ra, ca = A.rows.cpu().numpy(), A.cols.cpu().numpy()
        rb, cb = B.rows.cpu().numpy(), B.cols.cpu().numpy()
        nb_r, nb_c = B.shape
        rows = (ra[:, None].astype(np.int64) * nb_r + rb[None, :]).reshape(-1)
        cols = (ca[:, None].astype(np.int64) * nb_c + cb[None, :]).reshape(-1)
        vals = (A.vals[:, None] * B.vals.to(A.vals.device)[None, :]).reshape(-1)
        return SparseMatrix.from_coo(rows, cols, vals, (A.shape[0] * nb_r, A.shape[1] * nb_c))
    dev = next((a.device for a in (A, B) if isinstance(a, torch.Tensor)), "cuda")
    return torch.kron(_as_device_tensor(A, dev), _as_device_tensor(B, dev))


def kron_matvec(A, B, x):
    """(A (x) B) @ x without forming the product; A: (m, n), B: (p, q),
    x: (n*q,)."""
    n, q = A.shape[1], B.shape[1]
    X = x.reshape(n, q)
    BX = (B @ X.T).T if isinstance(B, SparseMatrix) else matmul_highest(X, B.T)
    out = (A @ BX) if isinstance(A, SparseMatrix) else matmul_highest(A, BX)
    return out.reshape(-1)


class KroneckerOperator:
    """Matrix-free linear operator for A (x) B, usable by the Krylov solvers."""

    def __init__(self, A, B):
        self.A, self.B = A, B
        self.shape = (A.shape[0] * B.shape[0], A.shape[1] * B.shape[1])

    def __matmul__(self, x):
        return kron_matvec(self.A, self.B, x)

    __call__ = __matmul__
