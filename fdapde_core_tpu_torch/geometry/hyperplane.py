"""M-dimensional hyperplanes embedded in R^N.

Host-only NumPy copy of ``fdapde_core_tpu/geometry/hyperplane.py``
(counterpart of fdaPDE-core's fdaPDE/geometry/hyperplane.h): a plane
through M+1 points with an orthonormal basis of its tangent space,
supporting projection and point-plane distance.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HyperPlane"]


class HyperPlane:
    """Affine subspace of dimension M in R^N through given points."""

    def __init__(self, points: np.ndarray):
        pts = np.asarray(points, dtype=np.float64)
        self.p0 = pts[0]
        D = (pts[1:] - pts[0]).T  # (N, M)
        # orthonormal tangent basis via QR (hyperplane.h:30-60 uses Gram-Schmidt)
        q, _ = np.linalg.qr(D)
        self.basis = q  # (N, M)
        self.M = D.shape[1]
        self.N = D.shape[0]

    def normal(self) -> np.ndarray:
        """Unit normal (meaningful for M == N - 1)."""
        # full QR: the columns of Q after the M-th span the orthogonal complement
        q, _ = np.linalg.qr(np.concatenate([self.basis, np.eye(self.N)], axis=1))
        return q[:, self.M]

    def project(self, p: np.ndarray) -> np.ndarray:
        """Orthogonal projection of p (or a batch of points) onto the plane."""
        p = np.asarray(p, dtype=np.float64)
        coeff = (p - self.p0) @ self.basis  # (..., M)
        return self.p0 + coeff @ self.basis.T

    def distance(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        return np.linalg.norm(p - self.project(p), axis=-1)
