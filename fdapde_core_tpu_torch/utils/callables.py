"""Batched evaluation of user coefficient/forcing callables (host-only
NumPy; a copy of ``fdapde_core_tpu/utils/callables.py`` without its
``jax.vmap`` tier, which needs JAX).

The reference evaluates coefficients one quadrature point at a time inside
the serial assembly loop (fdaPDE-core fdaPDE/utils/integration/
integrator.h:93-106, fields evaluated per point). A Python per-point loop is
O(C * nq) interpreter calls — ~60M at the 20M-cell benchmark scale — so the
framework evaluates callables in BATCH whenever possible:

1. direct batch call ``value(pts)`` with ``pts`` of shape (K, N), accepted
   only if the output has the expected leading K axis AND a single-point
   spot check agrees (guards against functions like ``lambda x: x[0]**2``
   that happily accept a batch but mean the wrong axis);
2. constant detection: a scalar output equal at three well-separated probe
   points is broadcast (covers the ubiquitous ``lambda x: 4.0``);
3. per-point Python loop (always correct; the documented slow path).

Writing coefficients to accept (K, N) batches (or passing arrays indexed by
``nq * cell + q``, the reference's discretized-field protocol) is the fast
path; either avoids all per-point interpreter work.
"""

from __future__ import annotations

import numpy as np

__all__ = ["eval_at_points"]

_SPOT_RTOL = 1e-12


def _spot_ok(batch_out, ref, k):
    try:
        return np.allclose(
            np.asarray(batch_out[k], dtype=np.float64), ref,
            rtol=_SPOT_RTOL, atol=0.0, equal_nan=True,
        )
    except Exception:
        return False


def eval_at_points(value, pts) -> np.ndarray:
    """Evaluate a callable at a (K, N) batch of points -> (K, *out_shape).

    ``value`` maps one point (N,) -> scalar / (d,) / (d, d); batch-aware
    callables mapping (K, N) -> (K, ...) are detected and used directly.
    """
    pts = np.asarray(pts, dtype=np.float64)
    if pts.ndim != 2:
        raise ValueError(f"pts must be (K, N), got {pts.shape}")
    K = pts.shape[0]
    if K == 0:
        return np.zeros((0,))
    ref = np.asarray(value(pts[0]), dtype=np.float64)

    def _validated(out):
        # check the first AND last rows: index 0 alone can alias when the
        # function mixed up the point/coordinate axes and K == N
        if out is None or out.shape != (K,) + ref.shape:
            return False
        if not _spot_ok(out, ref, 0):
            return False
        if K > 1:
            ref_last = np.asarray(value(pts[K - 1]), dtype=np.float64)
            if ref_last.shape != ref.shape or not _spot_ok(out, ref_last, K - 1):
                return False
        return True

    # 1. direct batch call, validated by spot checks
    try:
        out = np.asarray(value(pts), dtype=np.float64)
    except Exception:
        out = None
    if out is not None and _validated(out):
        return out

    # 2. constant detection: scalar equal at 3 separated probes
    if ref.shape == ():
        probes = {0, K // 2, K - 1}
        if all(
            np.asarray(value(pts[i]), dtype=np.float64).shape == ()
            and float(value(pts[i])) == float(ref)
            for i in probes
        ):
            # one more distinct probe through the batch path already failed
            # or was shape-mismatched; three equal point evals at distinct
            # points is taken as "constant on this point set"
            if K <= 3 or float(value(pts[K // 3])) == float(ref):
                return np.full(K, float(ref))

    # 3. per-point loop (always correct)
    return np.asarray([value(p) for p in pts], dtype=np.float64).reshape(
        (K,) + ref.shape
    )
