"""Sherman–Morrison–Woodbury solver.

Port of ``fdapde_core_tpu/linear_algebra/smw.py`` (counterpart of
fdaPDE-core's linear_algebra/smw.h:40-59): solve (A + U C^{-1} V) x = b
given a solver for A (callable b -> A^{-1} b, e.g. a preconditioned CG
closure) and the small dense inverse invC, via

    M^{-1} b = y - A^{-1} U (C^{-1} + V A^{-1} U)^{-1} V y,   y = A^{-1} b.
"""

from __future__ import annotations

import torch

from .solvers import dense_solve
from .sparse import _as_device_tensor

__all__ = ["smw_solve"]


def smw_solve(solve_A, U, invC, V, b):
    """Solve (A + U D V) x = b where ``invC`` = D^{-1}.

    The reference's contract (smw.h:45-58): the capacitance matrix is
    G = invC + V A^{-1} U, so the supplied ``invC`` is the *inverse* of the
    middle factor.

    solve_A: callable returning A^{-1} r for a vector or (n, k) matrix r.
    U: (n, q), invC: (q, q), V: (q, n), b: (n,) or (n, k). Tensors keep
    their device; host U, V or invC go to the first tensor's device among
    them, else to the card.
    """
    dev = next((a.device for a in (U, V, invC) if isinstance(a, torch.Tensor)), "cuda")
    U, V, invC = (_as_device_tensor(a, dev) for a in (U, V, invC))
    y = solve_A(b)  # y = A^{-1} b            (smw.h:48)
    Y = solve_A(U)  # Y = A^{-1} U            (smw.h:50)
    G = invC + V @ Y  # G = C^{-1} + V A^{-1} U (smw.h:52)
    t = dense_solve(G, V @ y)  # (smw.h:55)
    return y - solve_A(U @ t)  # (smw.h:57)
