"""Shared check of the port's sharded solvers against JAX's (not a test module).

The parent process solves each case with the JAX package on
``make_device_mesh(4)`` and ``make_device_mesh(1)`` of its 8 virtual CPU
devices, then runs the port's solver on 4 spawned gloo CPU ranks
(``fdapde_core_tpu_torch.parallel.dryrun.spawn_gloo``: the ranks import the
port only) and on a world of one. Three comparisons per case, each
tolerance derived from the case's rtol:

- port N=4 against JAX N=4 and port N=1 against port N=4:
  max|diff| <= max(rtol, 1e-12) max(1, max|x|), i.e. within the solver's
  own stopping tolerance (1e-12: the floor of sums taken in another order
  at rtol 1e-13);
- iterations: port N=4 equal to JAX N=4 (where JAX reports them) and to
  port N=1, within ``dk`` (one step more or fewer where the stop test sits
  at the rounding of the last residual).
"""

from __future__ import annotations

import numpy as np

from fdapde_core_tpu.parallel.sharded import make_device_mesh as j_device_mesh
from fdapde_core_tpu_torch.parallel.dryrun import spawn_gloo

N_RANKS = 4


def tolerance(rtol, x):
    return max(rtol, 1e-12) * max(1.0, float(np.abs(x).max()))


def check_against_jax(workdir, cases, dryrun=False):
    """cases: [(name, spec, jax_solve, rtol, dk)]: ``spec`` a ``run_spec``
    dict, ``jax_solve(device_mesh)`` -> (x, iterations) of the JAX solver
    on the same arrays (iterations None where JAX does not report them).
    Returns (port results per case, the dry run's
    {path: (max|diff|, rtol)})."""
    ref = []
    for name, _, jax_solve, _, _ in cases:
        ref.append({n: jax_solve(j_device_mesh(n)) for n in (N_RANKS, 1)})
    results, dry = spawn_gloo([spec for _, spec, _, _, _ in cases], N_RANKS, workdir,
                              dryrun=dryrun)
    for (name, _, _, rtol, dk), jx, got in zip(cases, ref, results):
        xj, kj = np.asarray(jx[N_RANKS][0]), np.asarray(jx[N_RANKS][1])
        xN, x1 = got["N"]["x"], got["1"]["x"]
        tol = tolerance(rtol, xj)
        assert np.abs(xN - xj).max() <= tol, (name, "port N=4 vs JAX N=4", np.abs(xN - xj).max(), tol)
        assert np.abs(x1 - xN).max() <= tol, (name, "port N=1 vs N=4", np.abs(x1 - xN).max(), tol)
        kN, k1 = got["N"]["k"], got["1"]["k"]
        assert np.abs(k1 - kN).max() <= dk, (name, kN, k1)
        assert jx[N_RANKS][1] is None or np.abs(kN - kj).max() <= dk, (name, kj, kN)
    return results, dry
