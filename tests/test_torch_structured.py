"""Port parity, end to end: StructuredPoisson of fdapde_core_tpu_torch
against the JAX package's (coords -> fused stencil assembly -> Dirichlet
fold + prune -> multigrid-preconditioned CG with f64 Krylov vectors)."""

import jax.numpy as jnp
import numpy as np
import torch

import fdapde_core_tpu  # noqa: F401  (enables x64: JAX's refine="auto" path)
from fdapde_core_tpu.models.structured import StructuredPoisson as JStructured
from fdapde_core_tpu_torch.models import StructuredPoisson


# (n, model dtype, solution tolerance): the f32 model runs an f32 stencil
# and V-cycle under f64 CG vectors
CASES = ((32, "float32", 1e-6), (64, "float32", 1e-6), (32, "float64", 1e-10),
         (64, "float64", 1e-10))


def test_structured_poisson_matches_jax():
    """For each case: same operator offsets and hierarchy, equal iteration
    counts, true residuals within 2x, solutions within xtol * max|x|."""
    rtol = 1e-10
    for n, dtype, xtol in CASES:
        case = f"n={n} {dtype}"
        jm = JStructured(n, dtype=getattr(jnp, dtype), coarse_n=4)
        tm = StructuredPoisson(n, dtype=getattr(torch, dtype), coarse_n=4, device="cpu")
        assert tm.operator().offsets2d == jm.operator().offsets2d, case
        assert tm.multigrid().shapes == jm.multigrid().shapes, case
        np.testing.assert_allclose(tm.rhs().numpy(), np.asarray(jm.rhs()), rtol=0, atol=0,
                                   err_msg=case)

        xj, relj, kj = jm.solve(rtol=rtol, maxiter=60)
        xt, relt, kt = tm.solve(rtol=rtol, maxiter=60)
        xj, relj = np.asarray(xj), float(relj)
        assert xt.dtype == torch.float64 and xt.shape == (tm.m * tm.m,), case
        assert kt == int(kj), case
        assert relt.item() < rtol and relj < rtol, case
        assert 0.5 * relj <= relt.item() <= 2 * relj, case
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=xtol * np.abs(xj).max(),
                                   err_msg=case)


def test_structured_poisson_reproduces_harmonic_data():
    """f = 0 with Dirichlet data g = x + y: the P1 solution is g itself."""
    n = 16
    model = StructuredPoisson(n, dtype=torch.float64, coarse_n=4, device="cpu")
    t = torch.arange(n + 1, dtype=torch.float64) / n
    g = (t[:, None] + t[None, :]).reshape(-1)
    x, rel, k = model.solve(b=model.rhs(0.0, g=g), rtol=1e-11, maxiter=60)
    assert rel.item() < 1e-11 and k <= 12
    assert (x - g).abs().max().item() < 1e-10
