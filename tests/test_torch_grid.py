"""Port parity: grid stencil operators, Galerkin coarsening, the V-cycle and
Jacobi CG of fdapde_core_tpu_torch against the JAX package.

One operator (JAX-assembled from perturbed coordinate planes, f64) feeds
both packages; the JAX side runs under jit. All comparisons are in f64 at
1e-12 unless a test states otherwise.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import fdapde_core_tpu  # noqa: F401  (enables x64)
from fdapde_core_tpu.ops import grid_cg as jcg
from fdapde_core_tpu.ops import grid_mg as jmg
from fdapde_core_tpu.ops.grid_assembly import stencil_from_coords as j_stencil_from_coords
from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix as JGrid
from fdapde_core_tpu.ops.grid_dia import prune_zero_offsets_grid as j_prune
from fdapde_core_tpu_torch.interop import grid_dia_from_numpy, grid_mg_from_numpy
from fdapde_core_tpu_torch.ops import grid_cg as tcg
from fdapde_core_tpu_torch.ops import grid_mg as tmg
from fdapde_core_tpu_torch.ops.grid_dia import GridDIAMatrix, prune_zero_offsets_grid


def _raw_operator(n, seed=4, amp=0.1):
    """JAX stencil of a P1 mesh with interior nodes jittered by +-amp h,
    and the free-dof mask, both f64."""
    m = n + 1
    rng = np.random.default_rng(seed)
    gi, gj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    pert = rng.uniform(-amp, amp, size=(m, m, 2))
    pert[[0, -1]] = 0
    pert[:, [0, -1]] = 0
    X = np.full((n + 8, 128), 3.0)
    Y = np.full((n + 8, 128), 3.0)
    X[:m, :m] = (gi + pert[..., 0]) / n
    Y[:m, :m] = (gj + pert[..., 1]) / n
    G = j_stencil_from_coords(jnp.asarray(X), jnp.asarray(Y), n)
    interior = (np.arange(m) > 0) & (np.arange(m) < n)
    free = (interior[:, None] & interior[None, :]).astype(np.float64).reshape(-1)
    return G, free


def _folded(n):
    G, free = _raw_operator(n)
    return j_prune(G.with_dirichlet_identity(jnp.asarray(free)))


def _port(Gj):
    return grid_dia_from_numpy(np.asarray(Gj.data), Gj.offsets2d, Gj.shape2d, device="cpu")


def test_grid_dia_ops_match_jax():
    n = 12
    Gj, free = _raw_operator(n)
    Gt = _port(Gj)
    rng = np.random.default_rng(0)
    x = rng.normal(size=Gj.n)
    Xb = rng.normal(size=(3, Gj.n))
    np.testing.assert_allclose((Gt @ torch.from_numpy(x)).numpy(),
                               np.asarray(Gj @ jnp.asarray(x)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Gt.matvec_batch(torch.from_numpy(Xb)).numpy(),
                               np.asarray(Gj.matvec_batch(jnp.asarray(Xb))), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(Gt.diagonal().numpy(), np.asarray(Gj.diagonal()))

    Fj = Gj.with_dirichlet_identity(jnp.asarray(free))
    Ft = Gt.with_dirichlet_identity(torch.from_numpy(free))
    np.testing.assert_array_equal(Ft.data.numpy(), np.asarray(Fj.data))

    # uniform geometry: the hypotenuse layers are exact zeros and go
    Uj = j_prune(_raw_operator(n, amp=0.0)[0])
    Ut = prune_zero_offsets_grid(_port(_raw_operator(n, amp=0.0)[0]))
    assert Ut.offsets2d == Uj.offsets2d and len(Ut.offsets2d) == 5
    np.testing.assert_array_equal(Ut.data.numpy(), np.asarray(Uj.data))
    assert prune_zero_offsets_grid(Gt) is Gt  # nothing to drop

    # from_dia takes any flat DIA matrix (duck-typed)
    m = n + 1
    flat = SimpleNamespace(
        n=m * m, offsets=tuple(di * m + dj for di, dj in Gj.offsets2d),
        data=np.array(Gj.data).reshape(len(Gj.offsets2d), -1),
    )
    Dt = GridDIAMatrix.from_dia(flat, (m, m))
    Dj = JGrid.from_dia(flat, (m, m))
    assert Dt.offsets2d == Dj.offsets2d == Gj.offsets2d
    np.testing.assert_array_equal(Dt.data.numpy(), np.asarray(Dj.data))


def test_galerkin_coarsen_matches_jax():
    """Galerkin coarsening, twice; then the V-cycle: the JAX hierarchy
    carried across through interop gives the JAX V-cycle, and the port's
    own build gives the same hierarchy."""
    Gj = _folded(16)
    Cj = jax.jit(jmg.galerkin_coarsen)(Gj)
    Ct = tmg.galerkin_coarsen(_port(Gj))
    assert Ct.offsets2d == Cj.offsets2d and Ct.shape2d == Cj.shape2d == (9, 9)
    np.testing.assert_allclose(Ct.data.numpy(), np.asarray(Cj.data), rtol=0, atol=1e-12)
    # and once more: the coarse 9-point stencil coarsens again
    np.testing.assert_allclose(tmg.galerkin_coarsen(Ct).data.numpy(),
                               np.asarray(jmg.galerkin_coarsen(Cj).data), rtol=0, atol=1e-12)

    Gj = _folded(32)
    mgj = jmg.GridMG.build(Gj, coarse_n=4)
    mgt = grid_mg_from_numpy([np.asarray(d) for d in mgj.datas], mgj.offsets,
                             mgj.shapes, mgj.omega, mgj.nu, mgj.coarse_iters, device="cpu")
    built = tmg.GridMG.build(_port(Gj), coarse_n=4)
    assert built.shapes == mgj.shapes == (33, 17, 9, 5) and built.offsets == mgj.offsets
    for d_t, d_j in zip(built.datas, mgj.datas):
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-12)

    r = np.random.default_rng(1).normal(size=Gj.n)
    zj = np.asarray(jax.jit(lambda mg, v: mg.v_cycle(v))(mgj, jnp.asarray(r)))
    for mg in (mgt, built):
        zt = mg.v_cycle(torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-12 * np.abs(zj).max())


def test_grid_cg_matches_jax():
    """grid_cg with the stencil stored in f32 and in bf16, f64 vectors. Both
    packages round the layers to the same storage values and then run the
    same f64 arithmetic, so the iterates agree to f64 rounding even where
    bf16 storage perturbs the operator.

    Then grid_cg_refined: f32 outer / bf16 inner refinement on a
    well-conditioned shifted system (I + A): both packages reduce the true
    residual alike. bf16 vector arithmetic rounds at other places in the two
    frameworks, so residuals are held within 2x of each other and solutions
    to 1e-5 relative (bf16 inner cycles under f32 refinement), not to
    digits."""
    Gj = _folded(16)
    Gt = _port(Gj)
    b = np.random.default_rng(2).normal(size=Gj.n)
    n_iter = 40
    for data_dtype in ("float32", "bfloat16"):
        xj, rj = jax.jit(
            lambda G, v: jcg.grid_cg(G, v, n_iter, data_dtype=getattr(jnp, data_dtype))
        )(Gj, jnp.asarray(b))
        xt, rt = tcg.grid_cg(Gt, torch.from_numpy(b), n_iter,
                             data_dtype=getattr(torch, data_dtype))
        xj = np.asarray(xj)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12 * np.abs(xj).max(),
                                   err_msg=data_dtype)
        np.testing.assert_allclose(rt.item(), float(rj), rtol=1e-9, err_msg=data_dtype)
        assert rt.item() < 1e-3 * np.linalg.norm(b), data_dtype

    k0 = Gj.offsets2d.index((0, 0))
    Sj = JGrid(Gj.data.at[k0].add(1.0), Gj.offsets2d, Gj.shape2d)
    St = _port(Sj)
    b = np.random.default_rng(5).normal(size=Sj.n)
    xj, rj = jax.jit(lambda G, v: jcg.grid_cg_refined(G, v, 4, 10))(Sj, jnp.asarray(b))
    xt, rt = tcg.grid_cg_refined(St, torch.from_numpy(b), 4, 10)
    assert xt.dtype == torch.float32
    bn = np.linalg.norm(b)
    assert rt.item() < 1e-4 * bn and float(rj) < 1e-4 * bn
    assert 0.5 * float(rj) <= rt.item() <= 2 * float(rj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(xj)).max())
