"""Port parity: grid stencil operators, Galerkin coarsening, the V-cycle and
Jacobi CG of fdapde_core_tpu_torch against the JAX package, in 2D and on
the 3D Freudenthal lattice.

One operator (JAX-assembled from perturbed coordinate planes, f64; in 3D
the closed-form tet stencil of a jittered unit cube mesh) feeds both
packages; the JAX side runs under jit. All comparisons are in f64 at
1e-12 unless a test states otherwise.
"""

from functools import lru_cache
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdapde_core_tpu  # noqa: F401  (enables x64)
from fdapde_core_tpu.geometry.structured import unit_cube_mesh as j_unit_cube
from fdapde_core_tpu.ops import closed_form as jcf
from fdapde_core_tpu.ops import grid3d as jg3
from fdapde_core_tpu.ops import grid_cg as jcg
from fdapde_core_tpu.ops import grid_mg as jmg
from fdapde_core_tpu.ops import grid_mg3d as jmg3
from fdapde_core_tpu.ops.grid_assembly import stencil_from_coords as j_stencil_from_coords
from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix as JGrid
from fdapde_core_tpu.ops.grid_dia import prune_zero_offsets_grid as j_prune
from fdapde_core_tpu_torch.geometry import unit_cube_mesh
from fdapde_core_tpu_torch.interop import (
    grid_dia_3d_from_numpy,
    grid_dia_from_numpy,
    grid_mg_3d_from_numpy,
    grid_mg_from_numpy,
)
from fdapde_core_tpu_torch.ops import closed_form as tcf
from fdapde_core_tpu_torch.ops import grid3d as tg3
from fdapde_core_tpu_torch.ops import grid_cg as tcg
from fdapde_core_tpu_torch.ops import grid_mg as tmg
from fdapde_core_tpu_torch.ops import grid_mg3d as tmg3
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


def _cube_edges(n, amp, seed=6):
    """(9, 6 n^3) tet edge vectors of unit_cube_mesh(n) with its interior
    nodes jittered by +-amp h (numpy, f64), and the free-node mask."""
    mesh = j_unit_cube(n)
    nodes = mesh.nodes.copy()
    inner = ~mesh.boundary_nodes
    nodes[inner] += np.random.default_rng(seed).uniform(-amp, amp, (inner.sum(), 3)) / n
    p = nodes[mesh.cells]
    e = np.concatenate([(p[:, 1] - p[:, 0]).T, (p[:, 2] - p[:, 0]).T, (p[:, 3] - p[:, 0]).T])
    return e, inner.astype(np.float64)


def _cube3d(n, amp=0.1):
    """The JAX 3D stencil of the jittered cube, its port built by the
    port's own p1_cube_stencil from the same edges, and the free mask."""
    e, free = _cube_edges(n, amp)
    Gj = jg3.p1_cube_stencil(jcf.p1_stiffness_3d_sym(jnp.asarray(e)), n)
    Gt = tg3.p1_cube_stencil(tcf.p1_stiffness_3d_sym(torch.from_numpy(e)), n)
    return Gj, Gt, free


def _port3(Gj):
    return grid_dia_3d_from_numpy(np.asarray(Gj.data), Gj.offsets3d, Gj.shape3d, device="cpu")


@lru_cache(maxsize=None)
def _folded3d():
    """The Dirichlet-folded JAX stencil of the jittered n = 8 cube, its
    free mask and JAX's GridMG3D over it (levels 9, 5, 3), built once: the
    hierarchy's jit compile is most of this file's time."""
    Gj, _, free = _cube3d(8)
    Fj = Gj.with_dirichlet_identity(jnp.asarray(free))
    return Fj, free, jmg3.GridMG3D.build(Fj, coarse_n=2)


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

    # 3D (JAX tests/test_mg.py:189): p1_cube_stencil from packed tet
    # matrices has 15 offsets, equals JAX's and the port's assembled sparse
    # operator (1e-12 of scale); @, diagonal, with_dirichlet_identity and
    # pruning; the uniform cube prunes to the 7-point Laplacian
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_matrix
    from fdapde_core_tpu_torch.pde import laplacian

    n3 = 6
    Gj, Gt, free = _cube3d(n3)
    assert Gt.offsets3d == Gj.offsets3d and len(Gt.offsets3d) == 15
    assert Gt.shape3d == Gj.shape3d == (n3 + 1,) * 3
    scale = np.abs(np.asarray(Gj.data)).max()
    assert np.abs(Gt.data.numpy() - np.asarray(Gj.data)).max() <= 1e-12 * scale, "p1_cube_stencil"
    x3 = rng.normal(size=Gj.n)
    y3 = np.asarray(Gj @ jnp.asarray(x3))
    assert np.abs((Gt @ torch.from_numpy(x3)).numpy() - y3).max() <= 1e-12 * np.abs(y3).max()
    np.testing.assert_allclose(Gt.diagonal().numpy(), np.asarray(Gj.diagonal()), rtol=1e-12)
    Fj3 = Gj.with_dirichlet_identity(jnp.asarray(free))
    Ft3 = Gt.with_dirichlet_identity(torch.from_numpy(free))
    assert np.abs(Ft3.data.numpy() - np.asarray(Fj3.data)).max() <= 1e-12 * scale
    assert tg3.prune_zero_offsets_grid3d(Ft3) is Ft3  # jittered: nothing to drop
    mesh = unit_cube_mesh(n3)
    A = assemble_matrix(FEMSpace(mesh, 1), -laplacian(), device="cpu")
    Gu = tg3.p1_cube_stencil(tcf.p1_stiffness_3d_sym(torch.from_numpy(_cube_edges(n3, 0.0)[0])), n3)
    yu = (A @ torch.from_numpy(x3)).numpy()
    assert np.abs((Gu @ torch.from_numpy(x3)).numpy() - yu).max() <= 1e-12 * np.abs(yu).max(), \
        "3D stencil vs assembled operator"
    Fu = Gu.with_dirichlet_identity(torch.from_numpy(free))
    Pu, Pj = tg3.prune_zero_offsets_grid3d(Fu), jg3.prune_zero_offsets_grid3d(
        jg3.p1_cube_stencil(jcf.p1_stiffness_3d_sym(jnp.asarray(_cube_edges(n3, 0.0)[0])), n3)
        .with_dirichlet_identity(jnp.asarray(free)))
    assert Pu.offsets3d == Pj.offsets3d and len(Pu.offsets3d) == 7, Pu.offsets3d
    np.testing.assert_allclose(Pu.data.numpy(), np.asarray(Pj.data), rtol=0, atol=1e-12)


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

    # 3D: galerkin_coarsen3d of the folded 15-point stencil (27-point out)
    # and once more against JAX's GridMG3D levels, to 1e-12 of scale; the
    # port's GridMG3D.build gives the same levels, and the port's V-cycle
    # of the carried-across hierarchy equals JAX's
    Fj3, _, mgj3 = _folded3d()
    Ct = tmg3.galerkin_coarsen3d(_port3(Fj3))
    assert Ct.offsets3d == mgj3.offsets[1] and len(Ct.offsets3d) == 27 and Ct.shape3d == (5, 5, 5)
    sc = np.abs(np.asarray(mgj3.datas[1])).max()
    assert np.abs(Ct.data.numpy() - np.asarray(mgj3.datas[1])).max() <= 1e-12 * sc, \
        "galerkin_coarsen3d"
    C2t = tmg3.galerkin_coarsen3d(Ct)
    assert np.abs(C2t.data.numpy() - np.asarray(mgj3.datas[2])).max() <= 1e-12 * sc, "twice"
    with pytest.raises(ValueError):  # an even node count does not coarsen
        tmg3.galerkin_coarsen3d(tg3.GridDIA3D(Ct.data[:, :4, :4, :4], Ct.offsets3d, (4, 4, 4)))
    mgt3 = tmg3.GridMG3D.build(_port3(Fj3), coarse_n=2)
    assert mgt3.shapes == tuple(mgj3.shapes) == (9, 5, 3) and mgt3.offsets == tuple(mgj3.offsets)
    for d_t, d_j in zip(mgt3.datas, mgj3.datas):
        assert np.abs(d_t.numpy() - np.asarray(d_j)).max() <= 1e-12 * sc
    carried = grid_mg_3d_from_numpy([np.asarray(d) for d in mgj3.datas], mgj3.offsets, mgj3.shapes,
                                    mgj3.omega, mgj3.nu, mgj3.coarse_iters, device="cpu")
    r3 = np.random.default_rng(3).normal(size=Fj3.n)
    zj3 = np.asarray(jax.jit(lambda mg, v: mg.v_cycle(v))(mgj3, jnp.asarray(r3)))
    for mg in (carried, mgt3):
        zt3 = mg.v_cycle(torch.from_numpy(r3)).numpy()
        np.testing.assert_allclose(zt3, zj3, rtol=0, atol=1e-12 * np.abs(zj3).max())


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

    # 3D: grid_cg3d (x to 1e-12 of scale, |r| to 1e-9 relative); the
    # GridMG3D V-cycle with f32 and bf16 layer storage under f64 vectors
    # (both packages round the layers alike, then run the same f64
    # arithmetic: 1e-12 of scale); mg_preconditioned_cg3d (iterations
    # within 1, solutions to 1e-10 relative, true residuals <= rtol)
    Fj3, free, mgj3 = _folded3d()
    Ft3 = _port3(Fj3)
    b3 = np.random.default_rng(7).normal(size=Fj3.n) * free
    xj3, rj3 = jax.jit(lambda G, v: jg3.grid_cg3d(G, v, 30))(Fj3, jnp.asarray(b3))
    xt3, rt3 = tg3.grid_cg3d(Ft3, torch.from_numpy(b3), 30)
    xj3 = np.asarray(xj3)
    np.testing.assert_allclose(xt3.numpy(), xj3, rtol=0, atol=1e-12 * np.abs(xj3).max())
    np.testing.assert_allclose(rt3.item(), float(rj3), rtol=1e-9)
    mgt3 = tmg3.GridMG3D.build(Ft3, coarse_n=2)
    for storage in ("float32", "bfloat16"):
        zj3 = np.asarray(jax.jit(lambda mg, v: mg.v_cycle(v))(
            mgj3.astype(getattr(jnp, storage)), jnp.asarray(b3)))
        zt3 = mgt3.astype(getattr(torch, storage)).v_cycle(torch.from_numpy(b3)).numpy()
        assert zt3.dtype == np.float64
        np.testing.assert_allclose(zt3, zj3, rtol=0, atol=1e-12 * np.abs(zj3).max(),
                                   err_msg=f"V-cycle, {storage} layers")
    xj3, relj, kj = jmg3.mg_preconditioned_cg3d(Fj3, jnp.asarray(b3), rtol=1e-10, mg=mgj3)
    xt3, relt, kt = tmg3.mg_preconditioned_cg3d(Ft3, torch.from_numpy(b3), rtol=1e-10, mg=mgt3)
    assert abs(kt - int(kj)) <= 1 and kt <= 20, (kt, int(kj))
    assert float(relt) <= 1e-10 and float(relj) <= 1e-10
    xj3 = np.asarray(xj3)
    np.testing.assert_allclose(xt3.numpy(), xj3, rtol=0, atol=1e-10 * np.abs(xj3).max())

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
