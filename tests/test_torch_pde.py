"""Port parity: the general-mesh PDE API path of fdapde_core_tpu_torch
(Triangulation -> FEMSpace -> assembly with the closed-form P1 kernels
K4-K6 -> SparseMatrix -> solve_elliptic -> PDE) against the JAX package,
on the same numpy inputs, in float64 unless a check says otherwise.

On the CPU the port's kernel wrappers run their plain torch versions and
the JAX kernels run in interpret mode; the CUDA kernels themselves are held
against the plain versions by the `cuda`-marked test in
tests/test_torch_assembly.py (skipped without a card).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay

import fdapde_core_tpu as fdm
import fdapde_core_tpu_torch as fdt
from __graft_entry__ import entry
from fdapde_core_tpu.fem import assembler as ja
from fdapde_core_tpu.fem import solvers as jsolvers
from fdapde_core_tpu.fem.space import FEMSpace as JSpace
from fdapde_core_tpu.geometry.affine import affine_maps as j_affine
from fdapde_core_tpu.geometry.structured import unit_square_mesh as j_unit_square
from fdapde_core_tpu.linear_algebra import amg as jamg
from fdapde_core_tpu.linear_algebra.solvers import gmres as j_gmres
from fdapde_core_tpu.linear_algebra.sparse import SparseMatrix as JSparse
from fdapde_core_tpu.ops import pallas_assembly as jpa
from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner as JAux
from fdapde_core_tpu.utils import DOUBLE_TOLERANCE
from fdapde_core_tpu_torch.fem import assembler as ta
from fdapde_core_tpu_torch.fem import solvers as tsolvers
from fdapde_core_tpu_torch.fem.space import FEMSpace as TSpace
from fdapde_core_tpu_torch.geometry import unit_square_mesh
from fdapde_core_tpu_torch.geometry.affine import affine_maps, affine_maps_np
from fdapde_core_tpu_torch.interop import sparse_from_numpy
from fdapde_core_tpu_torch.linear_algebra import amg as tamg
from fdapde_core_tpu_torch.linear_algebra.solvers import gmres
from fdapde_core_tpu_torch.linear_algebra.sparse import SparseMatrix
from fdapde_core_tpu_torch.ops import local_stiffness as ls
from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner
from fdapde_core_tpu_torch.ops.grid_assembly import (
    p1_grid_stencil,
    p1_grid_stencil_offdiag,
    stencil_from_coords,
)

CPU = "cpu"
K_MATRIX = np.array([[2.0, 0.3], [0.3, 1.0]])
B_VECTOR = np.array([1.0, 0.5])


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _delaunay(nx, seed=7, amp=0.35):
    """bench.py's `general` mesh at nx: a jittered lattice, scipy Delaunay."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    return pts, Delaunay(pts).simplices.astype(np.int32), ~interior


def _criss_cross(n, seed=5, amp=0.1):
    """Perturbed criss-cross mesh in the bench's type-A-then-type-B cell
    order, and its coordinate planes (m, m)."""
    m = n + 1
    i, j = np.divmod(np.arange(n * n), n)
    a = i * m + j
    b = a + m
    cells = np.concatenate([np.stack([a, b, a + 1], 1), np.stack([b, b + 1, a + 1], 1)])
    gi, gj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    nodes = np.stack([gi, gj], -1).reshape(-1, 2).astype(np.float64)
    interior = (nodes[:, 0] > 0) & (nodes[:, 0] < n) & (nodes[:, 1] > 0) & (nodes[:, 1] < n)
    nodes[interior] += np.random.default_rng(seed).uniform(-amp, amp, size=(interior.sum(), 2))
    nodes /= n
    return nodes, cells


def _padded(a, multiple, fill_col):
    """Pad the cell axis of (rows, C) to a multiple with a nondegenerate cell."""
    pad = (-a.shape[1]) % multiple
    return np.concatenate([a, np.tile(np.asarray(fill_col, float)[:, None], (1, pad))], axis=1)


def _laplacian_einsum(space_j, mesh_j):
    """JAX's local_matrices("laplacian") einsum, negated to the positive form."""
    _, invJ, measure = j_affine(jnp.asarray(mesh_j.nodes), jnp.asarray(mesh_j.cells))
    return -np.asarray(ja.local_matrices(
        "laplacian", None, False, jnp.asarray(space_j.phi_tab), jnp.asarray(space_j.grad_tab),
        jnp.asarray(space_j.quad.weights), invJ, measure))


def test_local_stiffness_kernels_match_jax():
    """The plain K4, K5 and K6 against the JAX kernels in interpret mode at
    their padded shapes (f64 to 1e-14 max|A|, f32 to 1e-6 max|A|, eps on
    and off); the CPU wrappers take the plain versions, count no launch
    and check their arguments; K6 against JAX's local_matrices einsum
    (1e-13 max|A|) and inside the port's local_matrices (negated);
    p1_grid_stencil(K4) and p1_grid_stencil_offdiag(K5) against
    stencil_from_coords on the same planes."""
    n = 12
    nodes, cells = _criss_cross(n)
    p = nodes[cells]  # (C, 3, 2)
    coords = p.reshape(-1, 6).T  # rows x1, y1, x2, y2, x3, y3
    edges = np.stack([p[:, 1, 0] - p[:, 0, 0], p[:, 1, 1] - p[:, 0, 1],
                      p[:, 2, 0] - p[:, 0, 0], p[:, 2, 1] - p[:, 0, 1]])
    coords_pad = _padded(coords, jpa.TILE, [0, 0, 1, 0, 0, 1])
    edges_pad = _padded(edges, 128 * jpa.EDGE_TILE_S, [1, 0, 0, 1]).reshape(4, -1, 128)
    counts = (ls.p1_stiffness_2d_launches, ls.p1_stiffness_edges_launches,
              ls.p1_stiffness_edges_offdiag_launches)
    for dtype, rel in ((np.float64, 1e-14), (np.float32, 1e-6)):
        cj, ej = jnp.asarray(coords_pad, dtype), jnp.asarray(edges_pad, dtype)
        ct, et = _t(coords_pad.astype(dtype)), _t(edges_pad.astype(dtype))
        for eps in (None, 0.25):
            cases = [("K4", jpa.p1_stiffness_edges(ej, eps), ls.p1_stiffness_edges_reference(et, eps),
                      ls.p1_stiffness_edges(et, eps)),
                     ("K5", jpa.p1_stiffness_edges_offdiag(ej, eps),
                      ls.p1_stiffness_edges_offdiag_reference(et, eps),
                      ls.p1_stiffness_edges_offdiag(et, eps))]
            if eps is None:
                cases.append(("K6", jpa.p1_stiffness_2d(cj), ls.p1_stiffness_2d_reference(ct),
                              ls.p1_stiffness_2d(ct)))
            for name, ref, plain, wrapped in cases:
                ref, what = np.asarray(ref), f"{name} {dtype.__name__} eps={eps}"
                assert plain.shape == ref.shape and plain.dtype == wrapped.dtype, what
                err = np.abs(_np(plain) - ref).max()
                assert err <= rel * np.abs(ref).max(), f"{what}: {err:.3e}"
                assert torch.equal(wrapped, plain), what
    # unpadded shapes work too, and nothing was launched on the CPU
    assert torch.equal(ls.p1_stiffness_2d(_t(coords)), ls.p1_stiffness_2d_reference(_t(coords)))
    assert counts == (ls.p1_stiffness_2d_launches, ls.p1_stiffness_edges_launches,
                      ls.p1_stiffness_edges_offdiag_launches)
    for bad, exc in ((_t(coords).long(), TypeError), (_t(coords)[:5], ValueError),
                     (_t(coords).T.contiguous().T, ValueError), (_t(coords)[0], ValueError)):
        with pytest.raises(exc):
            ls.p1_stiffness_2d(bad)
    with pytest.raises(ValueError):
        ls.p1_stiffness_edges(_t(coords))

    # K6 == the einsum form, and the K6 route of local_matrices negates it
    pts, dcells, bnd = _delaunay(24)
    for mj in (j_unit_square(16), fdm.Triangulation(pts, dcells, bnd)):
        C = mj.n_cells
        ref = _laplacian_einsum(JSpace(mj, 1), mj)
        k6 = ls.p1_stiffness_2d_reference(_t(mj.nodes[mj.cells].reshape(C, 6).T))
        got = _np(k6).T.reshape(C, 3, 3)
        assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
        via = ta.local_matrices("laplacian", None, False, None, None, None, None, None,
                                coords_t=_t(mj.nodes[mj.cells].reshape(C, 6).T))
        np.testing.assert_array_equal(_np(via), -got)

    # K4 and K5 through the structured stencil == stencil_from_coords
    m = n + 1
    X = np.full((n + 8, 128), 7.0)
    Y = np.full((n + 8, 128), 7.0)
    X[:m, :m] = nodes[:, 0].reshape(m, m)
    Y[:m, :m] = nodes[:, 1].reshape(m, m)
    fused = _np(stencil_from_coords(_t(X), _t(Y), n).data)
    et = _t(edges)
    for G in (p1_grid_stencil(ls.p1_stiffness_edges(et), n),
              p1_grid_stencil_offdiag(ls.p1_stiffness_edges_offdiag(et), n)):
        np.testing.assert_allclose(_np(G.data), fused, rtol=0, atol=1e-12)


def test_affine_sparse_and_assembly_match_jax():
    """affine_maps (torch and NumPy) and SparseMatrix against JAX to 1e-13
    relative; assemble_matrix for -laplacian, diffusion (a matrix K),
    advection, reaction and all four mixed, on P1 and P2 unit_square_mesh(16)
    and P1 on a jittered Delaunay mesh: rows and cols identical, vals to
    1e-13 max|vals| (layout="soa" the same call); assemble_forcing with
    array, multi-column and callable forcing."""
    pts, cells, bnd = _delaunay(24)
    meshes = (("unit square P1", j_unit_square(16), unit_square_mesh(16), 1),
              ("unit square P2", j_unit_square(16), unit_square_mesh(16), 2),
              ("Delaunay P1", fdm.Triangulation(pts, cells, bnd), fdt.Triangulation(pts, cells, bnd), 1))
    ops = {
        "-laplacian": lambda m: -m.laplacian(),
        "diffusion": lambda m: m.diffusion(K_MATRIX),
        "advection": lambda m: m.advection(B_VECTOR),
        "reaction": lambda m: m.reaction(0.7),
        "mixed": lambda m: -m.laplacian() + m.diffusion(K_MATRIX) + m.advection(B_VECTOR)
        + m.reaction(0.7),
    }
    for mname, mj, mt, order in meshes:
        ref = j_affine(jnp.asarray(mj.nodes), jnp.asarray(mj.cells))
        got = affine_maps(_t(mt.nodes), _t(mt.cells))
        host = affine_maps_np(mt.nodes, mt.cells)
        for r, g, h in zip(ref, got, host):
            r = np.asarray(r)
            assert np.abs(_np(g) - r).max() <= 1e-13 * np.abs(r).max(), mname
            assert np.abs(h - r).max() <= 1e-13 * np.abs(r).max(), mname
        sj, st = JSpace(mj, order), TSpace(mt, order)
        for oname, op in ops.items():
            what = f"{mname} {oname}"
            A = ja.assemble_matrix(sj, op(fdm))
            B = ta.assemble_matrix(st, op(fdt), device=CPU)
            np.testing.assert_array_equal(_np(B.rows), np.asarray(A.rows), err_msg=what)
            np.testing.assert_array_equal(_np(B.cols), np.asarray(A.cols), err_msg=what)
            scale = np.abs(np.asarray(A.vals)).max()
            assert np.abs(_np(B.vals) - np.asarray(A.vals)).max() <= 1e-13 * scale, what
        soa = ta.assemble_matrix(st, ops["mixed"](fdt), layout="soa", device=CPU)
        assert torch.equal(soa.vals, B.vals), f"{mname} soa"

        q = st.quadrature_nodes
        f1 = np.sin(3 * q[:, 0]) + q[:, 1]
        fmulti = np.stack([f1, q[:, 0] * q[:, 1], np.ones_like(f1)], 1)
        fcall = lambda x: np.cos(x[..., 0]) * x[..., 1]  # noqa: E731
        for fname, f in (("array", f1), ("multi-column", fmulti), ("callable", fcall)):
            r = np.asarray(ja.assemble_forcing(sj, f))
            g = _np(ta.assemble_forcing(st, f, device=CPU))
            assert g.shape == r.shape, f"{mname} {fname} forcing"
            assert np.abs(g - r).max() <= 1e-13 * np.abs(r).max(), f"{mname} {fname} forcing"

    # SparseMatrix algebra on the last (mixed, non-symmetric) operator
    Aj, At = A, sparse_from_numpy(A.rows, A.cols, A.vals, A.shape, device=CPU)
    rng = np.random.default_rng(3)
    v, V, d = rng.standard_normal(A.shape[0]), rng.standard_normal((A.shape[0], 3)), rng.uniform(
        0.5, 2.0, A.shape[0])
    checks = (
        ("@ vector", At @ _t(v), Aj @ jnp.asarray(v)),
        ("@ block", At @ _t(V), Aj @ jnp.asarray(V)),
        ("rmatvec", At.rmatvec(_t(v)), Aj.rmatvec(jnp.asarray(v))),
        ("T @", At.T @ _t(v), Aj.T @ jnp.asarray(v)),
        ("diagonal", At.diagonal(), Aj.diagonal()),
        ("+", (At + At.T).vals, (Aj + Aj.T).vals),
        ("-", (At - At.T * 0.5).vals, (Aj - Aj.T * 0.5).vals),
        ("scale_rows", At.scale_rows(_t(d)).vals, Aj.scale_rows(jnp.asarray(d)).vals),
        ("scale_cols", (2.0 * At).scale_cols(_t(d)).vals, (2.0 * Aj).scale_cols(jnp.asarray(d)).vals),
        ("toarray", At.toarray(), Aj.toarray()),
        ("to_scipy", At.to_scipy().toarray(), Aj.to_scipy().toarray()),
    )
    for name, g, r in checks:
        r = np.asarray(r)
        assert np.abs(_np(g) - r).max() <= 1e-13 * np.abs(r).max(), f"SparseMatrix {name}"
    rows = np.concatenate([np.asarray(A.rows)] * 2)
    cols = np.concatenate([np.asarray(A.cols)] * 2)
    vals = np.concatenate([np.asarray(A.vals), rng.standard_normal(A.nnz)])
    Dj, Dt = JSparse.from_coo(rows, cols, jnp.asarray(vals), A.shape), SparseMatrix.from_coo(
        rows, cols, _t(vals), A.shape)
    np.testing.assert_array_equal(_np(Dt.rows), np.asarray(Dj.rows))
    assert np.abs(_np(Dt.vals) - np.asarray(Dj.vals)).max() <= 1e-13 * np.abs(np.asarray(Dj.vals)).max()


def test_entry_step_matches_jax():
    """The port's chain on unit_square_mesh(32) (assembly with K6, forcing
    f = 4, Dirichlet g = 1 - x^2 - y^2, Jacobi CG to 1e-8) reproduces
    __graft_entry__.entry()'s x to 1e-10."""
    step, (nodes, f_quad, g) = entry()
    xj = np.asarray(jax.jit(step)(jnp.asarray(nodes), jnp.asarray(f_quad), jnp.asarray(g)))
    space = TSpace(unit_square_mesh(32), 1)
    A = ta.assemble_matrix(space, -fdt.laplacian(), device=CPU)
    b = ta.assemble_forcing(space, f_quad.reshape(-1), device=CPU)
    x, info = tsolvers.solve_elliptic(A, b, _t(space.boundary_dofs), _t(g), rtol=1e-8, maxiter=500)
    assert info.converged
    assert np.abs(_np(x) - xj).max() <= 1e-10


def test_pde_solve_matches_jax(monkeypatch):
    """PDE(...).solve() on a jittered Delaunay mesh below 20,000 dofs with
    Jacobi, solver_preconditioner="auxgrid" and "amg": iteration counts
    equal, solutions to 1e-10 max|x|. SA-AMG's hierarchy against JAX's
    (aggregates and level sizes equal, one V-cycle to 1e-12 max|z|).
    masked_matrix and gmres against JAX; the recovery step (BiCGStab
    stalled at maxiter=3 -> GMRES(50)) against JAX's; with the aux grid's
    build failing, the "auto" ladder takes the AMG rung in both packages
    (solutions to 1e-10); on unit_cube_mesh(6) "auto" takes the 3D aux grid
    in both (no AMG hierarchy built, iterations within 1, solutions to
    1e-10 max|x|). Parabolic PDEs on unit_square_mesh(16) over 11
    instants (consistent and lumped mass, and advection through BiCGStab)
    against JAX's solve_parabolic: trajectories to 1e-10 max|u|, the step
    iterations equal, the L2 functional to 1e-10 relative; the stalled-step
    rerun with GMRES(50) gives JAX's warning and trajectory (1e-10). The
    default device is the card, and without one it raises."""
    pts, cells, bnd = _delaunay(40)
    for pre in (None, "auxgrid", "amg"):
        out = []
        for mod, kw in ((fdm, {}), (fdt, {"device": CPU})):
            pde = mod.PDE(mod.Triangulation(pts, cells, bnd), -mod.laplacian(), order=1,
                          solver_preconditioner=pre, **kw)
            q = pde.quadrature_nodes()
            pde.set_forcing(2 * np.pi ** 2 * np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1]))
            pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
            pde.init()
            pde.solve()
            out.append((np.asarray(pde.solution()), pde.report()))
        (xj, rj), (xt, rt) = out
        assert rt["solver_iterations"] == rj["solver_iterations"], pre
        assert rt["success"] and rj["success"] and rt["stiff_nnz"] == rj["stiff_nnz"], pre
        assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max(), pre

    # masked_matrix, gmres and the recovery step, on the mixed operator
    mj, mt = fdm.Triangulation(pts, cells, bnd), fdt.Triangulation(pts, cells, bnd)
    op = lambda m: -m.laplacian() + m.advection(B_VECTOR)  # noqa: E731
    Aj = ja.assemble_matrix(JSpace(mj, 1), op(fdm))
    At = ta.assemble_matrix(TSpace(mt, 1), op(fdt), device=CPU)
    Mj, Mt = jsolvers.masked_matrix(Aj, jnp.asarray(bnd)), tsolvers.masked_matrix(At, _t(bnd))
    assert np.abs(_np(Mt.vals) - np.asarray(Mj.vals)).max() <= 1e-13 * np.abs(np.asarray(Mj.vals)).max()
    b = np.random.default_rng(8).uniform(0.5, 1.5, At.shape[0]) / At.shape[0]
    g = pts[:, 0] * pts[:, 1]
    sj, st = jsolvers.DirichletSystem(Aj, jnp.asarray(bnd)), tsolvers.DirichletSystem(At, _t(bnd))
    xj, ij = j_gmres(sj, sj.rhs(jnp.asarray(b), jnp.asarray(g)), rtol=1e-10, restart=30)
    xt, it = gmres(st, st.rhs(_t(b), _t(g)), rtol=1e-10, restart=30)
    assert it.iterations == int(ij.iterations) and it.converged and bool(ij.converged)
    assert np.abs(_np(xt) - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xj, ij = jsolvers.solve_elliptic(Aj, jnp.asarray(b), jnp.asarray(bnd), jnp.asarray(g),
                                         symmetric=False, rtol=1e-10, maxiter=3)
        xt, it = tsolvers.solve_elliptic(At, _t(b), _t(bnd), _t(g), symmetric=False, rtol=1e-10,
                                         maxiter=3)
    assert any("FSPAI rung of the JAX package is not ported" in str(w.message) for w in caught)
    assert it.iterations == int(ij.iterations) == 50
    assert np.abs(_np(xt) - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()

    # SA-AMG of the masked Laplacian: the hierarchy against JAX's
    Lj = jsolvers.masked_matrix(ja.assemble_matrix(JSpace(mj, 1), -fdm.laplacian()), jnp.asarray(bnd))
    Lt = tsolvers.masked_matrix(ta.assemble_matrix(TSpace(mt, 1), -fdt.laplacian(), device=CPU), _t(bnd))
    rj, cj = jamg.strength_graph(Lj.to_scipy(), 0.08)
    rt, ct = tamg.strength_graph(Lt.to_scipy(), 0.08)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(tamg.aggregate(Lt.shape[0], rt, ct, seed=3),
                                  jamg.aggregate(Lj.shape[0], rj, cj, seed=3))
    mgj, mgt = jamg.AMG.build(Lj, coarse_max=60), tamg.AMG.build(Lt, coarse_max=60)
    assert mgt.level_sizes() == mgj.level_sizes() and len(mgt.level_sizes()) == 3
    assert mgt.operator_complexity() == pytest.approx(mgj.operator_complexity(), rel=1e-14)
    r = np.random.default_rng(9).standard_normal(Lt.shape[0])
    zj = np.asarray(mgj.v_cycle(jnp.asarray(r)))
    assert np.abs(_np(mgt.v_cycle(_t(r))) - zj).max() <= 1e-12 * np.abs(zj).max()
    xj, ij = jamg.amg_preconditioned_cg(Lj, jnp.asarray(b), mg=mgj, rtol=1e-10)
    xt, it = tamg.amg_preconditioned_cg(Lt, _t(b), mg=mgt, rtol=1e-10)
    assert it.iterations == int(ij.iterations) and it.converged
    assert np.abs(_np(xt) - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()

    # the "auto" ladder's AMG rung, where the aux grid fails to build
    def failing_build(*args, **kwargs):
        raise ValueError("no covering grid")

    out = []
    for mod, cls, kw in ((fdm, JAux, {}), (fdt, AuxGridPreconditioner, {"device": CPU})):
        monkeypatch.setattr(cls, "build", failing_build)
        pde = mod.PDE(mod.Triangulation(pts, cells, bnd), -mod.laplacian(),
                      solver_preconditioner="auto", **kw)
        pde.set_forcing(np.ones(pde.quadrature_nodes().shape[0]))
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
        pde.solve()
        out.append((np.asarray(pde.solution()), pde.report()))
    monkeypatch.undo()
    (xj, rj), (xt, rt) = out
    assert rt["success"] and rt["solver_iterations"] == rj["solver_iterations"]
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()

    # a 3D volume with "auto": both packages take the 3D aux grid, neither
    # builds an AMG hierarchy; iterations within 1, solutions to 1e-10
    # max|x| at rtol 1e-12
    from fdapde_core_tpu.geometry.structured import unit_cube_mesh as j_unit_cube
    from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner3D as JAux3
    from fdapde_core_tpu_torch.geometry import unit_cube_mesh
    from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner3D

    calls = []

    def counted(cls, name):
        orig = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda *a, **k: calls.append((cls, name)) or orig(*a, **k))

    for cls in (JAux3, AuxGridPreconditioner3D):
        counted(cls, "build")
    for cls in (jamg.AMG, tamg.AMG):
        counted(cls, "build")
    out = []
    for mod, mesh, kw in ((fdm, j_unit_cube(6), {}), (fdt, unit_cube_mesh(6), {"device": CPU})):
        pde = mod.PDE(mesh, -mod.laplacian(), solver_preconditioner="auto", **kw)
        pde.set_forcing(np.ones(pde.quadrature_nodes().shape[0]))
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
        pde.solve()
        out.append((np.asarray(pde.solution()).reshape(-1), pde.report()))
    monkeypatch.undo()
    assert calls == [(JAux3, "build"), (AuxGridPreconditioner3D, "build")], calls
    (xj, rj), (xt, rt) = out
    assert rt["success"] and rj["success"]
    assert abs(rt["solver_iterations"] - rj["solver_iterations"]) <= 1
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()

    # parabolic problems against JAX's solve_parabolic on the same inputs
    def exact(x, t):
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) * np.exp(-t)

    times = np.linspace(0.0, 0.1, 11)
    for lumped, L in ((False, lambda m: m.dt() - m.laplacian()),
                      (True, lambda m: m.dt() - m.laplacian()),
                      (False, lambda m: m.dt() - m.laplacian() + m.advection(B_VECTOR))):
        pdes = []
        for mod, mesh, kw in ((fdm, j_unit_square(16), {}), (fdt, unit_square_mesh(16), {"device": CPU})):
            pde = mod.PDE(mesh, L(mod), times=times, order=1, lumped_mass=lumped, **kw)
            c = pde.dof_coords()
            g = exact(c[:, None, :], times[None, :])
            q = pde.quadrature_nodes()
            pde.set_forcing((2 * np.pi ** 2 - 1) * exact(q[:, None, :], times[None, :]))
            pde.set_dirichlet_bc(g)
            pde.set_initial_condition(exact(c, 0.0))
            pde.init()
            pdes.append(pde)
        jp, tp = pdes
        what = f"lumped={lumped} symmetric={jp.operator.is_symmetric}"
        uj, info = jsolvers.solve_parabolic(
            jp.stiff(), jp.mass(), jp.force(), jnp.asarray(jp.space.boundary_dofs), jnp.asarray(g),
            jnp.asarray(exact(c, 0.0)), jnp.asarray(times), lumped=lumped,
            symmetric=jp.operator.is_symmetric, return_info=True)
        ut = tp.solve()
        uj = np.asarray(uj)
        assert tp.success and ut.shape == (tp.n_dofs, times.size), what
        assert np.abs(_np(ut) - uj).max() <= 1e-10 * np.abs(uj).max(), what
        assert tp.report()["step_iterations"] == np.asarray(info["iterations"]).tolist(), what
        jp._solution = jnp.asarray(uj)
        assert tp.l2_error(g) == pytest.approx(jp.l2_error(g), rel=1e-10), what

    # a stalled step poisons the trajectory: both rerun it with GMRES(50)
    n1 = 40
    h = 1.0 / (n1 - 1)
    main = np.full(n1, 2.0 / h)
    main[0] = main[-1] = 1.0
    Ad = np.diag(main) + np.diag(np.full(n1 - 1, -1.0 / h), 1) + np.diag(np.full(n1 - 1, -1.0 / h), -1)
    Ad[0, 1] = Ad[-1, -2] = 0.0
    Md = np.diag(np.full(n1, h))
    mask1 = np.zeros(n1, bool)
    mask1[[0, -1]] = True
    t1 = np.linspace(0.0, 0.1, 5)
    u0 = np.sin(np.pi * np.linspace(0, 1, n1))
    zeros = np.zeros((n1, 5))
    runs = []
    for S, kw, xp in ((JSparse, {}, jnp.asarray), (SparseMatrix, {"device": CPU}, _t)):
        solve = jsolvers.solve_parabolic if S is JSparse else tsolvers.solve_parabolic
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, info = solve(S.from_dense(Ad, **kw), S.from_dense(Md, **kw), xp(zeros), xp(mask1),
                              xp(zeros), xp(u0), t1, rtol=1e-12, maxiter=3, return_info=True)
        runs.append((np.asarray(out), info, [str(w.message) for w in caught]))
    (oj, ij, wj), (ot, it, wt) = runs
    assert it["escalated"] and ij["escalated"]
    assert [m for m in wt if "parabolic step" in m] == [m for m in wj if "parabolic step" in m] != []
    np.testing.assert_array_equal(_np(it["iterations"]), np.asarray(ij["iterations"]))
    assert np.abs(ot - oj).max() <= 1e-10 * np.abs(oj).max()

    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises((AssertionError, RuntimeError)):
            fdt.PDE(mt, -fdt.laplacian()).init()


def test_pde_harmonic_and_l2_slope():
    """On the port's unit_square_mesh: harmonic data u = x + y is
    reproduced to an L2 error functional below 50 eps (P1 and P2), and the
    P1 error of u = sin(pi x) sin(pi y) falls with slope ~2 over three
    refinements (h = 1/8 ... 1/64); so does the max-over-time error of
    the P1 heat equation u = sin(pi x) sin(pi y) e^-t over [0, 0.1] with
    dt = h^2 (h = 1/8 ... 1/32; implicit Euler is first order in dt), the
    reference's parabolic anchor (fem_pde_test.cpp:364-367)."""
    for order in (1, 2):
        pde = fdt.PDE(unit_square_mesh(16), -fdt.laplacian(), order=order, device=CPU)
        c = pde.dof_coords()
        g = c[:, 0] + c[:, 1]
        pde.set_dirichlet_bc(g)
        pde.set_forcing(np.zeros((pde.quadrature_nodes().shape[0], 1)))
        pde.init()
        pde.solve()
        assert pde.success and pde.l2_error(g) < DOUBLE_TOLERANCE, order
    errors = []
    for n in (8, 16, 32, 64):
        pde = fdt.PDE(unit_square_mesh(n), -fdt.laplacian(), order=1, device=CPU,
                      forcing=lambda x: 2 * np.pi ** 2 * np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]))
        c = pde.dof_coords()
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
        pde.solve()
        errors.append(np.sqrt(pde.l2_error(np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]))))
    slopes = np.log2(np.array(errors[:-1]) / np.array(errors[1:]))
    assert np.all((slopes > 1.9) & (slopes < 2.1)), slopes

    def exact(x, t):
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) * np.exp(-t)

    errors = []
    for n in (8, 16, 32):
        times = np.linspace(0.0, 0.1, round(0.1 * n * n) + 1)
        pde = fdt.PDE(unit_square_mesh(n), fdt.dt() - fdt.laplacian(), times=times, device=CPU)
        c, q = pde.dof_coords(), pde.quadrature_nodes()
        g = exact(c[:, None, :], times[None, :])
        pde.set_forcing((2 * np.pi ** 2 - 1) * exact(q[:, None, :], times[None, :]))
        pde.set_dirichlet_bc(g)
        pde.set_initial_condition(exact(c, 0.0))
        pde.solve()
        assert pde.success and not pde.report()["escalated"], n
        errors.append(np.sqrt(pde.l2_error(g)))
    slopes = np.log2(np.array(errors[:-1]) / np.array(errors[1:]))
    assert np.all((slopes > 1.9) & (slopes < 2.1)), slopes
