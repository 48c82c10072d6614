"""Port parity: the general-mesh PDE API path of fdapde_core_tpu_torch
(Triangulation -> FEMSpace -> assembly with the closed-form P1 kernels
K4-K6 -> SparseMatrix -> solve_elliptic -> PDE) against the JAX package,
on the same numpy inputs, in float64 unless a check says otherwise.

On the CPU the port's kernel wrappers run their plain torch versions and
the JAX kernels run in interpret mode; the CUDA kernels themselves are held
against the plain versions by the `cuda`-marked test in
tests/test_torch_assembly.py (skipped without a card).
"""

import importlib
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


def _lattice_network(nx, seed=7, amp=0.35, diagonals=0):
    """A street network: the nodes of _delaunay's jittered (nx+1)^2
    lattice joined by its horizontal and vertical segments, plus
    `diagonals` seeded random diagonal segments (junctions of degree up to
    8); the square's boundary nodes are the network's boundary."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    idx = np.arange((nx + 1) ** 2).reshape(nx + 1, nx + 1)
    segs = [np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
            np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)]
    if diagonals:
        a = rng.choice(nx * nx, diagonals, replace=False)
        i, j = np.divmod(a, nx)
        segs.append(np.stack([idx[i, j], idx[i + 1, j + 1]], 1))
    return pts, np.concatenate(segs).astype(np.int32), ~interior


def _same(got, ref, what, rtol=1e-13):
    """Integer (and boolean) arrays equal; floating ones to rtol max|ref|."""
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.floating):
        assert np.abs(got - ref).max(initial=0.0) <= rtol * max(np.abs(ref).max(initial=0.0), 1e-300), what
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


def _check_geometry_and_meshes_match_jax():
    """The geometry host copies against JAX (ids equal, coordinates to
    1e-13): LinearNetwork on a seeded street network with diagonals
    (node_to_cells, cell_neighbors, derived_boundary_nodes;
    tests/test_geometry.py:89), KDTree nn_search and range_search (:99),
    project approximate and exact (:117, :161), HyperPlane (:127), the
    simplex helpers on 2D, surface and 1D meshes (:176), Voronoi cells,
    edges, markers, measures and locate (:138, :251) and walk_search
    (tests/test_utils_structures.py:37). FEM on the meshes no other port
    test assembles on (tests/test_fem_1d.py:15,34,46,
    tests/test_manifold_3d.py:46,60,84,97): the network, Interval P1/P2, 2D
    P3, a 2.5D surface P1/P2 and P2 tets, -laplacian and mass: rows and
    cols equal, values to 1e-13 max|vals|."""
    import fdapde_core_tpu.geometry as jg
    import fdapde_core_tpu_torch.geometry as tg
    from fdapde_core_tpu.geometry import simplex as jsx
    from fdapde_core_tpu.geometry.projection import nearest_on_simplex as j_nearest
    from fdapde_core_tpu.geometry.structured import unit_cube_mesh as j_unit_cube
    from fdapde_core_tpu.geometry.walk_search import walk_search as j_walk
    from fdapde_core_tpu_torch.geometry import simplex as tsx
    from fdapde_core_tpu_torch.geometry.projection import nearest_on_simplex
    from fdapde_core_tpu_torch.geometry.walk_search import walk_search

    npts, segs, nbnd = _lattice_network(6, diagonals=12)
    nj, nt = fdm.LinearNetwork(npts, segs), fdt.LinearNetwork(npts, segs)
    assert nt.local_dim == 1 and nt.embed_dim == 2 and not nt.derived_boundary_nodes[~nbnd].any()
    for a, b in zip(nt.node_to_cells, nj.node_to_cells):
        _same(a, b, "node_to_cells")
    _same(nt.derived_boundary_nodes, nj.derived_boundary_nodes, "network boundary")
    for c in range(nt.n_cells):
        _same(nt.cell_neighbors(c), nj.cell_neighbors(c), f"cell_neighbors({c})")

    rng = np.random.default_rng(21)
    cloud = rng.uniform(size=(300, 2))
    kj, kt = jg.KDTree(cloud), tg.KDTree(cloud)
    for q in rng.uniform(size=(50, 2)):
        assert kt.nn_search(q) == kj.nn_search(q) == np.argmin(((cloud - q) ** 2).sum(1))
    _same(kt.range_search([0.2, 0.3], [0.6, 0.8]), kj.range_search([0.2, 0.3], [0.6, 0.8]), "range")
    usj, ust = j_unit_square(6), unit_square_mesh(6)
    far = np.array([[0.5, 1.7], [-0.3, 0.5], [0.5, 0.5], [1.3, -0.2]])
    for exact in (False, True):
        _same(tg.project(ust, far, exact=exact), jg.project(usj, far, exact=exact), f"project {exact}")
    tri = np.array([[0, 0], [1, 0], [0, 1]], dtype=float)
    for p in ([2.0, 2.0], [0.2, 0.3], [-1.0, -1.0]):
        _same(nearest_on_simplex(tri, np.array(p)), j_nearest(tri, np.array(p)), "nearest_on_simplex")
    plane = np.array([[0, 0, 0.1], [1, 0.2, 0], [0, 1, 0.3]])
    hj, ht = jg.HyperPlane(plane), tg.HyperPlane(plane)
    q3 = rng.uniform(size=(5, 3))
    for name in ("project", "distance"):
        _same(getattr(ht, name)(q3), getattr(hj, name)(q3), f"HyperPlane.{name}")
    _same(ht.normal(), hj.normal(), "HyperPlane.normal")

    pts, cells, bnd = _delaunay(8)
    lift = np.column_stack([pts, 0.25 * np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1])])
    surf_j, surf_t = fdm.Triangulation(lift, cells, bnd), fdt.Triangulation(lift, cells, bnd)
    ids = rng.integers(0, ust.n_cells, 40)
    inside = np.einsum("nkd,nk->nd", ust.cell_coords[ids], rng.dirichlet([1, 1, 1], size=40))
    _same(tsx.barycentric_coords(ust, ids, inside), jsx.barycentric_coords(usj, ids, inside), "bary")
    _same(tsx.contains(ust, ids, inside), jsx.contains(usj, ids, inside), "contains")
    for mname, mj, mt in (("square", usj, ust), ("surface", surf_j, surf_t), ("network", nj, nt),
                          ("interval", fdm.Interval(0.0, 2.0, 10), fdt.Interval(0.0, 2.0, 10))):
        for name in ("circumcenters", "circumradii", "barycenters"):
            _same(getattr(tsx, name)(mt), getattr(jsx, name)(mj), f"{mname} {name}")
        for a, b in zip(tsx.bounding_boxes(mt), jsx.bounding_boxes(mj)):
            _same(a, b, f"{mname} bounding_boxes")
    _same(walk_search(ust, inside), j_walk(usj, inside), "walk_search")
    _same(walk_search(ust, inside, start=0), ids, "walk_search from cell 0")

    vj, vt = jg.Voronoi(usj), tg.Voronoi(ust)
    for node in range(vt.n_cells):
        cj, ct = vj.cell(node), vt.cell(node)
        _same(ct.vertices, cj.vertices, f"Voronoi cell {node}")
        _same(ct.vertex_on_boundary, cj.vertex_on_boundary, f"Voronoi markers {node}")
        _same(ct.edges(), cj.edges(), f"Voronoi edges {node}")
        assert ct.on_boundary == cj.on_boundary and ct.measure == pytest.approx(cj.measure, rel=1e-13)
    assert vt.measure() == pytest.approx(vj.measure(), rel=1e-13)
    _same(vt.locate(far), vj.locate(far), "Voronoi.locate")
    _same(vt.locate(inside), vj.locate(inside), "Voronoi.locate inside")

    meshes = (("network P1", nj, nt, 1),
              ("interval P1", fdm.Interval(0.0, 2.0, 10), fdt.Interval(0.0, 2.0, 10), 1),
              ("interval P2", fdm.Interval(0.0, 2.0, 10), fdt.Interval(0.0, 2.0, 10), 2),
              ("square P3", usj, ust, 3),
              ("surface P1", surf_j, surf_t, 1), ("surface P2", surf_j, surf_t, 2),
              ("tets P2", j_unit_cube(3), tg.unit_cube_mesh(3), 2))
    for mname, mj, mt, order in meshes:
        sj, st = JSpace(mj, order), TSpace(mt, order)
        for oname, op in (("-laplacian", lambda m: -m.laplacian()), ("mass", lambda m: m.reaction(1.0))):
            A = ja.assemble_matrix(sj, op(fdm))
            B = ta.assemble_matrix(st, op(fdt), device=CPU)
            _same(B.rows, A.rows, f"{mname} {oname} rows")
            _same(B.cols, A.cols, f"{mname} {oname} cols")
            _same(B.vals, A.vals, f"{mname} {oname} vals")


def _check_host_modules_match_jax(pts, cells, bnd):
    """The host modules of the solver-breadth slice against JAX: Neumann
    loads (P1 and P2, constant and callable data, two selectors) and
    integration to 1e-13; the boundary-length identity to 1e-12; FSPAI, the
    port's native L against JAX's native L (and NumPy against NumPy) to
    1e-12; the native first-encounter pass against the NumPy one (ids
    equal, and equal to JAX's); SparseBlockMatrix and BinaryMatrix (JAX's
    tests/test_linear_algebra.py:154 and tests/test_aux.py:11)."""
    from fdapde_core_tpu.fem import neumann as jn
    from fdapde_core_tpu.geometry.triangulation import first_encounter_unique as j_feu
    from fdapde_core_tpu.linear_algebra import SparseBlockMatrix as JBlock
    from fdapde_core_tpu.linear_algebra import fspai as j_fspai
    from fdapde_core_tpu.utils import integration as ji
    from fdapde_core_tpu_torch.fem import neumann as tn
    from fdapde_core_tpu_torch.geometry import triangulation as ttri
    from fdapde_core_tpu_torch.linear_algebra import BinaryMatrix, BinaryVector, SparseBlockMatrix
    from fdapde_core_tpu_torch.native import native_available
    from fdapde_core_tpu_torch.utils import integration as ti

    hfun = lambda x: np.sin(3 * x[..., 0]) + x[..., 1] ** 2  # noqa: E731
    sides = (lambda p: p[:, 0] > 1.0 - 1e-9, lambda p: p[:, 1] < 1e-9, lambda p: p[:, 0] > -1.0)
    for order in (1, 2):
        sj, st = JSpace(j_unit_square(10), order), TSpace(unit_square_mesh(10), order)
        for side in sides:
            for h in (2.0, hfun):
                r = jn.assemble_neumann(sj, h, jn.boundary_facet_selector(sj.mesh, side))
                g = tn.assemble_neumann(st, h, tn.boundary_facet_selector(st.mesh, side), device=CPU)
                assert g.dtype == torch.float64 and np.abs(g.numpy() - r).max() <= 1e-13, order
        whole = tn.boundary_facet_selector(st.mesh, sides[2])
        assert abs(float(tn.assemble_neumann(st, 1.0, whole).sum()) - 4.0) <= 1e-12
    f = lambda x: np.exp(x[..., 0]) * x[..., 1]  # noqa: E731
    mj, mt = fdm.Triangulation(pts, cells, bnd), fdt.Triangulation(pts, cells, bnd)
    for order in (1, 2):
        assert abs(ti.integrate(mt, f, order) - ji.integrate(mj, f, order)) <= 1e-13
        assert np.abs(ti.integrate_cells(mt, f, order) - ji.integrate_cells(mj, f, order)).max() <= 1e-13
    assert abs(ti.integrate(mt, lambda x: 1.0) - 1.0) <= 1e-12

    # the module (the package's name `fspai` is the function)
    tfspai_mod = importlib.import_module("fdapde_core_tpu_torch.linear_algebra.fspai")
    assert native_available()
    rng = np.random.default_rng(12)
    lap = 2 * np.eye(96) - np.eye(96, k=1) - np.eye(96, k=-1)
    spd = rng.standard_normal((60, 60))
    spd = spd @ spd.T + 60 * np.eye(60)
    spd[np.abs(spd) < 1.0] = 0.0
    for a, kw in ((lap, dict(alpha=8, beta=4, epsilon=1e-8)), (spd, dict(alpha=8, beta=8, epsilon=1e-4))):
        before = tfspai_mod.native_calls
        for native in (True, False):
            Lj = j_fspai(JSparse.from_dense(a), native=native, **kw).toarray()
            Lt = tfspai_mod.fspai(SparseMatrix.from_dense(a, device=CPU), native=native, **kw)
            assert Lt.vals.device.type == "cpu"
            assert np.abs(Lt.toarray() - Lj).max() <= 1e-12, native
        assert tfspai_mod.native_calls == before + 1

    keys = np.sort(cells[:, [[0, 1], [0, 2], [1, 2]]].reshape(-1, 2), axis=1).astype(np.int32)
    (un, idn), (up, idp) = ttri.first_encounter_unique(keys), ttri.first_encounter_unique_numpy(keys)
    np.testing.assert_array_equal(idn, idp)
    np.testing.assert_array_equal(un, up)
    np.testing.assert_array_equal(idn, j_feu(keys)[1])

    blocks = [rng.standard_normal((3, 3)), rng.standard_normal((3, 2)), rng.standard_normal((2, 2))]
    blocks = [np.where(rng.uniform(size=b.shape) < 0.6, b, 0.0) for b in blocks]
    dense = np.block([[blocks[0], blocks[1]], [np.zeros((2, 3)), blocks[2]]])
    Bj = JBlock([[JSparse.from_dense(blocks[0]), JSparse.from_dense(blocks[1])],
                 [None, JSparse.from_dense(blocks[2])]])
    Bt = SparseBlockMatrix([[SparseMatrix.from_dense(blocks[0], device=CPU),
                             SparseMatrix.from_dense(blocks[1], device=CPU)],
                            [None, SparseMatrix.from_dense(blocks[2], device=CPU)]])
    x = rng.standard_normal(5)
    assert Bt.shape == Bj.shape == (5, 5)
    np.testing.assert_allclose(Bt.to_sparse().toarray(), dense, rtol=0, atol=1e-14)
    np.testing.assert_allclose((Bt @ _t(x)).numpy(), np.asarray(Bj @ jnp.asarray(x)), rtol=0, atol=1e-14)

    a = BinaryMatrix(np.eye(3), device=CPU)
    b = BinaryMatrix.ones(3, 3, device=CPU)
    assert (a & b).count() == 3 and (a | b).all() and (~a).count() == 6 and (a ^ a).count() == 0
    assert a.block(0, 0, 2, 2).count() == 2 and a.repeat(2, 1).shape == (6, 3)
    v = BinaryVector([1, 0, 1], device=CPU)
    assert v.count() == 2 and not v.all() and v.any() and a[1, 1] is True
    M = np.arange(9.0).reshape(3, 3)
    np.testing.assert_array_equal(a.select(M).numpy(), np.diag(np.diag(M)))
    np.testing.assert_array_equal(a.select(SparseMatrix.from_dense(M, device=CPU)).toarray(),
                                  np.diag(np.diag(M)))


def _check_cg_differentiable_matches_jax():
    """cg_differentiable against JAX's (tests/test_linear_algebra.py:258-350):
    the gradient of |x(theta)|^2 through a dense operator, of a data misfit
    with respect to a diffusion coefficient through the FEM operator's
    SparseMatrix products (K2's backward), and a directional derivative with
    respect to the (nnz,) values of a weighted mass matrix, each to 1e-8
    relative of JAX's and the finite difference; the adjoint solve takes
    about as many iterations as the forward one (within 20 %; the inner one
    none); the inverse problem (kappa* = 3 by
    newton with its Hessian through the solve) to 1e-6, in JAX's number of
    iterations."""
    from fdapde_core_tpu.linear_algebra.solvers import cg_differentiable as j_cgd
    from fdapde_core_tpu.optimization import newton as j_newton
    from fdapde_core_tpu_torch.linear_algebra import cg_differentiable
    from fdapde_core_tpu_torch.optimization import newton

    rng = np.random.default_rng(13)
    Q = rng.standard_normal((30, 30))
    A0, M0, b = Q @ Q.T + 30 * np.eye(30), np.diag(rng.uniform(1, 2, 30)), rng.standard_normal(30)

    def dense_loss(m, solve, theta):
        A, M, bb = (m.asarray(a) for a in (A0, M0, b))
        return m.sum(solve(lambda x: A @ x + theta * (M @ x), bb, rtol=1e-13) ** 2)

    gj = float(jax.grad(lambda t: dense_loss(jnp, j_cgd, t))(0.7))
    th = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    (gt,) = torch.autograd.grad(dense_loss(torch, cg_differentiable, th), th)
    assert abs(float(gt) - gj) <= 1e-8 * abs(gj)

    sj, st = JSpace(j_unit_square(8), 1), TSpace(unit_square_mesh(8), 1)
    target = np.sin(np.pi * st.dof_coords[:, 0]) * np.sin(np.pi * st.dof_coords[:, 1])
    Aj, Mj = ja.assemble_matrix(sj, -fdm.laplacian()), ja.assemble_matrix(sj, fdm.reaction(1.0))
    At, Mt = (ta.assemble_matrix(st, op, device=CPU) for op in (-fdt.laplacian(), fdt.reaction(1.0)))
    Fj, Ft = ja.assemble_forcing(sj, lambda x: 1.0), ta.assemble_forcing(st, lambda x: 1.0, device=CPU)
    maskj, maskt = jnp.asarray(sj.boundary_dofs), _t(st.boundary_dofs)

    def fem_loss(m, solve, A, M, F, mask, kappa, **kw):
        free = (~mask).astype(F.dtype) if m is jnp else (~mask).to(F.dtype)

        def matvec(x):
            return (kappa * (A @ (x * free)) + (M @ (x * free))) * free + x * mask

        return m.sum((solve(matvec, F * free, rtol=1e-13, **kw) - m.asarray(target)) ** 2)

    gj = float(jax.grad(lambda k: fem_loss(jnp, j_cgd, Aj, Mj, Fj, maskj, k))(2.0))
    record = []
    kappa = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    (gt,) = torch.autograd.grad(fem_loss(torch, cg_differentiable, At, Mt, Ft, maskt, kappa,
                                         record=record), kappa)
    eps = 1e-5
    fd = (float(fem_loss(torch, cg_differentiable, At, Mt, Ft, maskt, 2.0 + eps))
          - float(fem_loss(torch, cg_differentiable, At, Mt, Ft, maskt, 2.0 - eps))) / (2 * eps)
    assert abs(float(gt) - gj) <= 1e-8 * abs(gj) and abs(float(gt) - fd) <= 1e-4 * abs(fd)
    kinds = [k for k, _ in record]
    assert kinds[0] == "forward" and kinds.count("adjoint") == 2
    fwd, adj = record[0][1].iterations, record[1][1].iterations
    assert abs(adj - fwd) <= 0.2 * fwd and record[2][1].iterations == 0, record

    # a direction in the values of a weighted mass matrix: d/ds loss(M + s D)
    d = rng.uniform(0.5, 1.5, Mt.nnz)
    s = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    (gt,) = torch.autograd.grad(fem_loss(torch, cg_differentiable, At, Mt.with_vals(Mt.vals + s * _t(d)),
                                         Ft, maskt, 2.0), s)
    gj = float(jax.grad(lambda s: fem_loss(jnp, j_cgd, Aj, Mj.with_vals(Mj.vals + s * jnp.asarray(d)),
                                           Fj, maskj, 2.0))(0.0))
    assert abs(float(gt) - gj) <= 1e-8 * abs(gj)

    sj, st = JSpace(j_unit_square(10), 1), TSpace(unit_square_mesh(10), 1)
    Aj, At = ja.assemble_matrix(sj, -fdm.laplacian()), ta.assemble_matrix(st, -fdt.laplacian(), device=CPU)
    Fj, Ft = ja.assemble_forcing(sj, lambda x: 4.0), ta.assemble_forcing(st, lambda x: 4.0, device=CPU)
    runs = []
    for m, solve, opt, A, F, mask, arr in (
            (jnp, j_cgd, j_newton, Aj, Fj, jnp.asarray(sj.boundary_dofs), jnp.asarray),
            (torch, cg_differentiable, newton, At, Ft, _t(st.boundary_dofs),
             lambda v: torch.tensor(v, dtype=torch.float64))):
        free = (~mask).astype(F.dtype) if m is jnp else (~mask).to(F.dtype)

        def solve_for(kappa, A=A, F=F, mask=mask, free=free, solve=solve):
            return solve(lambda v: kappa * (A @ (v * free)) * free + v * mask, F * free, rtol=1e-13)

        u_obs = solve_for(3.0)
        res = opt(lambda k, u_obs=u_obs, m=m, sf=solve_for: m.sum((sf(k) - u_obs) ** 2), arr([1.0]),
                  tol=1e-12, max_iter=50)
        runs.append((float(res.x[0]), int(res.n_iter)))
    (xj, nj), (xt, nt) = runs
    assert abs(xt - 3.0) <= 1e-6 and nt == nj, runs


def _check_semilinear_and_neumann_match_jax():
    """solve_semilinear against JAX's on unit_square_mesh(12) (-Lap u + u^3
    = f, u = sin(pi x) sin(pi y)): Newton iterations equal, solutions and
    residual histories to 1e-10; h = 0 reproduces the linear solve to 1e-9
    (tests/test_nonlinear.py); the forced BFGS fallback on
    unit_square_mesh(8) agrees with Newton to 1e-4. JAX's
    test_mixed_bc_quadratic_solution on both packages: P2 reproduces x^2 to
    1e-9, P1 within 5e-3, solutions equal to 1e-10."""
    from fdapde_core_tpu.fem import neumann as jn
    from fdapde_core_tpu.fem.nonlinear import solve_semilinear as j_semilinear
    from fdapde_core_tpu_torch.fem import neumann as tn
    from fdapde_core_tpu_torch.models import solve_semilinear

    def exact(x):
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    def forcing(x):
        return 2 * np.pi ** 2 * exact(x) + exact(x) ** 3

    kw = dict(h=lambda v: v ** 3, dh=lambda v: 3 * v ** 2, forcing=forcing, g=np.zeros(169))
    uj, ij = j_semilinear(JSpace(j_unit_square(12), 1), -fdm.laplacian(), **kw)
    st = TSpace(unit_square_mesh(12), 1)
    ut, it = solve_semilinear(st, -fdt.laplacian(), device=CPU, **kw)
    assert it["newton_iterations"] == ij["newton_iterations"] and it["method"] == "newton"
    assert np.abs(ut.numpy() - np.asarray(uj)).max() <= 1e-10
    assert np.abs(np.array(it["residuals"]) - np.array(ij["residuals"])).max() <= 1e-10
    assert it["residuals"][-1] < 1e-10 and np.abs(ut.numpy() - exact(st.dof_coords)).max() < 1e-2

    c = st.dof_coords
    g = 1 - c[:, 0] ** 2 - c[:, 1] ** 2
    ul, _ = solve_semilinear(st, -fdt.laplacian(), h=lambda v: 0.0 * v, dh=lambda v: 0.0 * v,
                             forcing=lambda x: 4.0, g=g, device=CPU)
    A = ta.assemble_matrix(st, -fdt.laplacian(), device=CPU)
    F = ta.assemble_forcing(st, lambda x: 4.0, device=CPU)
    x, _ = tsolvers.solve_elliptic(A, F, _t(st.boundary_dofs), _t(g), rtol=1e-12)
    assert (ul - x).abs().max() <= 1e-9

    s8 = TSpace(unit_square_mesh(8), 1)
    kw8 = dict(kw, g=np.zeros(s8.n_dofs))
    un, _ = solve_semilinear(s8, -fdt.laplacian(), device=CPU, **kw8)
    ub, ib = solve_semilinear(s8, -fdt.laplacian(), device=CPU, max_newton=1, newton_tol=1e-30,
                              bfgs_fallback=True, H_potential=lambda v: v ** 4 / 4, **kw8)
    assert ib["method"] == "bfgs_fallback" and (ub - un).abs().max() < 1e-4

    for order in (1, 2):
        out = []
        for m, nm, space, asm, arr in ((fdm, jn, JSpace(j_unit_square(16), order), ja, jnp.asarray),
                                       (fdt, tn, TSpace(unit_square_mesh(16), order), ta, _t)):
            dev = {} if m is fdm else {"device": CPU}
            A = asm.assemble_matrix(space, -m.laplacian(), **dev)
            F = asm.assemble_forcing(space, lambda x: -2.0, **dev)
            side = nm.boundary_facet_selector(space.mesh, lambda p: p[:, 0] > 1.0 - 1e-9)
            F = F + arr(nm.assemble_neumann(space, 2.0, side))
            coords = space.dof_coords
            dmask = space.boundary_dofs.copy()
            corner = (coords[:, 1] < 1e-9) | (coords[:, 1] > 1 - 1e-9)
            dmask &= ~((coords[:, 0] > 1.0 - 1e-9) & ~corner)
            solve = jsolvers.solve_elliptic if m is fdm else tsolvers.solve_elliptic
            x, _ = solve(A, F, arr(dmask), arr(coords[:, 0] ** 2), rtol=1e-13)
            out.append((np.asarray(x), coords[:, 0] ** 2))
        (xj, exact_j), (xt, exact_t) = out
        assert np.abs(xt - xj).max() <= 1e-10
        assert np.abs(xt - exact_t).max() < (1e-9 if order == 2 else 5e-3), order


def test_affine_sparse_and_assembly_match_jax():
    """affine_maps (torch and NumPy) and SparseMatrix against JAX to 1e-13
    relative; assemble_matrix for -laplacian, diffusion (a matrix K),
    advection, reaction and all four mixed, on P1 and P2 unit_square_mesh(16)
    and P1 on a jittered Delaunay mesh: rows and cols identical, vals to
    1e-13 max|vals| (layout="soa" the same call); assemble_forcing with
    array, multi-column and callable forcing; the host modules of the
    solver-breadth slice (``_check_host_modules_match_jax``); the geometry
    host copies and FEM on networks, intervals, P3, surfaces and P2 tets
    (``_check_geometry_and_meshes_match_jax``)."""
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
    _check_host_modules_match_jax(pts, cells, bnd)
    _check_geometry_and_meshes_match_jax()


def test_entry_step_matches_jax():
    """The port's chain on unit_square_mesh(32) (assembly with K6, forcing
    f = 4, Dirichlet g = 1 - x^2 - y^2, Jacobi CG to 1e-8) reproduces
    __graft_entry__.entry()'s x to 1e-10; the differentiable solve through
    that chain's operators (``_check_cg_differentiable_matches_jax``)."""
    step, (nodes, f_quad, g) = entry()
    xj = np.asarray(jax.jit(step)(jnp.asarray(nodes), jnp.asarray(f_quad), jnp.asarray(g)))
    space = TSpace(unit_square_mesh(32), 1)
    A = ta.assemble_matrix(space, -fdt.laplacian(), device=CPU)
    b = ta.assemble_forcing(space, f_quad.reshape(-1), device=CPU)
    x, info = tsolvers.solve_elliptic(A, b, _t(space.boundary_dofs), _t(g), rtol=1e-8, maxiter=500)
    assert info.converged
    assert np.abs(_np(x) - xj).max() <= 1e-10
    _check_cg_differentiable_matches_jax()


def test_pde_solve_matches_jax(monkeypatch, tmp_path):
    """PDE(...).solve() on a jittered Delaunay mesh below 20,000 dofs with
    Jacobi, solver_preconditioner="auxgrid" and "amg": iteration counts
    equal, solutions to 1e-10 max|x|. SA-AMG's hierarchy against JAX's
    (aggregates and level sizes equal, one V-cycle to 1e-12 max|z|).
    masked_matrix and gmres against JAX; the recovery step (BiCGStab
    stalled at maxiter=3 -> Jacobi GMRES(50)) and its FSPAI rung (CG
    stalled on a symmetric system -> FSPAI GMRES(50)) against JAX's, the
    same warnings; semilinear Newton, its BFGS fallback and mixed Neumann
    data (``_check_semilinear_and_neumann_match_jax``); with the aux grid's
    build failing, the "auto" ladder takes the AMG rung in both packages
    (solutions to 1e-10); on unit_cube_mesh(6) "auto" takes the 3D aux grid
    in both (no AMG hierarchy built, iterations within 1, solutions to
    1e-10 max|x|). Parabolic PDEs on unit_square_mesh(16) over 11
    instants (consistent and lumped mass, and advection through BiCGStab)
    against JAX's solve_parabolic: trajectories to 1e-10 max|u|, the step
    iterations equal, the L2 functional to 1e-10 relative; the stalled-step
    rerun with GMRES(50) gives JAX's warning and trajectory (1e-10). The
    default device is the card, and without one it raises. Networks and the
    1D ladder (``_check_network_and_interval_pde_match_jax``)."""
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
    msgs = [str(w.message) for w in caught if "escalating" in str(w.message)]
    assert msgs == ["elliptic solve did not converge; escalating to GMRES(50) "
                    "(Jacobi-preconditioned)"] * 2, msgs
    assert it.iterations == int(ij.iterations) == 50
    assert np.abs(_np(xt) - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()
    # the FSPAI rung (tests/test_recovery.py:51): symmetric, Jacobi CG
    # stalled at maxiter=60 -> FSPAI-preconditioned GMRES(50), as in JAX
    n = 200
    d = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    Dj, Dt = JSparse.from_dense(d), SparseMatrix.from_dense(d, device=CPU)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xj, ij = jsolvers.solve_elliptic(Dj, jnp.ones(n), jnp.zeros(n, bool), jnp.zeros(n),
                                         rtol=1e-10, maxiter=60)
        xt, it = tsolvers.solve_elliptic(Dt, torch.ones(n, dtype=torch.float64),
                                         torch.zeros(n, dtype=torch.bool),
                                         torch.zeros(n, dtype=torch.float64), rtol=1e-10, maxiter=60)
    msgs = [str(w.message) for w in caught]
    assert len(msgs) == 2 and msgs[0] == msgs[1] and "FSPAI" in msgs[1], msgs
    res = float(torch.linalg.norm(Dt @ xt - 1.0)) / np.sqrt(n)
    assert it.converged and res < 1e-9 and it.iterations == int(ij.iterations)
    assert np.abs(_np(xt) - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()
    _check_semilinear_and_neumann_match_jax()

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
    _check_network_and_interval_pde_match_jax(monkeypatch)
    _check_sharded_poisson_matches_jax(tmp_path)


def _check_sharded_poisson_matches_jax(tmp_path):
    """The element-sharded path on 4 gloo CPU ranks against JAX's on 4
    virtual devices (``torch_sharded.check_against_jax``: solutions within
    max(rtol, 1e-12) max|x|, iterations equal within 1): ShardedPoisson
    segment (tests/test_parallel.py:61) and ELL (:78) at rtol 1e-13, a
    space-varying reaction coefficient (:99), the aux grid (:437, 1e-10),
    solve_elliptic_sharded's halo_dia strategy (:171, 1e-12); the gathered
    local matrices scatter to JAX's assembled matrix (:120, 1e-12), and the
    Morton order and padded partition equal JAX's (:21, :27)."""
    from fdapde_core_tpu.models import solve_elliptic_sharded as j_driver
    from fdapde_core_tpu.parallel import ShardedPoisson as JSharded
    from fdapde_core_tpu.parallel import morton_order as j_morton
    from fdapde_core_tpu.parallel import partition_elements as j_partition
    from fdapde_core_tpu_torch.parallel import morton_order, partition_elements
    from torch_sharded import check_against_jax

    m8 = unit_square_mesh(8)
    np.testing.assert_array_equal(morton_order(m8.cell_barycenters),
                                  j_morton(j_unit_square(8).cell_barycenters))
    for a, b in zip(partition_elements(unit_square_mesh(5), 8),
                    j_partition(j_unit_square(5), 8)):
        np.testing.assert_array_equal(a, b)

    def mesh_spec(n):
        mj = j_unit_square(n)
        return mj, dict(nodes=mj.nodes, cells=mj.cells, boundary=mj.boundary_nodes)

    def poisson_case(name, n, f, rtol, **opts):
        mj, spec = mesh_spec(n)
        space = JSpace(mj, 1)
        coeff = opts.pop("reaction", None)
        op = -fdm.laplacian() if coeff is None else -fdm.laplacian() + fdm.reaction(coeff)
        b = np.asarray(ja.assemble_forcing(space, lambda x: f))
        g = np.zeros(space.n_dofs)
        spec.update(kind="sharded_poisson", b=b, g=g, rtol=rtol, maxiter=3000, reaction=coeff,
                    **opts)
        jopts = {k: v for k, v in opts.items() if k in ("spmv", "preconditioner")}

        def jax_solve(dm):
            x, _, k = JSharded(mj, 1, dm, operator=op, **jopts).solve(b, g, rtol=rtol, maxiter=3000)
            return x, k
        return name, spec, jax_solve, rtol, 1

    mc = j_unit_square(10)
    qn = JSpace(mc, 1).quadrature_nodes
    c = (1.0 + qn[:, 0] + 0.5 * qn[:, 1]).reshape(-1)  # nq * cell + q layout
    mj20, spec20 = mesh_spec(20)
    xy = JSpace(mj20, 1).dof_coords
    g20 = 1 - xy[:, 0] ** 2 - xy[:, 1] ** 2
    spec20.update(kind="elliptic_sharded", forcing=4.0, g=g20, rtol=1e-12)

    def jax_driver(dm):
        x, info = j_driver(mj20, -fdm.laplacian(), lambda p: 4.0, g20, device_mesh=dm, rtol=1e-12)
        assert info["strategy"] == "halo_dia"
        return x, info["iterations"]

    cases = [poisson_case("segment", 16, 1.0, 1e-13),
             poisson_case("ell", 14, 2.0, 1e-13, spmv="ell"),
             poisson_case("varying reaction", 10, 3.0, 1e-13, reaction=c),
             poisson_case("auxgrid", 24, 1.0, 1e-10, preconditioner="auxgrid"),
             poisson_case("assembly", 6, 1.0, 1e-12, assemble=True),
             ("solve_elliptic_sharded", spec20, jax_driver, 1e-12, 1)]
    got, _ = check_against_jax(tmp_path / "sharded_poisson", cases)
    assert str(got[5]["N"]["strategy"]) == "halo_dia"
    A = ja.assemble_matrix(JSpace(j_unit_square(6), 1), -fdm.laplacian()).toarray()
    A_loc, dofs = got[4]["N"]["A_loc"], got[4]["N"]["dofs"]
    dense = np.zeros_like(A)
    np.add.at(dense, (np.repeat(dofs, 3, axis=1), np.tile(dofs, (1, 3))), A_loc.reshape(len(dofs), 9))
    assert np.abs(dense - A).max() < 1e-12


def _check_network_and_interval_pde_match_jax(monkeypatch):
    """PDE on a seeded street network with diagonals (Jacobi below 20,000
    dofs; tests/test_fem_1d.py:61): constant data 2.5 reproduced to 1e-10,
    g = x + y within the data's range (the maximum principle) to 1e-12,
    both equal to JAX's to 1e-10 with the iterations equal. The 1D PDE on
    Interval(0, 1, 160), P1 and P2, with _AUTO_PRECOND_DOFS lowered to 100
    in both packages: both ladders build the 2D aux grid, whose build
    raises on 1-column coordinates, then SA-AMG (the same rung), iterations
    within 1, solutions to 1e-10 max|x|."""
    npts, segs, nbnd = _lattice_network(12, diagonals=30)
    for name, g_of in (("constant", lambda c: np.full(c.shape[0], 2.5)),
                       ("x + y", lambda c: c[:, 0] + c[:, 1])):
        out = []
        for mod, kw in ((fdm, {}), (fdt, {"device": CPU})):
            pde = mod.PDE(mod.LinearNetwork(npts, segs, nbnd), -mod.laplacian(), order=1, **kw)
            g = g_of(pde.dof_coords())
            pde.set_dirichlet_bc(g)
            pde.set_forcing(np.zeros(pde.quadrature_nodes().shape[0]))
            pde.solve()
            out.append((np.asarray(pde.solution()).reshape(-1), pde.report(), g))
        (xj, rj, g), (xt, rt, _) = out
        assert rt["success"] and rt["solver_iterations"] == rj["solver_iterations"], name
        assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max(), name
        if name == "constant":
            assert np.abs(xt - 2.5).max() <= 1e-10
        else:
            gb = g[nbnd]
            assert gb.min() - 1e-12 <= xt.min() and xt.max() <= gb.max() + 1e-12

    import fdapde_core_tpu.pde.pde as jpde
    import fdapde_core_tpu_torch.pde.pde as tpde

    events = []

    def watched(cls):
        orig = cls.build.__func__

        def build(c, *a, **k):
            events.append(cls.__name__)
            try:
                return orig(c, *a, **k)
            except Exception as e:
                events.append(type(e).__name__)
                raise

        monkeypatch.setattr(cls, "build", classmethod(build))

    for cls in (JAux, AuxGridPreconditioner, jamg.AMG, tamg.AMG):
        watched(cls)
    for mod in (jpde, tpde):
        monkeypatch.setattr(mod, "_AUTO_PRECOND_DOFS", 100)
    for order in (1, 2):
        out = []
        for mod, kw in ((fdm, {}), (fdt, {"device": CPU})):
            events.clear()
            pde = mod.PDE(mod.Interval(0.0, 1.0, 160), -mod.laplacian(), order=order, **kw)
            q = pde.quadrature_nodes()
            pde.set_forcing(np.pi ** 2 * np.sin(np.pi * q[:, 0]))
            pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
            pde.solve()
            out.append((np.asarray(pde.solution()).reshape(-1), pde.report(), list(events)))
        (xj, rj, ej), (xt, rt, et) = out
        assert ej == et == ["AuxGridPreconditioner", "IndexError", "AMG"], (ej, et)
        assert rt["success"] and abs(rt["solver_iterations"] - rj["solver_iterations"]) <= 1, order
        assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max(), order
    monkeypatch.undo()


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


# -- the heat equation on the preconditioner ladder (portbench's heat_0p5m) ---

HEAT_TIMES = np.linspace(0.0, 1.0, 11)
# the benchmark's heat_0p5m limits for the solve; the squared L2 error is
# implicit Euler's at dt = 0.1 on a 625-dof mesh (5.2e-6 to 5.4e-6 for mu
# in [0.5, 2]), not the benchmark's
HEAT_LIMITS = {"true_residual": 5e-11, "trajectory_gap": 1e-10, "l2_error": 2e-5}


def _portbench(rel):
    """A module of the benchmark (``portbench/``, no JAX), loaded by path."""
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / rel
    spec = importlib.util.spec_from_file_location(rel.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _heat_mode(p):
    return np.sin(2 * np.pi * p[..., 0]) * np.sin(2 * np.pi * p[..., 1])


def _heat_pde(pts, cells, bnd, mu, times=HEAT_TIMES, **kw):
    """The heat_0p5m problem, u = sin(2 pi x) sin(2 pi y) e^-t with zero
    Dirichlet data, through the PDE API on the CPU."""
    pde = fdt.PDE(fdt.Triangulation(pts, cells, bnd), fdt.dt() - mu * fdt.laplacian(),
                  times=times, order=1, device=CPU, **kw)
    q, c = pde.quadrature_nodes(), pde.dof_coords()
    pde.set_forcing((8 * np.pi ** 2 * mu - 1) * _heat_mode(q)[:, None] * np.exp(-times)[None, :])
    pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
    pde.set_initial_condition(_heat_mode(c))
    return pde


@pytest.mark.parametrize("mu", [0.5, 2.0])
def test_parabolic_auxgrid_passes_the_heat_reference(mu):
    """solve_parabolic with the aux-grid preconditioner, on the assembled
    heat problem at nx = 24 over 11 instants, passes the check of
    ``portbench/reference/heat_0p5m.py`` (its residual and trajectory
    limits); its steps take under a third of Jacobi's iterations, and the
    two trajectories agree to 1e-9.

    The benchmark's plain reference is this test's yardstick on purpose:
    the heat trajectory is held to one independent reference (plain NumPy
    and SciPy, none of the port) wherever it is checked, so a change to that
    reference changes what this test checks too."""
    reference = _portbench("portbench/reference/heat_0p5m.py")
    pts, cells, bnd = _delaunay(24)
    pde = _heat_pde(pts, cells, bnd, mu)
    pde.init()
    mask = _t(pde.space.boundary_dofs)
    g = torch.zeros(pde.n_dofs, HEAT_TIMES.size, dtype=torch.float64)
    u0 = _t(_heat_mode(pde.dof_coords()))
    runs = {}
    for name, pre in (("auxgrid", ("auxgrid", pde.dof_coords())), ("jacobi", None)):
        runs[name] = tsolvers.solve_parabolic(
            pde.stiff(), pde.mass(), pde.force(), mask, g, u0, HEAT_TIMES, rtol=1e-12,
            maxiter=2000, return_info=True, preconditioner=pre)
    (x, info), (xj, infoj) = runs["auxgrid"], runs["jacobi"]
    assert info["rung"] == "auxgrid" and infoj["rung"] == "jacobi"
    assert bool(info["converged"].all()) and not info["escalated"]
    assert int(info["iterations"].max()) * 3 < int(infoj["iterations"].min()), (info, infoj)
    data = {"nodes": pts, "cells": cells, "boundary": bnd, "times": HEAT_TIMES}
    checks = reference.check(data, [(0, {"mu": mu}, {"x": x})], {"limits": HEAT_LIMITS}, None, CPU)
    assert all(value <= limit for _, value, limit in checks), checks
    assert np.abs(_np(x) - _np(xj)).max() <= 1e-9 * np.abs(_np(xj)).max()


def _failing_aux_build(monkeypatch):
    def failing_build(*a, **k):
        raise ValueError("no covering grid")

    monkeypatch.setattr(AuxGridPreconditioner, "build", failing_build)


# (mesh nx, instants, solver_preconditioner, a plant, the rung report() names, fell back)
HEAT_LADDER = {
    "auto_at_20449_dofs": (142, 3, None, None, "auxgrid", False),
    "auxgrid_at_625_dofs": (24, 11, "auxgrid", None, "auxgrid", False),
    "jacobi_default_at_625_dofs": (24, 11, None, None, "jacobi", False),
    "auto_falls_back_to_amg": (24, 11, "auto", _failing_aux_build, "amg", True),
}


@pytest.mark.parametrize("case", list(HEAT_LADDER))
def test_parabolic_pde_takes_the_ladder(case, monkeypatch):
    """The parabolic branch of PDE takes the elliptic branch's preconditioner
    ladder: "auto" by default at 20,000 dofs or more (the auxiliary grid),
    an explicit "auxgrid" below it, Jacobi by default below it, and SA-AMG
    with a warning when the auxiliary grid fails to build; report() names
    the rung and the fall-back."""
    nx, count, pre, plant, rung, fell_back = HEAT_LADDER[case]
    if plant is not None:
        plant(monkeypatch)
    pts, cells, bnd = _delaunay(nx)
    pde = _heat_pde(pts, cells, bnd, 1.0, times=np.linspace(0.0, 1.0, count),
                    solver_preconditioner=pre)
    assert (pde.n_dofs >= 20_000) == (nx == 142)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pde.solve()
    assert any("falling back to SA-AMG" in str(w.message) for w in caught) == fell_back
    rep = pde.report()
    assert rep["success"] and not rep["escalated"], rep
    assert (rep["preconditioner"], rep["ladder_fallback"]) == (rung, fell_back)
    assert len(rep["step_iterations"]) == count - 1
    assert max(rep["step_iterations"]) <= (400 if rung == "jacobi" else 40), rep


def _raising_apply(monkeypatch):
    def apply(self, r):
        raise RuntimeError("a kernel launch failed")

    monkeypatch.setattr(AuxGridPreconditioner, "__call__", apply)


def _out_of_memory_build(monkeypatch):
    def build(*a, **k):
        raise torch.OutOfMemoryError("out of device memory")

    monkeypatch.setattr(AuxGridPreconditioner, "build", build)


LADDER_ERRORS = {"solve_raises": (_raising_apply, "a kernel launch failed"),
                 "build_out_of_memory": (_out_of_memory_build, "out of device memory")}


@pytest.mark.parametrize("fault", list(LADDER_ERRORS))
@pytest.mark.parametrize("problem", ["elliptic", "parabolic"])
def test_auto_ladder_falls_back_only_on_a_failed_build(problem, fault, monkeypatch):
    """The "auto" ladder takes SA-AMG only where the auxiliary grid fails
    to build: an error of the aux-grid solve (a kernel's launch) and out of
    device memory in the build propagate from solve(), elliptic and
    parabolic alike, with no fall-back, no warning and no SA-AMG built."""
    plant, match = LADDER_ERRORS[fault]
    plant(monkeypatch)
    amg_builds = []
    orig = tamg.AMG.build.__func__
    monkeypatch.setattr(tamg.AMG, "build",
                        classmethod(lambda cls, *a, **k: amg_builds.append(1) or orig(cls, *a, **k)))
    pts, cells, bnd = _delaunay(24)
    if problem == "parabolic":
        pde = _heat_pde(pts, cells, bnd, 1.0, solver_preconditioner="auto")
    else:
        pde = fdt.PDE(fdt.Triangulation(pts, cells, bnd), -fdt.laplacian(), order=1,
                      device=CPU, solver_preconditioner="auto")
        pde.set_forcing(np.ones(pde.quadrature_nodes().shape[0]))
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
    with warnings.catch_warnings(record=True) as caught, pytest.raises(RuntimeError, match=match):
        warnings.simplefilter("always")
        pde.solve()
    assert not any("falling back to SA-AMG" in str(w.message) for w in caught)
    assert not pde.ladder_fallback and amg_builds == []


@pytest.mark.parametrize("rerun", [False, True], ids=["converged", "gmres_rerun"])
def test_parabolic_preconditioner_built_once(rerun, monkeypatch):
    """One preconditioner a trajectory: a pde.solve span holds one
    precond.build (rung 0, the auxiliary grid) and AuxGridPreconditioner
    is built once, also when the stalled trajectory is rerun with
    GMRES(50), which runs inside one krylov.recover span on the same
    preconditioner; each implicit-Euler step is a parabolic.step span
    valued by its Krylov iterations (the first pass's are step_info's when
    nothing is rerun)."""
    from fdapde_core_tpu_torch.utils import profiling

    builds = []
    orig = AuxGridPreconditioner.build.__func__
    monkeypatch.setattr(AuxGridPreconditioner, "build",
                        classmethod(lambda cls, *a, **k: builds.append(1) or orig(cls, *a, **k)))
    pts, cells, bnd = _delaunay(24)
    pde = _heat_pde(pts, cells, bnd, 1.0, solver_preconditioner="auxgrid",
                    solver_maxiter=2 if rerun else None)
    steps = HEAT_TIMES.size - 1
    profiling.stop_recording()
    profiling.take_records()
    with warnings.catch_warnings(record=True) as caught, profiling.recording() as recs:
        warnings.simplefilter("always")
        pde.solve()
    assert any("re-running the trajectory" in str(w.message) for w in caught) == rerun
    assert builds == [1]
    (solve,) = [i for i, r in enumerate(recs) if r.name == "pde.solve"]
    assert [(r.name, r.value) for r in recs if r.name == "precond.build"] == [("precond.build", 0)]
    assert all(recs[i].root == solve for i, r in enumerate(recs) if r.name == "precond.build")
    recovers = [i for i, r in enumerate(recs) if r.name == "krylov.recover"]
    assert len(recovers) == int(rerun)
    step_recs = [(i, r) for i, r in enumerate(recs) if r.name == "parabolic.step"]
    first = [r for i, r in step_recs if recs[i].parent not in recovers]
    assert len(first) == steps and len(step_recs) == steps * (1 + rerun)
    assert all(r.parent == solve for r in first)
    rep = pde.report()
    assert rep["preconditioner"] == "auxgrid" and rep["escalated"] == rerun
    if rerun:
        assert all(r.value == 2 for r in first)
    else:
        assert [r.value for r in first] == rep["step_iterations"]
        assert all(any(recs[j].name == "krylov.solve" and recs[j].parent == i
                       for j in range(len(recs))) for i, _ in step_recs)
