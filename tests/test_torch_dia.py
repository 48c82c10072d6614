"""Port parity: the DIA-storage elliptic path of fdapde_core_tpu_torch
(assemble_dia -> DIAMatrix on the DIA SpMV kernel K7 -> solve_elliptic, and
GridDIAMatrix.from_dia -> GridMG) against the JAX package, on the same
numpy inputs, in float64.

On the CPU the port's K7 wrapper runs its plain torch version and the JAX
kernel runs in interpret mode; the CUDA kernel itself is held against the
plain version by the `cuda`-marked test in tests/test_torch_assembly.py
(skipped without a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay

import fdapde_core_tpu as fdm
import fdapde_core_tpu_torch as fdt
from fdapde_core_tpu.fem import assembler as ja
from fdapde_core_tpu.fem import solvers as jsolvers
from fdapde_core_tpu.fem.space import FEMSpace as JSpace
from fdapde_core_tpu.geometry.structured import unit_square_mesh as j_unit_square
from fdapde_core_tpu.linear_algebra import dia as jdia
from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix as JGrid
from fdapde_core_tpu.ops.grid_dia import prune_zero_offsets_grid as j_prune_grid
from fdapde_core_tpu.ops.grid_mg import mg_preconditioned_cg as j_mg_cg
from fdapde_core_tpu.ops.pallas_dia import dia_spmv as j_dia_spmv
from fdapde_core_tpu_torch.fem import assembler as ta
from fdapde_core_tpu_torch.fem import solvers as tsolvers
from fdapde_core_tpu_torch.fem.space import FEMSpace as TSpace
from fdapde_core_tpu_torch.geometry import unit_square_mesh
from fdapde_core_tpu_torch.linear_algebra import dia as tdia
from fdapde_core_tpu_torch.ops import dia_spmv as tds
from fdapde_core_tpu_torch.ops.grid_dia import GridDIAMatrix, prune_zero_offsets_grid
from fdapde_core_tpu_torch.ops.grid_mg import mg_preconditioned_cg

CPU = "cpu"
REL = 1e-13  # relative agreement of assembled values (fixed-order sums vs segment_sum)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    err = np.abs(_np(got) - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{what}: {err:.3e}"


def _delaunay(nx, seed=7, amp=0.35, scramble=False):
    """A jittered (nx+1)^2 lattice, scipy Delaunay; with ``scramble`` the
    nodes are relabelled by a random permutation (hundreds of offsets)."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    cells = Delaunay(pts).simplices.astype(np.int32)
    bnd = ~interior
    if scramble:
        p = rng.permutation(pts.shape[0])  # node i becomes p[i]
        pts, bnd = pts[np.argsort(p)], bnd[np.argsort(p)]
        cells = p[cells].astype(np.int32)
    return pts, cells, bnd


def test_dia_path_matches_jax(tmp_path):
    """K7's plain version against JAX's dia_spmv (interpret mode) and
    DIAMatrix @ x; unique_offsets, dia_from_coo (duplicates, a dropped
    offset), prune_zero_offsets, diagonal, to_sparse and assemble_dia against
    JAX to 1e-13 relative on unit_square_mesh(16) and on scrambled and
    natural Delaunay meshes; solve_elliptic on the DIA operator with Jacobi
    (equal iterations, x to 1e-10 max|x|); GridDIAMatrix.from_dia -> MG-CG
    on unit_square_mesh(32) (equal iterations, x to 1e-10); harmonic
    u = x + y through the DIA path to 1e-10."""
    rng = np.random.default_rng(0)
    eps = np.finfo(np.float64).eps

    # K7's plain version == JAX's kernel (n a multiple of its 65536 tile)
    # and JAX's DIAMatrix @ x (any n); the CPU wrapper takes the plain
    # version, offsets as ints or as a tensor, and launches nothing
    before = tds.dia_spmv_launches
    for n, offsets, kernel in ((65536, (-1500, -257, -1, 0, 1, 257, 1500), True),
                               (1000, (-700, -31, -1, 0, 1, 31, 700), False)):
        data, x = rng.standard_normal((len(offsets), n)), rng.standard_normal(n)
        if kernel:
            ref = j_dia_spmv(jnp.asarray(data), offsets, jnp.asarray(x), interpret=True)
        else:
            ref = jdia.DIAMatrix(jnp.asarray(data), offsets, n) @ jnp.asarray(x)
        plain = tds.dia_spmv_reference(_t(data), offsets, _t(x))
        bound = len(offsets) * eps * _np(tds.dia_spmv_reference(_t(np.abs(data)), offsets, _t(np.abs(x))))
        assert (np.abs(_np(plain) - np.asarray(ref)) <= bound).all(), f"n={n}"
        for offs in (offsets, torch.tensor(offsets)):
            assert torch.equal(tds.dia_spmv(_t(data), offs, _t(x)), plain), f"n={n}"
    assert tds.dia_spmv_reference(_t(data), (0, 5000), _t(x)).shape == (n,)  # |d| >= n: no term
    assert tds.dia_spmv_launches == before
    for bad in (dict(x=_t(x).float()), dict(offsets=(0,)), dict(data=_t(data).T)):
        args = dict(data=_t(data), offsets=offsets, x=_t(x)) | bad
        with pytest.raises(ValueError):
            tds.dia_spmv(**args)

    # structure and storage against JAX
    meshes = [("unit square", j_unit_square(16), unit_square_mesh(16))]
    for name, scramble in (("Delaunay", False), ("scrambled Delaunay", True)):
        pts, cells, bnd = _delaunay(10, scramble=scramble)
        meshes.append((name, fdm.Triangulation(pts, cells, bnd), fdt.Triangulation(pts, cells, bnd)))
    for name, mj, mt in meshes:
        sj, st = JSpace(mj, 1), TSpace(mt, 1)
        offsets = tdia.unique_offsets(st.dofs)
        assert offsets == jdia.unique_offsets(sj.dofs), name
        assert len(offsets) >= (100 if name.startswith("scrambled") else 7), (name, len(offsets))
        Dj = ja.assemble_dia(sj, -fdm.laplacian())
        Dt = ta.assemble_dia(st, -fdt.laplacian(), device=CPU)
        assert isinstance(Dt, tdia.DIAMatrix) and Dt.offsets == Dj.offsets and Dt.n == Dj.n, name
        assert Dt.shape == Dj.shape and Dt.data.dtype == torch.float64, name
        _close(Dt.data, Dj.data, REL, f"{name} assemble_dia")
        _close(Dt.diagonal(), Dj.diagonal(), REL, f"{name} diagonal")
        _close(Dt.to_sparse().toarray(), Dj.to_sparse().toarray(), REL, f"{name} to_sparse")
        Pj, Pt = jdia.prune_zero_offsets(Dj), tdia.prune_zero_offsets(Dt)
        assert Pt.offsets == Pj.offsets, name
        _close(Pt.data, Pj.data, REL, f"{name} prune")
        x = rng.standard_normal(Dt.n)
        _close(Dt @ _t(x), Dj.to_sparse().toarray() @ x, REL, f"{name} DIAMatrix @ x")
        _close(Pt @ _t(x), Dt.to_sparse() @ _t(x), REL, f"{name} pruned @ x")

        # dia_from_coo on duplicated entries, with one listed offset left out
        A = ja.assemble_matrix(sj, -fdm.laplacian())
        rows = np.concatenate([np.asarray(A.rows)] * 2)
        cols = np.concatenate([np.asarray(A.cols)] * 2)
        vals = np.concatenate([np.asarray(A.vals), rng.standard_normal(A.nnz)])
        partial = offsets[:1] + offsets[2:]
        Fj = jdia.dia_from_coo(rows, cols, jnp.asarray(vals), Dt.n, partial)
        Ft = tdia.dia_from_coo(rows, cols, _t(vals), Dt.n, partial)
        assert Ft.offsets == Fj.offsets, name
        _close(Ft.data, Fj.data, REL, f"{name} dia_from_coo")
    with pytest.raises(ValueError):
        tdia.dia_from_coo(rows, cols, _t(vals), Dt.n, offsets[::-1])

    # solve_elliptic on the DIA operator, Jacobi CG
    pts, cells, bnd = _delaunay(24)
    for name, mj, mt in (meshes[0], ("Delaunay", fdm.Triangulation(pts, cells, bnd),
                                     fdt.Triangulation(pts, cells, bnd))):
        sj, st = JSpace(mj, 1), TSpace(mt, 1)
        b = rng.uniform(0.5, 1.5, st.n_dofs) / st.n_dofs
        g = st.dof_coords[:, 0] * st.dof_coords[:, 1]
        mask = np.asarray(st.boundary_dofs)
        xj, ij = jsolvers.solve_elliptic(ja.assemble_dia(sj, -fdm.laplacian()), jnp.asarray(b),
                                         jnp.asarray(mask), jnp.asarray(g), rtol=1e-10)
        xt, it = tsolvers.solve_elliptic(ta.assemble_dia(st, -fdt.laplacian(), device=CPU), _t(b),
                                         _t(mask), _t(g), rtol=1e-10)
        assert it.converged and bool(ij.converged) and it.iterations == int(ij.iterations), name
        _close(xt, xj, 1e-10, f"{name} solve_elliptic")

    # the DIA operator on the grid: from_dia -> Dirichlet fold -> MG-CG
    n = 32
    mj, mt = j_unit_square(n), unit_square_mesh(n)
    free = (~mt.boundary_nodes).astype(np.float64)
    b = np.asarray(ja.assemble_forcing(JSpace(mj, 1), lambda p: 1.0)).reshape(-1) * free
    Gj = j_prune_grid(JGrid.from_dia(ja.assemble_dia(JSpace(mj, 1), -fdm.laplacian()), (n + 1, n + 1))
                      .with_dirichlet_identity(jnp.asarray(free)))
    Dt = ta.assemble_dia(TSpace(mt, 1), -fdt.laplacian(), device=CPU)
    Gt = prune_zero_offsets_grid(GridDIAMatrix.from_dia(Dt, (n + 1, n + 1))
                                 .with_dirichlet_identity(_t(free)))
    assert Gt.offsets2d == Gj.offsets2d and len(Gt.offsets2d) == 5
    xj, relj, kj = j_mg_cg(Gj, jnp.asarray(b), rtol=1e-10, maxiter=100, coarse_n=4)
    xt, relt, kt = mg_preconditioned_cg(Gt, _t(b), rtol=1e-10, maxiter=100, coarse_n=4)
    assert kt == int(kj) and float(relt) < 1e-10 and float(relj) < 1e-10
    _close(xt, xj, 1e-10, "MG-CG on from_dia")

    # harmonic data through the DIA path
    space = TSpace(mt, 1)
    g = space.dof_coords.sum(axis=1)
    D = tdia.prune_zero_offsets(ta.assemble_dia(space, -fdt.laplacian(), device=CPU))
    x, info = tsolvers.solve_elliptic(D, torch.zeros(space.n_dofs, dtype=torch.float64),
                                      _t(space.boundary_dofs), _t(g), rtol=1e-12)
    assert info.converged and np.abs(_np(x) - g).max() <= 1e-10
    _check_halo_dia_matches_jax(tmp_path)


def _check_halo_dia_matches_jax(tmp_path):
    """The halo-exchange DIA solvers on 4 gloo CPU ranks against JAX's on 4
    virtual devices (``torch_sharded.check_against_jax``: solutions within
    max(rtol, 1e-12) max|x|, iterations equal within 1): HaloDIASolver on
    unit_square_mesh(24) at 1e-12 (tests/test_parallel.py:143),
    HaloDIAParabolic over 8 implicit-Euler steps on unit_square_mesh(12)
    (:194; every step's iterations), and P2 on unit_square_mesh(16) after
    RCM (:269): the permutation equal to JAX's, the native one equal to the
    NumPy BFS (:353), the offset span cut by more than 4x."""
    from fdapde_core_tpu.parallel import reorder as jreorder
    from fdapde_core_tpu.parallel.halo import HaloDIAParabolic as JPara
    from fdapde_core_tpu.parallel.halo import HaloDIASolver as JHalo
    from fdapde_core_tpu_torch.parallel import reorder as treorder
    from torch_sharded import check_against_jax

    def dia_case(name, Dj, b, free, rtol):
        data, offs = np.asarray(Dj.data), tuple(Dj.offsets)
        spec = dict(kind="halo_dia", data=data, offsets=offs, b=b, free=free, rtol=rtol)

        def jax_solve(dm):
            x, _, k = JHalo(Dj, dm).solve(jnp.asarray(b), jnp.asarray(free), rtol=rtol)
            return x, k
        return name, spec, jax_solve, rtol, 1

    def system(n, order):
        space = JSpace(j_unit_square(n), order)
        A = ja.assemble_matrix(space, -fdm.laplacian())
        F = ja.assemble_forcing(space, lambda x: 4.0)
        xy = space.dof_coords
        g = jnp.asarray(1 - xy[:, 0] ** 2 - xy[:, 1] ** 2)
        mask = jnp.asarray(space.boundary_dofs)
        b = np.asarray(jsolvers.DirichletSystem(A, mask).rhs(F, g))
        return space, A, b, (~space.boundary_dofs).astype(np.float64)

    space, A, b, free = system(24, 1)
    Dj = jdia.dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, jdia.unique_offsets(space.dofs))
    cases = [dia_case("HaloDIASolver", Dj, b, free, 1e-12)]

    # implicit Euler over 8 steps (the first instant is u0)
    sp12 = JSpace(j_unit_square(12), 1)
    A12 = ja.assemble_matrix(sp12, -fdm.laplacian())
    M12 = ja.assemble_matrix(sp12, fdm.reaction(1.0))
    offs12 = jdia.unique_offsets(sp12.dofs)
    Ad = jdia.dia_from_coo(A12.rows, A12.cols, A12.vals, sp12.n_dofs, offs12)
    Md = jdia.dia_from_coo(M12.rows, M12.cols, M12.vals, sp12.n_dofs, offs12)
    times = np.linspace(0.0, 0.2, 9)
    u = lambda x, t: np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) * np.exp(-t)  # noqa: E731
    G = u(sp12.dof_coords[:, None, :], times[None, :])
    qn = sp12.quadrature_nodes
    F = np.asarray(ja.assemble_forcing(sp12, (2 * np.pi ** 2 - 1.0) * u(qn[:, None, :], times[None, :])))
    free12 = (~sp12.boundary_dofs).astype(np.float64)
    para = dict(kind="halo_dia_parabolic", A=np.asarray(Ad.data), M=np.asarray(Md.data),
                offsets=tuple(Ad.offsets), dt=0.025, F=F[:, 1:], G=G[:, 1:], u0=G[:, 0],
                free=free12, rtol=1e-12)

    def jax_parabolic(dm):  # JAX's scan reports no iteration counts
        return JPara(Ad, Md, 0.025, dm).solve(F[:, 1:], G[:, 1:], G[:, 0], free12, rtol=1e-12), None

    # P2 after RCM: the permutation, native and NumPy, equal to JAX's
    space2, A2, b2, free2 = system(16, 2)
    n2 = space2.n_dofs
    rows, cols = np.asarray(A2.rows), np.asarray(A2.cols)
    perm, inv = treorder.rcm_permutation(rows, cols, n2)
    pj, ij = jreorder.rcm_permutation(rows, cols, n2)
    np.testing.assert_array_equal(perm, pj)
    indptr, adj = treorder._adjacency_csr(rows, cols, n2)
    np.testing.assert_array_equal(treorder._rcm_native(indptr, adj, n2), perm)
    orig = treorder._rcm_native
    try:
        treorder._rcm_native = lambda *a: None
        np.testing.assert_array_equal(treorder.rcm_permutation(rows, cols, n2)[0], perm)
    finally:
        treorder._rcm_native = orig
    offs_raw, offs = jdia.unique_offsets(space2.dofs), jdia.unique_offsets(inv[space2.dofs])
    assert max(abs(o) for o in offs) < max(abs(o) for o in offs_raw) // 4
    rp, cp, vp = treorder.permute_system(perm, inv, rows, cols, np.asarray(A2.vals))
    D2 = jdia.dia_from_coo(jnp.asarray(rp), jnp.asarray(cp), jnp.asarray(vp), n2, offs)
    cases += [("HaloDIAParabolic", para, jax_parabolic, 1e-12, 1),
              dia_case("RCM P2 HaloDIASolver", D2, b2[perm], free2[perm], 1e-12)]
    got, _ = check_against_jax(tmp_path / "halo_dia", cases)
    assert got[1]["N"]["k"].shape == (8,) and (got[1]["N"]["k"] > 0).all()
