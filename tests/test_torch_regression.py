"""Port parity: the data-fitting path of fdapde_core_tpu_torch (point
location -> basis evaluation -> SmoothingRegression fit/predict/GCV; the
B-spline space and assembly; SpaceTimeSmoothing on the Kronecker operator)
against the JAX package, on the same numpy inputs made from a seed, in
float64 on the CPU.

Tolerances (relative unless stated):
- located cell ids: exactly equal (host and device form, both packages);
- Psi, pointwise and areal: 1e-14 absolute;
- SmoothingRegression coefficients: 1e-8, CG iterations equal or +-1;
- exact GCV: 1e-10; Hutchinson GCV with equal seeds: 1e-6;
- spline mass, bilaplacian and forcing: 1e-12; spline PDE solve: 1e-10;
- SpaceTimeSmoothing coefficients 1e-7, predictions 1e-8;
- SparseMatrix block products (K2's sliced form, the block read in place)
  against the plain gather-sum and JAX's SparseMatrix @: 1e-14, each
  column equal to the vector product of that column bitwise;
- ModeMGPreconditioner against JAX's: level data 1e-14, apply 1e-12;
  against per-mode V-cycles: 1e-7 (see the test).
On the CPU every K2 launch takes its plain version (ops/gather_spmv).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import torch

import fdapde_core_tpu as fdm
import fdapde_core_tpu_torch as fdt
from fdapde_core_tpu.fem.evaluation import eval_basis_areal as j_areal
from fdapde_core_tpu.fem.evaluation import eval_basis_pointwise as j_pointwise
from fdapde_core_tpu.geometry import Interval as JInterval
from fdapde_core_tpu.geometry.point_location import CellLocator as JLocator
from fdapde_core_tpu.geometry.structured import unit_square_mesh as j_unit_square
from fdapde_core_tpu.models import SmoothingRegression as JRegression
from fdapde_core_tpu.models import SpaceTimeSmoothing as JSpaceTime
from fdapde_core_tpu.models import space_time as jst
from fdapde_core_tpu.splines import assembler as jspl
from fdapde_core_tpu.splines.space import SplineSpace as JSplineSpace
from fdapde_core_tpu_torch.fem.evaluation import eval_basis_areal, eval_basis_pointwise
from fdapde_core_tpu_torch.geometry import Interval, unit_square_mesh
from fdapde_core_tpu_torch.geometry.point_location import CellLocator, DeviceCellLocator
from fdapde_core_tpu_torch.interop import (
    smoothing_regression_from_numpy,
    space_time_smoothing_from_numpy,
)
from fdapde_core_tpu_torch.linear_algebra import dense_solve, kron, smw_solve
from fdapde_core_tpu_torch.linear_algebra.sparse import SparseMatrix
from fdapde_core_tpu_torch.models import SmoothingRegression, SpaceTimeSmoothing
from fdapde_core_tpu_torch.models import space_time as tst
from fdapde_core_tpu_torch.splines import assembler as tspl
from fdapde_core_tpu_torch.splines.space import SplineSpace

CPU = "cpu"
PI = np.pi


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _truth(p):
    return np.sin(2 * PI * p[..., 0]) * np.cos(2 * PI * p[..., 1])


def _psi_equal(Pt, Pj, where):
    dense_t, dense_j = Pt.toarray(), np.asarray(Pj.toarray())
    assert dense_t.shape == dense_j.shape, where
    assert np.abs(dense_t - dense_j).max() <= 1e-14, where


def test_regression_path_matches_jax():
    """Point location, Psi, SmoothingRegression (fit, predict, exact and
    Hutchinson GCV, select_lambda_gcv), a fitted JAX model carried across,
    SMW / dense_solve, the K2 block route, and the B-spline space,
    assembly and PDE, each against the JAX package."""
    rng = np.random.default_rng(0)
    n_obs = 600
    mj, mt = j_unit_square(16), unit_square_mesh(16)
    locs = rng.uniform(-0.05, 1.05, size=(n_obs, 2))  # some outside the domain
    locs[:20] = mt.nodes[rng.choice(mt.n_nodes, 20)]  # vertices: shared by several cells

    # point location: host and device forms of both packages
    ids_j = JLocator(mj).locate(locs)
    assert np.array_equal(CellLocator(mt).locate(locs), ids_j)
    import fdapde_core_tpu_torch.geometry.point_location as tpl

    saved, tpl._BATCH = tpl._BATCH, 128  # several batches
    try:
        assert np.array_equal(_np(DeviceCellLocator(mt, device=CPU).locate(locs)), ids_j)
    finally:
        tpl._BATCH = saved
    assert np.array_equal(mt.locate(locs), ids_j) and (ids_j < 0).any()
    assert np.array_equal(_np(mt.locate_device(torch.from_numpy(locs))), ids_j)
    t = rng.uniform(-0.1, 1.1, size=50)
    assert np.array_equal(Interval(0, 1, 6).locate(t), JInterval(0, 1, 6).locate(t))

    # Psi, pointwise (host and device location) and areal
    sj, st = fdm.fem.FEMSpace(mj, 1), fdt.FEMSpace(mt, 1)
    Pj, _ = j_pointwise(sj, locs)
    for dev_loc in (False, True):
        Pt, D = eval_basis_pointwise(st, locs, device_locate=dev_loc, device=CPU)
        _psi_equal(Pt, Pj, f"pointwise device_locate={dev_loc}")
        assert np.array_equal(_np(Pt.rows), np.asarray(Pj.rows))
        assert np.array_equal(_np(Pt.cols), np.asarray(Pj.cols))
    incidence = (rng.uniform(size=(7, mt.n_cells)) < 0.2).astype(np.int64)
    (Aj, Dj), (At, Dt) = j_areal(sj, incidence), eval_basis_areal(st, incidence, device=CPU)
    _psi_equal(At, Aj, "areal")
    np.testing.assert_allclose(Dt, Dj, rtol=1e-14)

    # the block route (K2's sliced form, the block read in place) against
    # the plain gather-sum, on a row-major block and on a transposed view
    X = torch.from_numpy(rng.standard_normal((Pt.shape[1], 5)))
    for blk in (X, X.T.contiguous().T):
        got = Pt @ blk
        assert np.abs(_np(got) - _np(Pt.matmul_reference(blk))).max() <= 1e-14
        assert torch.equal(got[:, 2], Pt @ blk[:, 2].contiguous())  # column == vector product

    # SmoothingRegression: fit, predict, GCV
    y = _truth(locs) + 0.1 * rng.normal(size=n_obs)
    jm = JRegression(mj, -fdm.laplacian(), order=1)
    tm = SmoothingRegression(mt, -fdt.laplacian(), order=1, device=CPU)
    cj, ct = np.asarray(jm.fit(locs, y, 1.0)), tm.fit(locs, y, 1.0)
    assert _rel(ct, cj) <= 1e-8
    assert abs(tm.solve_info_.iterations - int(jm.solve_info_.iterations)) <= 1
    assert tm.solve_info_.converged
    grid = rng.uniform(0.1, 0.9, size=(100, 2))
    assert _rel(tm.predict(grid), jm.predict(grid)) <= 1e-8
    assert abs(tm.gcv(locs, y, 0.5, exact=True) / jm.gcv(locs, y, 0.5, exact=True) - 1) <= 1e-10
    lambdas = [1e-2, 1e4]
    bj, sc_j = jm.select_lambda_gcv(locs, y, lambdas, n_probes=4)
    bt, sc_t = tm.select_lambda_gcv(locs, y, lambdas, n_probes=4)  # Hutchinson, seed 0
    assert bt == bj and np.allclose(sc_t, sc_j, rtol=1e-6, atol=0)
    carried = smoothing_regression_from_numpy(mt, -fdt.laplacian(), np.asarray(jm.coefficients_),
                                              device=CPU)
    assert _rel(carried.predict(grid), jm.predict(grid)) <= 1e-12

    # SMW and dense_solve (smw.h contract) on the normal matrix
    A = torch.from_numpy(tm.P.toarray() + np.eye(mt.n_nodes))
    U = torch.from_numpy(rng.standard_normal((mt.n_nodes, 3)))
    V = torch.from_numpy(rng.standard_normal((3, mt.n_nodes)))
    invC = torch.eye(3, dtype=torch.float64) * 2.0
    b = torch.from_numpy(rng.standard_normal(mt.n_nodes))
    x = smw_solve(lambda r: dense_solve(A, r), U, invC, V, b)
    assert _rel(x, np.linalg.solve(_np(A) + _np(U) @ np.linalg.inv(_np(invC)) @ _np(V), _np(b))) <= 1e-10

    # B-splines: mass, bilaplacian, forcing, evaluation and a spline PDE
    spj, spt = JSplineSpace(JInterval(0, 2, 10), 3), SplineSpace(Interval(0, 2, 10), 3)
    for name, got, ref in (
        ("mass", tspl.assemble_mass(spt, device=CPU), jspl.assemble_mass(spj)),
        ("bilaplacian", tspl.assemble_operator(spt, -fdt.bilaplacian(), device=CPU),
         jspl.assemble_operator(spj, -fdm.bilaplacian())),
    ):
        assert _rel(got.toarray(), np.asarray(ref.toarray())) <= 1e-12, name
    f = lambda p: np.sin(p[0])  # noqa: E731
    assert _rel(tspl.assemble_forcing(spt, f, device=CPU), jspl.assemble_forcing(spj, f)) <= 1e-12
    ts = np.linspace(0, 2, 9)
    _psi_equal(spt.eval(ts, device=CPU)[0], spj.eval(ts)[0], "spline pointwise")
    sols = []
    for mod, kw in ((fdm, {}), (fdt, {"device": CPU})):
        pde = mod.PDE(mod.Interval(0.0, 1.0, 16), mod.reaction(1.0), order=3,
                      discretization="spline", forcing=lambda p: p[0], **kw)
        pde.init()
        pde.solve()
        Phi, _ = pde.eval_functional_basis(np.linspace(0, 1, 33))
        sols.append(_np(Phi @ pde.solution()))
    np.testing.assert_allclose(sols[1], np.linspace(0, 1, 33), atol=1e-8)
    assert _rel(sols[1], sols[0]) <= 1e-10


def test_space_time_matches_jax():
    """SpaceTimeSmoothing (coefficients, predictions, a fitted JAX model
    carried across), the solve_space_time escalation of
    tests/test_recovery.py on both packages, solve_space_time_fdm against
    the Kronecker CG, ModeMGPreconditioner against JAX's and against
    per-mode V-cycles, kron, and K2's block product on the factors with
    the block as a row-major tensor and as a transposed view."""
    rng = np.random.default_rng(1)
    n_sites, n_times = 60, 8
    locs = rng.uniform(0.05, 0.95, size=(n_sites, 2))
    times = np.linspace(0.0, 1.0, n_times)

    def truth(p, t):
        return np.sin(PI * p[..., 0:1]) * np.sin(PI * p[..., 1:2]) * np.exp(-t[None, :])

    Y = truth(locs, times) + 0.1 * rng.normal(size=(n_sites, n_times))
    jm = JSpaceTime(j_unit_square(8), JInterval(0.0, 1.0, 6))
    tm = SpaceTimeSmoothing(unit_square_mesh(8), Interval(0.0, 1.0, 6), device=CPU)
    cj = np.asarray(jm.fit(locs, times, Y, lam_s=1.0, lam_t=0.1))
    ct = tm.fit(locs, times, Y, lam_s=1.0, lam_t=0.1)
    assert tm.solve_info_.converged and bool(jm.solve_info_.converged)
    assert _rel(ct, cj) <= 1e-7
    grid, t_eval = rng.uniform(0.15, 0.85, size=(20, 2)), np.linspace(0.1, 0.9, 7)
    pj = np.asarray(jm.predict(grid, t_eval))
    assert _rel(tm.predict(grid, t_eval), pj) <= 1e-8
    carried = space_time_smoothing_from_numpy(unit_square_mesh(8), Interval(0.0, 1.0, 6), cj,
                                              device=CPU)
    assert _rel(carried.predict(grid, t_eval), pj) <= 1e-12

    # K2's block product on the factors, each operand read where it lies: a
    # space factor on the transposed view of the (n_t, n_s) iterate, a time
    # factor on the row-major (n_t, n_s) block; every column equals the
    # vector product of that column bitwise, and JAX's SparseMatrix @
    # to 1e-14
    from fdapde_core_tpu.linear_algebra.sparse import SparseMatrix as JSparse

    n_t, n_s = tm.tspace.n_dofs, tm.space.n_dofs
    U = rng.standard_normal((n_t, n_s))
    for name, A, blocks in (
        ("As", tm.As, (torch.from_numpy(U).T, torch.from_numpy(U.T.copy()))),
        ("lam_t Pt", tm.Pt * 0.1, (torch.from_numpy(U), torch.from_numpy(U.T.copy()).T)),
    ):
        jA = JSparse(*(jnp.asarray(_np(a)) for a in (A.rows, A.cols, A.vals)), A.shape)
        for X in blocks:
            Y = A @ X
            assert Y.shape == (A.shape[0], X.shape[1])
            cols = torch.stack([A @ X[:, j].contiguous() for j in range(X.shape[1])], 1)
            assert torch.equal(Y, cols), f"{name}: a block column differs from its vector product"
            assert _rel(Y, jA @ jnp.asarray(_np(X))) <= 1e-14, f"{name}: vs JAX SparseMatrix @"

    # escalation parity (tests/test_recovery.py): Jacobi CG stalls on a
    # time pencil spanning 8 decades, the mode-diagonal retry converges
    rng2 = np.random.default_rng(2)  # the data of test_recovery.py
    nt, ns = 8, 24
    Q, _ = np.linalg.qr(rng2.standard_normal((nt, nt)))
    T1 = Q @ np.diag(np.logspace(0, 8, nt)) @ Q.T
    T0 = np.eye(nt)
    S1 = np.diag(np.full(ns, 2.0)) + np.diag(np.full(ns - 1, -1.0), 1) + np.diag(np.full(ns - 1, -1.0), -1)
    S0 = np.eye(ns) * 0.01
    b = rng2.standard_normal(nt * ns)
    opj = jst.SeparableOperator([(jnp.asarray(T1), jnp.asarray(S0)), (jnp.asarray(T0), jnp.asarray(S1))])
    t_ = torch.from_numpy
    opt = tst.SeparableOperator([(t_(T1), t_(S0)), (t_(T0), t_(S1))])
    _, info_bare = tst.solve_space_time(opt, t_(b), rtol=1e-12, maxiter=60, recovery=False)
    assert not info_bare.converged
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xj, ij = jst.solve_space_time(opj, jnp.asarray(b), rtol=1e-12, maxiter=60)
        xt, it = tst.solve_space_time(opt, t_(b), rtol=1e-12, maxiter=60)
    assert sum("mode-diagonal" in str(w.message) for w in caught) == 2
    assert it.converged and bool(ij.converged) and abs(it.iterations - int(ij.iterations)) <= 1
    dense = np.kron(T1, S0) + np.kron(T0, S1)
    np.testing.assert_allclose(_np(xt), np.linalg.solve(dense, b), atol=1e-7)
    assert _rel(xt, xj) <= 1e-8

    # fast diagonalization on the model's (Mt, lam_t Pt, Ms, lam_s As + Ms)
    # pencil, against the Kronecker CG on the same two-term operator
    S1t = tm.As * 1.0 + tm.Ms
    rhs = t_(rng.standard_normal(tm.tspace.n_dofs * tm.space.n_dofs))
    op2 = tst.SeparableOperator([(tm.Pt * 0.1, tm.Ms), (tm.Mt, S1t)])
    x_cg, info = tst.solve_space_time(op2, rhs, rtol=1e-12, recovery=False)
    x_fdm, info_fdm = tst.solve_space_time_fdm(tm.Mt, tm.Pt * 0.1, tm.Ms, S1t, rhs, rtol=1e-12)
    assert info.converged and info_fdm.converged and _rel(x_fdm, x_cg) <= 1e-8

    # the multigrid mode preconditioner on a grid pencil, against JAX's on
    # the same (T0, T1, S0, S1) carried across: both coarsen the two chains
    # alike and run the same V-cycles, to 1e-12. Then against one port
    # GridMG per mode of S1 + lam_t S0: that coarsens the sum where the
    # preconditioner sums the coarsenings, which round differently, and the
    # 64 fixed coarse CG steps amplify that to ~4e-9: held to 1e-7
    from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix as JGrid
    from fdapde_core_tpu_torch.ops.grid_assembly import stencil_from_coords
    from fdapde_core_tpu_torch.ops.grid_dia import GridDIAMatrix, prune_zero_offsets_grid
    from fdapde_core_tpu_torch.ops.grid_mg import GridMG

    n = 8
    g = (torch.arange(n + 1, dtype=torch.float64) / n).expand(n + 1, n + 1)
    free = torch.ones((n + 1, n + 1), dtype=torch.float64)
    free[[0, -1]] = 0
    free[:, [0, -1]] = 0
    G = prune_zero_offsets_grid(
        stencil_from_coords(g.T.contiguous(), g.contiguous(), n).with_dirichlet_identity(free.reshape(-1)))
    E = GridDIAMatrix(torch.where(G.data != 0, 0.01, 0.0), G.offsets2d, G.shape2d)  # S0
    T0m, T1m = T0[:3, :3], T1[:3, :3] * 1e-6
    M = tst.ModeMGPreconditioner.build(T0m, T1m, E, G, dtype=torch.float64, coarse_n=2)
    r = t_(rng.standard_normal(3 * G.n))
    Mj = jst.ModeMGPreconditioner.build(
        T0m, T1m, JGrid(jnp.asarray(_np(E.data)), E.offsets2d, E.shape2d),
        JGrid(jnp.asarray(_np(G.data)), G.offsets2d, G.shape2d), dtype=jnp.float64, coarse_n=2)
    assert M.mg.shapes == tuple(Mj.mg.shapes) == (9, 5, 3) and M.mg.offsets == tuple(Mj.mg.offsets)
    for d_t, d_j in zip(M.mg.datas, Mj.mg.datas):
        assert _rel(d_t, d_j) <= 1e-14
    assert _rel(M(r), Mj(jnp.asarray(_np(r)))) <= 1e-12
    lam, Z = np.linalg.eigh(T1m)  # T0m = I
    W = t_(Z).T @ r.reshape(3, -1)
    ref = torch.stack([GridMG.build(GridDIAMatrix(G.data + lt * E.data, G.offsets2d, G.shape2d),
                                    coarse_n=2).v_cycle(w) for lt, w in zip(lam, W)])
    assert _rel(M(r), (t_(Z) @ ref).reshape(-1)) <= 1e-7

    # kron: sparse x sparse equals the dense product
    K = kron(tm.Mt, tm.Ms)
    assert _rel(K.toarray(), np.kron(tm.Mt.toarray(), tm.Ms.toarray())) <= 1e-14
    assert isinstance(K, SparseMatrix)
