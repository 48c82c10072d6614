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


def _write_r_csv(path, table, header):
    """An R-style CSV: quoted header with an empty first field, row names."""
    with open(path, "w") as fh:
        fh.write(",".join(['""'] + [f'"{h}"' for h in header]) + "\n")
        for i, row in enumerate(table):
            fh.write(",".join([f'"{i + 1}"'] + [repr(float(v)) if not np.isnan(v) else "NA"
                                                for v in row]) + "\n")


def _check_io_and_checkpoints_match_jax(tmp_path):
    """utils.io on files written here (JAX's tests/test_utils.py:99 reads
    the absent reference data): load_mesh_csv, read_csv with NA, the
    1-indexed COO read_csv_sparse (rows, cols equal, vals to 1e-15, into a
    SparseMatrix on the CPU) and read_mtx, equal to JAX's. utils.checkpoint
    in both directions (tests/test_aux.py:66, tests/test_amg.py:139): a P2
    space saved by JAX loads into the port with equal dofs and scatter
    tables, its segment_sum tables equal to a fresh build's and
    assemble_matrix on it equal to the fresh space's bitwise, and the
    port's save loads into JAX alike; an SA-AMG hierarchy saved by JAX
    gives the port's V-cycle of the same matrices to 1e-14 relative, the
    port's save gives JAX's to 1e-14, and the port's own round trip repeats
    its V-cycle bitwise and drives CG to convergence."""
    import pytest
    from scipy.io import mmwrite
    from scipy.sparse import random as sprandom

    from fdapde_core_tpu.fem import assembler as ja
    from fdapde_core_tpu.fem.solvers import masked_matrix as j_masked
    from fdapde_core_tpu.fem.space import FEMSpace as JSpace
    from fdapde_core_tpu.linear_algebra.amg import AMG as JAMG
    from fdapde_core_tpu.utils import checkpoint as jck
    from fdapde_core_tpu.utils import io as jio
    from fdapde_core_tpu_torch.fem import assembler as ta
    from fdapde_core_tpu_torch.fem.solvers import masked_matrix
    from fdapde_core_tpu_torch.fem.space import FEMSpace
    from fdapde_core_tpu_torch.linear_algebra import AMG, cg
    from fdapde_core_tpu_torch.utils import checkpoint as tck
    from fdapde_core_tpu_torch.utils import io as tio

    rng = np.random.default_rng(31)
    mesh = unit_square_mesh(8)
    mdir = tmp_path / "mesh"
    mdir.mkdir()
    _write_r_csv(mdir / "points.csv", mesh.nodes, ["x", "y"])
    _write_r_csv(mdir / "elements.csv", mesh.cells + 1.0, ["V1", "V2", "V3"])
    _write_r_csv(mdir / "boundary.csv", mesh.boundary_node_markers()[:, None] * 1.0, ["b"])
    for a, b in zip(tio.load_mesh_csv(str(mdir)), jio.load_mesh_csv(str(mdir))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tio.load_mesh_csv(str(mdir))[1], mesh.cells)
    table = rng.standard_normal((5, 3))
    table[2, 1] = np.nan
    _write_r_csv(tmp_path / "na.csv", table, ["a", "b", "c"])
    np.testing.assert_array_equal(tio.read_csv(str(tmp_path / "na.csv")), table)
    S = sprandom(40, 30, density=0.1, random_state=3, format="coo")
    trip = np.column_stack([S.row + 1.0, S.col + 1.0, S.data])
    trip = np.concatenate([trip, trip[:5]])  # duplicates are summed
    _write_r_csv(tmp_path / "coo.csv", trip, ["i", "j", "x"])
    Mj = jio.read_csv_sparse(str(tmp_path / "coo.csv"), shape=(40, 30))
    Mt = tio.read_csv_sparse(str(tmp_path / "coo.csv"), shape=(40, 30), device=CPU)
    np.testing.assert_array_equal(_np(Mt.rows), np.asarray(Mj.rows))
    np.testing.assert_array_equal(_np(Mt.cols), np.asarray(Mj.cols))
    assert np.abs(_np(Mt.vals) - np.asarray(Mj.vals)).max() <= 1e-15
    assert Mt.vals.device.type == CPU
    assert (tio.read_csv_sparse(str(tmp_path / "coo.csv"), device=CPU).shape
            == jio.read_csv_sparse(str(tmp_path / "coo.csv")).shape)
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises((AssertionError, RuntimeError)):
            tio.read_csv_sparse(str(tmp_path / "coo.csv"))
    mmwrite(str(tmp_path / "m.mtx"), S)
    np.testing.assert_array_equal(tio.read_mtx(str(tmp_path / "m.mtx")), S.toarray())
    np.testing.assert_array_equal(tio.read_mtx(str(tmp_path / "m.mtx")),
                                  jio.read_mtx(str(tmp_path / "m.mtx")))

    tck.save_arrays(str(tmp_path / "a.npz"), t=torch.arange(4.0), a=np.eye(2))
    got = jck.load_arrays(str(tmp_path / "a.npz"))
    np.testing.assert_array_equal(got["t"], np.arange(4.0))
    np.testing.assert_array_equal(tck.load_arrays(str(tmp_path / "a.npz"))["a"], np.eye(2))
    sj, st = JSpace(j_unit_square(8), 2), FEMSpace(mesh, 2)
    jck.save_space(str(tmp_path / "sj.npz"), sj)
    tck.save_space(str(tmp_path / "st.npz"), st)
    for loaded, ref in ((tck.load_space(str(tmp_path / "sj.npz")), st),
                        (jck.load_space(str(tmp_path / "st.npz")), sj)):
        assert loaded.n_dofs == ref.n_dofs
        np.testing.assert_array_equal(loaded.dofs, ref.dofs)
        for a, b in zip(loaded.scatter, ref.scatter):
            np.testing.assert_array_equal(a, b)
    loaded = tck.load_space(str(tmp_path / "sj.npz"))
    fresh = FEMSpace(unit_square_mesh(8), 2)
    for which in ("matrix", "forcing"):
        assert torch.equal(loaded.segment_sum(which, CPU).table, fresh.segment_sum(which, CPU).table)
    A_l = ta.assemble_matrix(loaded, -fdt.laplacian(), device=CPU)
    A_f = ta.assemble_matrix(fresh, -fdt.laplacian(), device=CPU)
    assert torch.equal(A_l.rows, A_f.rows) and torch.equal(A_l.vals, A_f.vals)

    us = unit_square_mesh(24)
    mask = us.boundary_node_markers()
    Lt = masked_matrix(ta.assemble_matrix(FEMSpace(us, 1), -fdt.laplacian(), device=CPU),
                       torch.from_numpy(mask))
    Lj = j_masked(ja.assemble_matrix(JSpace(j_unit_square(24), 1), -fdm.laplacian()),
                  jnp.asarray(mask))
    r = rng.standard_normal(Lt.shape[0])
    mgj, mgt = JAMG.build(Lj, coarse_max=40), AMG.build(Lt, coarse_max=40)
    jck.save_amg(str(tmp_path / "hj.npz"), mgj)
    tck.save_amg(str(tmp_path / "ht.npz"), mgt)
    for ours, theirs in ((tck.load_amg(str(tmp_path / "hj.npz"), device=CPU), mgj),
                         (mgt, jck.load_amg(str(tmp_path / "ht.npz")))):
        assert ours.n_levels == theirs.n_levels >= 3
        zj = np.asarray(theirs.v_cycle(jnp.asarray(r)))
        assert _rel(ours.v_cycle(torch.from_numpy(r)), zj) <= 1e-14
    mg2 = tck.load_amg(str(tmp_path / "ht.npz"), device=CPU)
    assert all(torch.equal(a.vals, b.vals) for a, b in zip(mg2.Rs, mgt.Rs))
    assert torch.equal(mg2.v_cycle(torch.from_numpy(r)), mgt.v_cycle(torch.from_numpy(r)))
    b = torch.from_numpy(np.where(mask, 0.0, 1.0 / Lt.shape[0]))
    _, info = cg(Lt, b, M_inv=mg2.v_cycle, rtol=1e-10, maxiter=60)
    assert info.converged


def _check_utils_match_jax(tmp_path):
    """The remaining utils against JAX's on the same calls: binary_tree
    (tests/test_aux.py:31), block_frame and shp_reader
    (tests/test_utils_structures.py:11,29,72,163,196,222,387), equal
    outputs; sanitize (tests/test_sanitize.py:12-46): checked raises on a
    NaN made in an intermediate and masked in the output (in a loop, and
    entering through a SparseMatrix product), as JAX's does, and passes
    clean code; debug_nans raises in its scope only; assert_all_finite
    names the leaf; profiling: timer accumulates, xprof_trace writes a
    trace of the block; the public names of
    JAX's utils, fem, pde and geometry on the port, their constants and
    helpers equal (tests/test_utils.py:107; log1pexp to 1e-12), and the
    getattr diff over the JAX package (parallel included) finds nothing
    missing. With io and checkpoints (``_check_io_and_checkpoints_match_jax``)
    and WindowedELL (``_check_windowed_ell_matches_jax``)."""
    import importlib
    import json
    import struct
    import types

    import jax
    import pytest

    import fdapde_core_tpu.utils as ju
    import fdapde_core_tpu_torch.utils as tu
    from fdapde_core_tpu.utils import binary_tree as jbt
    from fdapde_core_tpu.utils import block_frame as jbf
    from fdapde_core_tpu.utils import sanitize as jsan
    from fdapde_core_tpu.utils import shp_reader as jshp
    from fdapde_core_tpu_torch.utils import binary_tree as tbt
    from fdapde_core_tpu_torch.utils import block_frame as tbf
    from fdapde_core_tpu_torch.utils import profiling as tprof
    from fdapde_core_tpu_torch.utils import sanitize as tsan
    from fdapde_core_tpu_torch.utils import shp_reader as tshp

    _check_io_and_checkpoints_match_jax(tmp_path)
    _check_windowed_ell_matches_jax()

    def structures(bt, bf, shp):
        t = bt.BinaryTree()
        root = t.set_root("a")
        left = t.push_left(root, "b")
        t.push_right(root, "c")
        t.push_left(left, "d")
        bst = bt.BST()
        for v in [5, 2, 8, 1, 3, 9, 4]:
            bst.insert(v)
        out = [list(t.dfs()), list(t.bfs()), sorted(t.leaves()), bst.sorted(), bst.contains(3),
               bst.contains(7)]
        frame = bf.BlockFrame()
        frame.insert("y", np.arange(6.0))
        frame["X"] = np.arange(12.0).reshape(6, 2)
        frame.clear_dirty()
        view = frame.range(1, 4)
        view["y"] = np.zeros((3, 1))
        sparse = frame.sparse_view([0, 5])
        sparse["X"] = -np.ones((2, 2))
        bv = bf.BlockVector(np.arange(12.0), 3)
        bv[0] = [9, 9, 9]
        out += [frame.columns(), frame.is_dirty("y"), frame["y"].tolist(), frame["X"].tolist(),
                view.n_rows, frame.row(2).materialize().columns(), frame.rows(slice(1, 3)).n_rows,
                bv[2].tolist(), bv.blocks(0, 2).tolist()]
        xy, z, m = [(0.0, 0.0), (1.0, 1.0), (2.0, 0.5)], [7.0, 8.0, 9.0], [0.1, 0.2, 0.3]
        content = struct.pack("<i4d2ii", 13, 0, 0, 2, 1, 1, 3, 0)
        content += b"".join(struct.pack("<2d", *p) for p in xy)
        content += struct.pack("<5d", min(z), max(z), *z) + struct.pack("<5d", min(m), max(m), *m)
        body = struct.pack(">2i", 1, len(content) // 2) + content
        header = struct.pack(">i5ii", 9994, 0, 0, 0, 0, 0, (100 + len(body)) // 2)
        header += struct.pack("<2i8d", 1000, 13, 0, 0, 10, 10, 0, 0, 0, 0)
        base = tmp_path / f"plz_{bt.__name__.split('.')[0]}"
        base.with_suffix(".shp").write_bytes(header + body)
        rec = shp.ShapeFile(str(base) + ".shp")
        r0 = rec.records[0]
        out += [rec.shape_type_name, len(rec), r0.points.tolist(), r0.z.tolist(), r0.m.tolist(),
                r0.z_range, r0.rings()]
        return out

    assert structures(tbt, tbf, tshp) == structures(jbt, jbf, jshp)

    def masked_loop(m, x):
        for _ in range(2):
            y = m.sqrt(x - 2.0)  # NaN in an intermediate
            x = m.where(y == y, y, 1.0)  # masked in the output
        return x

    with pytest.raises(Exception, match="nan"):
        jsan.checked(jax.jit(lambda x: masked_loop(jnp, x)))(jnp.float64(1.0))
    one = torch.tensor(1.0, dtype=torch.float64)
    assert float(masked_loop(torch, one)) == 1.0  # the output alone is finite
    with pytest.raises(FloatingPointError, match="nan in the output of aten.sqrt"):
        tsan.checked(lambda x: masked_loop(torch, x))(one)
    assert float(tsan.checked(lambda x: torch.sqrt(x) + 1.0)(4 * one)) == 3.0
    A = SparseMatrix.from_dense(np.array([[1.0, 3.0], [0.0, 2.0]]), device=CPU)
    A = A.with_vals(torch.tensor([1.0, float("nan"), 2.0], dtype=torch.float64))
    with pytest.raises(FloatingPointError, match="nan"):
        tsan.checked(lambda v: torch.nan_to_num(A @ v))(torch.ones(2, dtype=torch.float64))
    with tsan.debug_nans():
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(-one)
    assert torch.isnan(torch.log(-one))
    tsan.assert_all_finite({"a": torch.ones(3), "b": np.arange(3), "c": [np.ones(2)]})
    with pytest.raises(FloatingPointError, match="'a'"):
        tsan.assert_all_finite({"a": torch.tensor([1.0, float("nan")])}, "state")
    with pytest.raises(FloatingPointError, match=r"\[1\]"):
        tsan.assert_all_finite([np.ones(2), np.array([np.inf])])

    store = {}
    for _ in range(2):
        with tprof.timer("block", store, sync=[torch.ones(2), {"x": one}]):
            torch.ones(100).sum()
    assert set(store) == {"block"} and store["block"] > 0
    with tprof.xprof_trace(str(tmp_path / "trace")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::mm" in names

    for name in ("DOUBLE_TOLERANCE", "MACHINE_EPSILON"):
        assert getattr(tu, name) == getattr(ju, name), name
    assert [tu.binomial(7, k) for k in range(8)] == [ju.binomial(7, k) for k in range(8)]
    assert tu.factorial(9) == ju.factorial(9)
    np.testing.assert_array_equal(tu.combinations(2, 4), ju.combinations(2, 4))
    for a, b in zip(tu.gauss_legendre_1d(4), ju.gauss_legendre_1d(4)):
        np.testing.assert_array_equal(a, b)
    for q_t, q_j in ((tu.simplex_quadrature(2, 6), ju.simplex_quadrature(2, 6)),
                     (tu.standard_fem_quadrature(3, 2), ju.standard_fem_quadrature(3, 2))):
        assert isinstance(q_t, tu.SimplexQuadrature)
        np.testing.assert_array_equal(q_t.nodes, q_j.nodes)
        np.testing.assert_array_equal(q_t.weights, q_j.weights)
    for a, b in ((1.0, 1.0 + 1e-15), (1.0, 1.0 + 1e-10), (1e10, 1e10 * (1 + 1e-15)),
                 (np.ones(3), np.ones(3) + 1e-15), (torch.ones(3), np.ones(3) + 1e-10)):
        assert tu.almost_equal(a, b) == ju.almost_equal(_np(a), b)
    xs = np.array([-100.0, -37.5, -5.0, 0.0, 10.0, 20.0, 33.0, 40.0, 700.0, 1e6])
    got = tu.log1pexp(torch.from_numpy(xs))
    assert np.isfinite(_np(got)).all() and _rel(got, ju.log1pexp(jnp.asarray(xs))) <= 1e-12
    if not torch.cuda.is_available():  # host input goes to the card: no fallback
        with pytest.raises((AssertionError, RuntimeError)):
            tu.log1pexp(xs)
    import fdapde_core_tpu.fem as jfem
    from fdapde_core_tpu_torch import fem as tfem

    for M, R in ((1, 2), (2, 3), (3, 2)):
        np.testing.assert_array_equal(tfem.reference_nodes(M, R), jfem.reference_nodes(M, R))
        assert tfem.LagrangeBasis(M, R).n_basis == jfem.LagrangeBasis(M, R).n_basis
        for a, b in zip(tfem.tabulate_basis(M, R)[1:], jfem.tabulate_basis(M, R)[1:]):
            np.testing.assert_array_equal(a, b)
    for name, make in (("Laplacian", lambda m: m.laplacian()), ("Diffusion", lambda m: m.diffusion(1.0)),
                       ("Advection", lambda m: m.advection(np.ones(2))),
                       ("Reaction", lambda m: m.reaction(1.0)), ("Dt", lambda m: m.dt()),
                       ("BiLaplacian", lambda m: m.bilaplacian())):
        (_, leaf_t), = make(fdt).terms
        (_, leaf_j), = make(fdm).terms
        assert type(leaf_t) is getattr(fdt.pde, name) and type(leaf_j) is getattr(fdm.pde, name)
        assert leaf_t.is_symmetric == leaf_j.is_symmetric, name

    import fdapde_core_tpu as jtop

    def public(mod):
        return getattr(mod, "__all__", None) or [n for n in dir(mod) if not n.startswith("_")]

    missing = {n for n in public(jtop) if not hasattr(fdt, n)}
    for sub in ("fem", "fields", "geometry", "linear_algebra", "models", "native", "ops",
                "optimization", "parallel", "pde", "splines", "utils"):
        jm, tm = importlib.import_module(f"fdapde_core_tpu.{sub}"), getattr(fdt, sub)
        for n in public(jm):
            attr = getattr(jm, n)
            if isinstance(attr, types.ModuleType) and not attr.__name__.startswith("fdapde_core_tpu."):
                continue  # a third-party module the JAX package imported
            if not hasattr(tm, n):
                missing.add(f"{sub}.{n}")
    assert not missing, sorted(missing)


def _check_windowed_ell_matches_jax():
    """WindowedELL against JAX's on tests/test_window_spmv.py's scattered
    SPD ELL (n = 700, K = 7, band 97; n = 300, band 40; n = 900, band 120):
    the product equal to ELLSoA @ x bitwise and to JAX's WindowedELL to
    1e-13 relative, the diagonal equal, the same 128-aligned halo B and
    block layout, window_bandwidth equal; a Dirichlet CG through it to the
    dense solution (1e-8); astype(float32) against the f32 ELL to 1e-6;
    plan_split_width rejects the band in both packages."""
    from test_window_spmv import _scattered_spd_ell
    from fdapde_core_tpu.ops.dia_split import plan_split_width as j_plan
    from fdapde_core_tpu.ops.window_spmv import WindowedELL as JWindowed
    from fdapde_core_tpu.ops.window_spmv import window_bandwidth as j_window_bandwidth
    from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
    from fdapde_core_tpu_torch.interop import ell_from_numpy
    from fdapde_core_tpu_torch.linear_algebra.solvers import cg_chunked
    from fdapde_core_tpu_torch.ops import WindowedELL, window_bandwidth
    from fdapde_core_tpu_torch.ops.dia_split import plan_split_width

    rng = np.random.default_rng(0)
    for n, band, rows in ((700, 97, 128), (300, 40, 64), (900, 120, 128)):
        Ej, A = _scattered_spd_ell(n, B=band)
        E = ell_from_numpy(np.asarray(Ej.vals), np.asarray(Ej.cols), (n, n), device="cpu")
        W, Wj = WindowedELL.from_ell(E, block_rows=rows), JWindowed.from_ell(Ej, block_rows=rows)
        assert (W.B, W.R, W.nb) == (Wj.B, Wj.R, Wj.nb) and W.B % 128 == 0
        assert int(window_bandwidth(E.cols)) == int(j_window_bandwidth(Ej.cols)) <= band
        np.testing.assert_array_equal(W.idx.numpy(), np.asarray(Wj.idx))
        v = rng.standard_normal(n)
        assert torch.equal(W @ torch.from_numpy(v), E @ torch.from_numpy(v)), n
        assert _rel(W @ torch.from_numpy(v), Wj @ jnp.asarray(v)) <= 1e-13
        assert torch.equal(W.diagonal(), E.diagonal())
        if band == 120:  # the scattered histogram the split plan rejects, in both packages
            assert plan_split_width(E)[0] is None and j_plan(Ej)[0] is None
    W32 = W.astype(torch.float32)
    ones = torch.ones(n, dtype=torch.float32)
    np.testing.assert_allclose((W32 @ ones).numpy(), (E.astype(torch.float32) @ ones).numpy(),
                               rtol=1e-6)
    # a Dirichlet CG through the windowed operator (n = 700)
    Ej, A = _scattered_spd_ell(700)
    W = WindowedELL.from_ell(ell_from_numpy(np.asarray(Ej.vals), np.asarray(Ej.cols), (700, 700),
                                            device="cpu"), block_rows=128)
    bnd = torch.zeros(700, dtype=torch.bool)
    bnd[[0, 699]] = True
    sys_w = DirichletSystem(W, bnd)
    x, info = cg_chunked(sys_w, torch.where(bnd, 0.0, 1.0).double(), rtol=1e-12, maxiter=900,
                         chunk=100)
    free = ~bnd.numpy()
    xs = np.zeros(700)
    xs[free] = np.linalg.solve(A[np.ix_(free, free)], np.ones(free.sum()))
    np.testing.assert_allclose(x.numpy(), xs, rtol=1e-8, atol=1e-9)


def test_regression_path_matches_jax(tmp_path):
    """Point location, Psi, SmoothingRegression (fit, predict, exact and
    Hutchinson GCV, select_lambda_gcv), a fitted JAX model carried across,
    SMW / dense_solve, the K2 block route, and the B-spline space,
    assembly and PDE, each against the JAX package; the utils: io,
    checkpoints both ways, the host structures, sanitize, profiling and
    the public names (``_check_utils_match_jax``)."""
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
    _check_utils_match_jax(tmp_path)


def test_space_time_matches_jax(tmp_path):
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
    _check_sharded_space_time_matches_jax(tmp_path)


def _check_sharded_space_time_matches_jax(tmp_path):
    """The time-sharded Kronecker CG and the mode-parallel FDM on 4 gloo CPU
    ranks against JAX's on 4 virtual devices
    (``torch_sharded.check_against_jax``: solutions within max(rtol, 1e-12)
    max|x|, iterations equal within 1): ShardedSpaceTime over
    unit_square_mesh(5) x 19 instants at 1e-12, H = 1
    (tests/test_parallel.py:392); solve_space_time_fdm(device_mesh=) on
    unit_square_mesh(8) x 11 instants at 1e-8 (__graft_entry__.py:288)."""
    from fdapde_core_tpu.fem import assembler as ja
    from fdapde_core_tpu.fem.solvers import masked_matrix as j_masked
    from fdapde_core_tpu.fem.space import FEMSpace as JSpace
    from fdapde_core_tpu.parallel.space_time import ShardedSpaceTime as JShardedST
    from torch_sharded import check_against_jax

    def sparse(S):
        return (np.asarray(S.rows), np.asarray(S.cols), np.asarray(S.vals), S.shape)

    def time_factors(n_t):
        stiff = np.diag(2.0 * np.ones(n_t)) - np.diag(np.ones(n_t - 1), 1) - np.diag(
            np.ones(n_t - 1), -1)
        mass = (np.diag(4.0 * np.ones(n_t)) + np.diag(np.ones(n_t - 1), 1)
                + np.diag(np.ones(n_t - 1), -1)) / 6.0
        return mass, stiff

    space5 = JSpace(j_unit_square(5), 1)
    S_stiff = ja.assemble_matrix(space5, -fdm.laplacian())
    S_mass = ja.assemble_matrix(space5, fdm.reaction(1.0))
    T_mass, T_stiff = time_factors(19)
    terms = [(T_mass, S_stiff), (T_stiff, S_mass)]
    b = np.random.default_rng(11).normal(size=19 * space5.n_dofs)

    def jax_st(dm):
        solver = JShardedST(terms, dm)
        assert solver.H == 1
        x, _, k = solver.solve(jnp.asarray(b), rtol=1e-12)
        return x, k

    space8 = JSpace(j_unit_square(8), 1)
    A8 = ja.assemble_matrix(space8, -fdm.laplacian())
    M8 = ja.assemble_matrix(space8, fdm.reaction(1.0))
    S1m = j_masked(A8, jnp.asarray(space8.boundary_dofs))
    T0, T1 = time_factors(11)
    bst = np.ones(11 * space8.n_dofs)

    def jax_fdm(dm):
        x, info = jst.solve_space_time_fdm(T0, T1, M8, S1m, bst, rtol=1e-8, device_mesh=dm)
        return x, int(info.iterations)

    cases = [("ShardedSpaceTime", dict(kind="space_time", terms=[(T, sparse(S)) for T, S in terms],
                                       b=b, rtol=1e-12, maxiter=20000), jax_st, 1e-12, 1),
             ("FDM mode-parallel", dict(kind="fdm", T0=T0, T1=T1, S0=sparse(M8), S1=sparse(S1m),
                                        b=bst, rtol=1e-8), jax_fdm, 1e-8, 1)]
    check_against_jax(tmp_path / "space_time", cases)
