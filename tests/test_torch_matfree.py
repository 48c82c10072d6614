"""Port parity: the general-mesh gather path of fdapde_core_tpu_torch
(SoA pipeline, assembled ELL on the K2 gather SpMV, aux-grid
preconditioner, Krylov solvers, MatrixFreePoisson / MatrixFreeElliptic)
against the JAX package, on the same numpy inputs.

On the CPU the port's K2 wrapper runs its plain torch version and the JAX
LaneRoutedELL its Pallas kernel in interpret mode. The CUDA kernel itself
is held against the plain version by the `cuda`-marked test in
tests/test_torch_assembly.py (skipped without a card).

Mesh coordinates are compared to 2e-13, not to the last bit: the mesh hash
takes frac(sin(t) * 43758.5453), and torch's float64 sin differs from the
one JAX uses by up to one ulp, which the hash amplifies by 43758 before
scaling by amp / n.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdapde_core_tpu  # noqa: F401  (enables x64)
from fdapde_core_tpu.fem.solvers import DirichletSystem as JDirichlet
from fdapde_core_tpu.geometry.structured import irregular_mesh_device as j_mesh
from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa as j_mesh_soa
from fdapde_core_tpu.linear_algebra import solvers as jsol
from fdapde_core_tpu.models.matfree import MatrixFreeElliptic as JElliptic
from fdapde_core_tpu.models.matfree import MatrixFreePoisson as JPoisson
from fdapde_core_tpu.ops import matfree_soa as jms
from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner as JAux
from fdapde_core_tpu.ops.dia_split import plan_split_width as j_plan
from fdapde_core_tpu.ops.pallas_gather_spmv import LaneRoutedELL as JLane
from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
from fdapde_core_tpu_torch.geometry import irregular_mesh_device, irregular_mesh_device_soa
from fdapde_core_tpu_torch.interop import ell_from_numpy
from fdapde_core_tpu_torch.linear_algebra import solvers as tsol
from fdapde_core_tpu_torch.models import (
    MatrixFreeElliptic,
    MatrixFreeParabolic,
    MatrixFreePoisson,
)
from fdapde_core_tpu_torch.ops import gather_spmv as gs
from fdapde_core_tpu_torch.ops import matfree_soa as tms
from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner
from fdapde_core_tpu_torch.ops.dia_split import plan_split_width
from fdapde_core_tpu_torch.ops.gather_spmv import LaneRoutedELL

COORD_TOL = 2e-13


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scramble_ids(nd, S, G):
    """Block-local multiplicative relabelling (the bench's scattered
    numbering): node i becomes p[i]; pinv inverts it."""
    GI = pow(G, -1, S)
    nfull = (nd // S) * S
    i = np.arange(nd)
    p = np.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
    pinv = np.where(i < nfull, (i // S) * S + (GI * (i % S)) % S, i)
    return p, pinv


def _scrambled_mesh(n_side, S, G):
    """numpy (x, y, cells (C, 3) int32, boundary) of the JAX irregular mesh
    with its nodes relabelled by _scramble_ids."""
    x, y, c0, c1, c2, bnd = (np.asarray(a) for a in j_mesh_soa(n_side, 0.2, dtype=jnp.float64))
    p, pinv = _scramble_ids(x.shape[0], S, G)
    cells = p[np.stack([c0, c1, c2], axis=1)].astype(np.int32)
    return x[pinv], y[pinv], cells, bnd[pinv]


def _scrambled_fem_ell(n_side=64, S=256, G=89):
    """The JAX FEM ELL of the irregular mesh, symmetrically permuted into
    the scattered class (as tests/test_pallas_gather_spmv.py builds it)."""
    x, y, c0, c1, c2, bnd = j_mesh_soa(n_side, 0.2, dtype=jnp.float64)
    nd = (n_side + 1) ** 2
    op0, _ = jms.MatrixFreeSoA.build(x, y, c0, c1, c2, nd, 8)
    E, _ = jax.jit(lambda o: o.to_ell(9))(op0)
    p, pinv = _scramble_ids(nd, S, G)
    vals = np.asarray(E.vals)[:, pinv]
    cols = p[np.asarray(E.cols)[:, pinv]].astype(np.int32)
    return vals, cols, nd


def _assert_ell_close(got, ref, name):
    """cols exact, vals to 1e-13 of the largest |val|."""
    np.testing.assert_array_equal(_np(got.cols), np.asarray(ref.cols), err_msg=f"{name}: cols")
    scale = np.abs(np.asarray(ref.vals)).max()
    err = np.abs(_np(got.vals) - np.asarray(ref.vals)).max()
    assert err <= 1e-13 * scale, f"{name}: vals differ by {err:.3e} (scale {scale:.3e})"


def test_soa_pipeline_matches_jax():
    """Meshes (f64: exact topology, coordinates to COORD_TOL), the per-cell
    primitives (1e-12 relative), the incidence table (exact), the
    matrix-free operator's @ and diagonal (1e-12 of scale), its ELL (cols
    exact, vals to 1e-13 of scale), the ELL's @ / diagonal /
    with_added_diagonal (1e-13 of scale) and the band plan (equal)."""
    n = 24
    for name, ref, got in (
        ("soa", j_mesh_soa(n, 0.2, dtype=jnp.float64), irregular_mesh_device_soa(n, 0.2, device="cpu")),
        ("stacked", j_mesh(n, 0.2, dtype=jnp.float64), irregular_mesh_device(n, 0.2, device="cpu")),
    ):
        for k, (r, g) in enumerate(zip(ref, got)):
            r, g = np.asarray(r), _np(g)
            assert r.shape == g.shape, f"mesh {name}[{k}] shape"
            if r.dtype.kind == "f":
                assert np.abs(r - g).max() <= COORD_TOL, f"mesh {name}[{k}] coordinates"
            else:
                np.testing.assert_array_equal(g, r, err_msg=f"mesh {name}[{k}] topology")

    x, y, c0, c1, c2, bnd = (np.asarray(a) for a in j_mesh_soa(n, 0.2, dtype=jnp.float64))
    nd, C = x.shape[0], c0.shape[0]
    rng = np.random.default_rng(11)
    kap = rng.uniform(0.5, 2.0, C)
    coef = dict(kxx=rng.uniform(1.0, 2.0, C), kxy=rng.uniform(-0.2, 0.2, C),
                kyy=rng.uniform(1.0, 2.0, C), bx=rng.uniform(-1, 1, C),
                by=rng.uniform(-1, 1, C), react=rng.uniform(0.1, 1.0, C))
    J = [jnp.asarray(a) for a in (x, y, c0, c1, c2)]
    T = [_t(a) for a in (x, y, c0, c1, c2)]

    ref = jms.p1_offdiag_soa(*J, kappa=jnp.asarray(kap))
    got = tms.p1_offdiag_soa(*T, kappa=_t(kap))
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-12, atol=1e-12,
                                   err_msg=f"p1_offdiag_soa[{k}]")
    ref = jms.p1_general_soa(*J, **{k: jnp.asarray(v) for k, v in coef.items()})
    got = tms.p1_general_soa(*T, **{k: _t(v) for k, v in coef.items()})
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-12, atol=1e-12,
                                   err_msg=f"p1_general_soa[{k}]")

    flat = np.concatenate([c0, c1, c2])
    for r, g, what in zip(jms.build_adjacency_soa(jnp.asarray(flat), nd, 8),
                          tms.build_adjacency_soa(_t(flat), nd, 8),
                          ("adj", "mask", "overflow")):
        np.testing.assert_array_equal(_np(g), np.asarray(r), err_msg=f"adjacency {what}")
    assert bool(tms.build_adjacency_soa(_t(flat), nd, 3)[2]), "degree 3 must overflow"

    v = rng.standard_normal(nd)
    for kind in ("poisson", "general"):
        if kind == "poisson":
            jop, _ = jms.MatrixFreeSoA.build(*J, nd, 8)
            top, _ = tms.MatrixFreeSoA.build(*T, nd, 8)
        else:
            jop, _ = jms.MatrixFreeSoA.build_general(
                *J, nd, 8, **{k: jnp.asarray(a) for k, a in coef.items()})
            top, _ = tms.MatrixFreeSoA.build_general(*T, nd, 8, **{k: _t(a) for k, a in coef.items()})
        y_ref = np.asarray(jop @ jnp.asarray(v))
        scale = np.abs(y_ref).max()
        assert np.abs(_np(top @ _t(v)) - y_ref).max() <= 1e-12 * scale, f"MatrixFreeSoA @ ({kind})"
        d_ref = np.asarray(jop.diagonal())
        assert np.abs(_np(top.diagonal()) - d_ref).max() <= 1e-12 * np.abs(d_ref).max(), \
            f"MatrixFreeSoA.diagonal ({kind})"

        jE, jover = jax.jit(lambda o: o.to_ell(9))(jop)
        tE, tover = top.to_ell(9)
        assert bool(tover) == bool(jover) is False, f"to_ell overflow ({kind})"
        _assert_ell_close(tE, jE, f"to_ell ({kind})")
        bE, _ = tms.ell_from_op_blocked(top, 9, blocks=2)
        jbE, _ = jms.ell_from_op_blocked(jop, 9, blocks=2)
        _assert_ell_close(bE, jbE, f"ell_from_op_blocked ({kind})")
        assert bool(top.to_ell(5)[1]), f"to_ell(5) must overflow ({kind})"

        y_ref = np.asarray(jE @ jnp.asarray(v))
        scale = np.abs(y_ref).max()
        assert np.abs(_np(tE @ _t(v)) - y_ref).max() <= 1e-13 * scale, f"ELLSoA @ ({kind})"
        np.testing.assert_allclose(_np(tE.diagonal()), np.asarray(jE.diagonal()),
                                   rtol=1e-13, atol=0, err_msg=f"ELLSoA.diagonal ({kind})")
        dd = rng.uniform(0.5, 2.0, nd)
        _assert_ell_close(tE.with_added_diagonal(_t(dd)), jE.with_added_diagonal(jnp.asarray(dd)),
                          f"with_added_diagonal ({kind})")
        y32 = _np(tE.astype(torch.float32) @ _t(v).float())
        assert y32.dtype == np.float32
        assert np.abs(y32 - y_ref).max() <= 1e-5 * scale, f"ELLSoA float32 @ ({kind})"

        # band plan: the lattice numbering is banded, the scrambled one not
        assert plan_split_width(tE) == j_plan(jE), f"plan_split_width ({kind})"
    vals, cols, nd_s = _scrambled_fem_ell(n, S=128, G=29)
    E_s = ell_from_numpy(vals, cols, (nd_s, nd_s), device="cpu")
    assert plan_split_width(E_s) == j_plan(jms.ELLSoA(jnp.asarray(vals), jnp.asarray(cols),
                                                      (nd_s, nd_s))) == (None, 0), \
        "plan_split_width must reject the scrambled numbering"


def test_lane_routed_ell_matches_jax():
    """LaneRoutedELL on K2 against JAX's lane-routed Pallas kernel on the
    scrambled n_side = 64 FEM ELL: f64 to rtol 1e-13, f32 tables to 1e-5
    of max|y|, bf16 tables within the JAX bf16 test's bound (2e-2 of
    max|y|) of a bf16-rounded reference; a rectangular n_src; diagonal,
    astype, with_vals and its ValueError; n_remainder == 0; K2's sliced
    form (its plain version) on a skewed, rectangular, Psi^T-like table at
    sigma 1 and 128 against JAX's _spmv and SparseMatrix @ to 1e-13, with
    SparseMatrix @ on it; and the CPU wrappers' argument checks (no launch
    counted on the CPU)."""
    vals, cols, nd = _scrambled_fem_ell()
    jE = jms.ELLSoA(jnp.asarray(vals), jnp.asarray(cols), (nd, nd))
    E = ell_from_numpy(vals, cols, (nd, nd), device="cpu")
    jop = JLane.from_ell(jE, p_max=12, rounds=12)
    launches = gs.ell_spmv_launches
    op = LaneRoutedELL.from_ell(E, p_max=12, rounds=12)
    assert op.n_remainder == 0 and op.shape == (nd, nd), "n_remainder / shape"
    rng = np.random.default_rng(1)
    v = rng.standard_normal(nd)

    ref = np.asarray(jop @ jnp.asarray(v))
    got = _np(op @ _t(v))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13, err_msg="float64 @")
    np.testing.assert_allclose(_np(op.diagonal()), np.asarray(jop.diagonal()),
                               rtol=1e-14, atol=0, err_msg="diagonal")

    v32 = v.astype(np.float32)
    ref = np.asarray(jop.astype(jnp.float32) @ jnp.asarray(v32))
    got = _np(op.astype(torch.float32) @ _t(v32))
    assert got.dtype == np.float32, "float32 tables give a float32 product"
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), "float32 @"

    E_b = jms.ELLSoA(jE.vals.astype(jnp.bfloat16).astype(jnp.float32), jE.cols, jE.shape)
    ref = np.asarray(E_b @ jnp.asarray(v32))
    ref_lane = np.asarray(jop.astype(jnp.bfloat16) @ jnp.asarray(v32))
    got = _np(op.astype(torch.bfloat16) @ _t(v32))
    assert got.dtype == np.float32, "bfloat16 tables give a float32 product"
    for name, r in (("rounded ELL", ref), ("JAX bf16 lane", ref_lane)):
        assert np.abs(got - r).max() <= 2e-2 * np.abs(r).max(), f"bfloat16 @ vs {name}"

    # rectangular near-square operator (the aux-grid P / P^T shape class)
    n, n_src, K = 3000, 3101, 4
    rows = np.arange(n)
    rcols = np.clip(rows[None, :] + rng.integers(-40, 140, size=(K, n)), 0, n_src - 1).astype(np.int32)
    rvals = rng.standard_normal((K, n))
    rvals[0, 7] = 0.0
    jR = JLane.from_ell(jms.ELLSoA(jnp.asarray(rvals), jnp.asarray(rcols), (n, n_src)))
    R = LaneRoutedELL.from_ell(ell_from_numpy(rvals, rcols, (n, n_src), device="cpu"))
    assert R.shape == (n, n_src) == jR.shape, "rectangular shape"
    w = rng.standard_normal(n_src)
    np.testing.assert_allclose(_np(R @ _t(w)), np.asarray(jR @ jnp.asarray(w)),
                               rtol=1e-13, atol=1e-13, err_msg="rectangular @")
    np.testing.assert_array_equal(_np(R.diagonal()), np.zeros(n), err_msg="rectangular diagonal")
    with pytest.raises(ValueError):  # operand of the wrong length
        R @ _t(v)

    # schedule reuse: same cols, new values
    d = rng.uniform(0.5, 2.0, nd)
    S_ell = E.with_added_diagonal(_t(d))
    jS = jE.with_added_diagonal(jnp.asarray(d))
    opS = LaneRoutedELL.from_ell(E, keep_remap=True).with_vals(S_ell)
    jopS = JLane.from_ell(jE, p_max=12, rounds=12, keep_remap=True).with_vals(jS)
    np.testing.assert_allclose(_np(opS @ _t(v)), np.asarray(jopS @ jnp.asarray(v)),
                               rtol=1e-13, atol=1e-13, err_msg="with_vals @")
    np.testing.assert_allclose(_np(opS.diagonal()), np.asarray(jopS.diagonal()),
                               rtol=1e-14, err_msg="with_vals diagonal")
    with pytest.raises(ValueError, match="remap"):
        op.with_vals(S_ell)
    with pytest.raises(ValueError):  # other sparsity
        LaneRoutedELL.from_ell(E, keep_remap=True).with_vals(ell_from_numpy(rvals, rcols, (n, n_src), device="cpu"))
    with pytest.raises(ValueError):  # a column outside [0, n_src)
        LaneRoutedELL.from_ell(ell_from_numpy(rvals, rcols, (n, 3000), device="cpu"))

    # K2's sliced form on a skewed, rectangular, Psi^T-like table (row
    # lengths 0-40, a few long rows): its plain version at sigma = 1 and
    # sigma > 1 against JAX's interpret-mode _spmv on the same matrix (its
    # lane schedule takes at most 30 slots, so as two 20-slot halves) and
    # JAX's SparseMatrix @, to 1e-13 in f64; one layout per sigma, equal
    # results
    from fdapde_core_tpu.linear_algebra.sparse import SparseMatrix as JSparse
    from fdapde_core_tpu_torch.linear_algebra.sparse import SparseMatrix

    n_t, n_src_t, K_t = 700, 3000, 40
    lens = np.minimum(rng.geometric(0.1, n_t) - 1, K_t)
    lens[rng.choice(n_t, 5, replace=False)] = K_t
    lens[:3] = 0
    t_rows = np.repeat(np.arange(n_t), lens)
    t_cols = np.concatenate([np.sort(rng.choice(n_src_t, L, replace=False)) for L in lens])
    t_vals = rng.standard_normal(t_rows.size)
    ell_v, ell_c = np.zeros((K_t, n_t)), np.zeros((K_t, n_t), dtype=np.int32)
    slot = np.arange(t_rows.size) - np.repeat(np.cumsum(lens) - lens, lens)
    ell_v[slot, t_rows], ell_c[slot, t_rows] = t_vals, t_cols
    w = rng.standard_normal(n_src_t)
    ref = sum(np.asarray(JLane.from_ell(jms.ELLSoA(jnp.asarray(ell_v[h]), jnp.asarray(ell_c[h]),
                                                    (n_t, n_src_t))) @ jnp.asarray(w))
              for h in (slice(0, 20), slice(20, 40)))
    ref_coo = np.asarray(JSparse(jnp.asarray(t_rows), jnp.asarray(t_cols), jnp.asarray(t_vals),
                                 (n_t, n_src_t)) @ jnp.asarray(w))
    scale = np.abs(ref_coo).max()
    assert np.abs(ref - ref_coo).max() <= 1e-13 * scale, "JAX lane halves vs JAX SparseMatrix"
    ys = []
    for sigma in (1, 128):
        A = gs.SlicedELL.from_coo(_t(t_rows), _t(t_cols), _t(t_vals), (n_t, n_src_t), sigma=sigma)
        assert A.width == K_t and (A.perm is None) == (sigma == 1), f"sigma={sigma}: layout"
        assert A.cols.numel() >= t_rows.size and A.dest.shape == (t_rows.size,)
        ys.append(A @ _t(w))
        for name, r in (("JAX _spmv", ref), ("JAX SparseMatrix @", ref_coo)):
            assert np.abs(_np(ys[-1]) - r).max() <= 1e-13 * scale, f"sigma={sigma}: vs {name}"
    assert torch.equal(ys[0], ys[1]), "the window sort changed a row's sum"
    S = SparseMatrix(_t(t_rows.astype(np.int32)), _t(t_cols.astype(np.int32)), _t(t_vals),
                     (n_t, n_src_t))
    assert torch.equal(S @ _t(w), ys[1]), "SparseMatrix @ is the sliced product"
    padding = [gs.SlicedELL.from_coo(_t(t_rows), _t(t_cols), _t(t_vals), (n_t, n_src_t),
                                     sigma=s).padding_ratio() for s in (1, 128)]
    assert K_t * n_t / t_rows.size > padding[0] > padding[1], f"padding ratios {padding}"
    with pytest.raises(ValueError):  # a window that is not a multiple of the slice
        gs.SlicedELL.from_coo(_t(t_rows), _t(t_cols), _t(t_vals), (n_t, n_src_t), sigma=48)
    with pytest.raises(ValueError):  # operand of the wrong length
        A @ _t(v)
    with pytest.raises(ValueError):  # operand dtype differs from the values'
        A @ _t(w).float()

    # the wrapper on CPU tensors: plain version, argument checks, no count
    vt = _t(v)
    assert torch.equal(gs.ell_spmv(E.vals, E.cols, vt), gs.ell_spmv_reference(E.vals, E.cols, vt))
    with pytest.raises(ValueError):  # x not in the accumulation dtype
        gs.ell_spmv(E.vals, E.cols, vt.float())
    with pytest.raises(ValueError):  # int64 cols
        gs.ell_spmv(E.vals, E.cols.long(), vt)
    with pytest.raises(ValueError):  # non-contiguous values
        gs.ell_spmv(E.vals.t().contiguous().t(), E.cols, vt)
    with pytest.raises(TypeError):
        gs.ell_spmv(E.vals.half(), E.cols, vt.float())
    assert gs.ell_spmv_launches == launches, "a CPU product counted a kernel launch"


def test_auxgrid_and_solvers_match_jax():
    """AuxGridPreconditioner (build_device and host build) against JAX: idx
    exact, weights and inverse diagonal to 1e-6 relative (float32), the
    apply to 1e-5 relative and equal across two calls, P^T r (K2's sliced
    form) against JAX's segment_sum to 1e-6. DirichletSystem + cg / cg_chunked /
    cg_split_programs / bicgstab (+ chunked) against JAX in float64: equal
    iteration counts, x to 1e-10 relative."""
    n = 32
    x, y, c0, c1, c2, bnd = (np.asarray(a) for a in j_mesh_soa(n, 0.2, dtype=jnp.float64))
    nd = x.shape[0]
    jop, _ = jms.MatrixFreeSoA.build(*(jnp.asarray(a) for a in (x, y, c0, c1, c2)), nd, 8)
    jE, _ = jax.jit(lambda o: o.to_ell(9))(jop)
    E = ell_from_numpy(jE.vals, jE.cols, jE.shape, device="cpu")
    jsys, sys = JDirichlet(jE, jnp.asarray(bnd)), DirichletSystem(E, _t(bnd))
    diag = np.asarray(jsys.diagonal())
    np.testing.assert_allclose(_np(sys.diagonal()), diag, rtol=1e-14, err_msg="DirichletSystem.diagonal")
    rng = np.random.default_rng(5)
    r = rng.standard_normal(nd).astype(np.float32)

    jaux = JAux.build_device((jnp.asarray(x), jnp.asarray(y)), jnp.asarray(diag, jnp.float32))
    aux = AuxGridPreconditioner.build_device((_t(x), _t(y)), _t(diag).float())
    jaux_h = JAux.build(np.stack([x, y], 1), jnp.asarray(diag, jnp.float32), grid_n=24)
    aux_h = AuxGridPreconditioner.build(np.stack([x, y], 1), _t(diag).float(), grid_n=24,
                                        device="cpu")
    for name, j, t in (("build_device", jaux, aux), ("build", jaux_h, aux_h)):
        assert t.n_grid == j.n_grid and t.mg.shapes == tuple(j.mg.shapes), f"{name}: grid"
        np.testing.assert_array_equal(_np(t.idx), np.asarray(j.idx), err_msg=f"{name}: idx")
        for what in ("w", "dinv"):
            np.testing.assert_allclose(_np(getattr(t, what)), np.asarray(getattr(j, what)),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name}: {what}")
        ref = np.asarray(j(jnp.asarray(r)))
        got = _np(t(_t(r)))
        assert got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), f"{name}: apply"
        assert np.array_equal(_np(t(_t(r))), got), f"{name}: apply differs between calls"
        # P^T alone, summed in segment_sum's order, against JAX's
        m = t.n_grid + 1
        rc = jax.ops.segment_sum((j.w * jnp.asarray(r)[None, :]).reshape(-1), j.idx.reshape(-1), m * m)
        np.testing.assert_allclose(_np(t.PT @ _t(r)), np.asarray(rc), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(rc)).max(), err_msg=f"{name}: P^T r")

    # Krylov solvers on the Dirichlet system, float64, Jacobi and aux
    b = np.where(bnd, 0.0, rng.uniform(0.5, 1.5, nd)) / nd
    jb, tb = jnp.asarray(b), _t(b)
    jpre = jsol.jacobi_preconditioner(jnp.asarray(diag))
    tpre = tsol.jacobi_preconditioner(_t(diag))
    # BiCGStab's residual history is erratic under Jacobi (float64
    # reassociation moves its count by a few); the aux grid keeps it short
    jaux_pre = jax.tree_util.Partial(lambda a, v: a(v.astype(jnp.float32)).astype(v.dtype), jaux)
    taux_pre = lambda v: aux(v.float()).double()  # noqa: E731
    seen = []
    cases = (
        ("cg", lambda: jsol.cg(jsys, jb, M_inv=jpre, rtol=1e-10, maxiter=500),
         lambda: tsol.cg(sys, tb, M_inv=tpre, rtol=1e-10, maxiter=500)),
        ("cg_chunked", lambda: jsol.cg_chunked(jsys, jb, rtol=1e-10, maxiter=500, chunk=7),
         lambda: tsol.cg_chunked(sys, tb, rtol=1e-10, maxiter=500, chunk=7,
                                 on_chunk=lambda k, rn: seen.append(k))),
        ("bicgstab", lambda: jsol.bicgstab(jsys, jb, M_inv=jaux_pre, rtol=1e-10, maxiter=500),
         lambda: tsol.bicgstab(sys, tb, M_inv=taux_pre, rtol=1e-10, maxiter=500)),
        ("bicgstab_chunked",
         lambda: jsol.bicgstab_chunked(jsys, jb, M_inv=jaux_pre, rtol=1e-10, maxiter=500, chunk=4),
         lambda: tsol.bicgstab_chunked(sys, tb, M_inv=taux_pre, rtol=1e-10, maxiter=500, chunk=4)),
        ("cg_split_programs",
         lambda: jsol.cg_split_programs(jsys, jb, jpre, rtol=1e-10, maxiter=500,
                                        check_every=6),
         lambda: tsol.cg_split_programs(sys, tb, tpre, rtol=1e-10, maxiter=500, check_every=6)),
    )
    for name, jrun, trun in cases:
        jx, jinfo = jrun()
        tx, tinfo = trun()
        assert tinfo.iterations == int(jinfo.iterations), \
            f"{name}: {tinfo.iterations} vs {int(jinfo.iterations)} iterations"
        assert tinfo.converged and bool(jinfo.converged), f"{name}: not converged"
        jx = np.asarray(jx)
        assert np.abs(_np(tx) - jx).max() <= 1e-10 * np.abs(jx).max(), f"{name}: x"
    k_final = seen[-1]
    assert seen == list(range(7, k_final, 7)) + [k_final], f"cg_chunked hook at {seen}"
    _, info = tsol.cg_split_programs(sys, tb, tpre, rtol=1e-10, maxiter=500, check_every=6)
    assert info.iterations % 6 == 0, "cg_split_programs stops only at a check"


def test_models_match_jax():
    """MatrixFreePoisson (auxgrid) and MatrixFreeElliptic (K=1, c=0.5,
    auxgrid, gather_kernel='lane', scrambled numbering; and an advection
    case through BiCGStab) against JAX at n_side = 48: iteration counts
    equal (within 1 on the lane path, whose float32 sums reassociate),
    true residuals <= rtol, solutions within 1e-7 relative, load vectors
    to 1e-14. The port validates gather_kernel / aux_kernel up front and
    raises NotImplementedError for what is not ported."""
    n = 48
    C = 2 * n * n
    rng = np.random.default_rng(21)
    f = rng.uniform(0.5, 1.5, C)
    x, y, c0, c1, c2, bnd = (np.asarray(a) for a in j_mesh_soa(n, 0.2, dtype=jnp.float64))
    nodes, cells = np.stack([x, y], 1), np.stack([c0, c1, c2], 1)

    def compare(name, jm, tm, rtol, it_slack=0, **kw):
        jb = jm.load_vector(jnp.asarray(f))
        tb = tm.load_vector(_t(f))
        np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-14, atol=1e-14 * np.abs(jb).max(),
                                   err_msg=f"{name}: load_vector")
        jx, jit_, jrel = jm.solve(jb, rtol=rtol, maxiter=300, **kw)
        tx, tit, trel = tm.solve(tb, rtol=rtol, maxiter=300, **kw)
        assert abs(int(tit) - int(jit_)) <= it_slack, f"{name}: {int(tit)} vs {int(jit_)} iterations"
        assert float(trel) <= rtol and float(jrel) <= rtol, f"{name}: residuals {trel} / {jrel}"
        jx = np.asarray(jx)
        assert np.abs(_np(tx) - jx).max() <= 1e-7 * np.abs(jx).max(), f"{name}: solution"

    compare("MatrixFreePoisson",
            JPoisson(jnp.asarray(nodes), jnp.asarray(cells), jnp.asarray(bnd), preconditioner="auxgrid"),
            MatrixFreePoisson(_t(nodes), _t(cells), _t(bnd), preconditioner="auxgrid", device="cpu"),
            1e-10)
    compare("MatrixFreePoisson chunked",
            JPoisson(jnp.asarray(nodes), jnp.asarray(cells), jnp.asarray(bnd), preconditioner="auxgrid",
                     format="matfree"),
            MatrixFreePoisson(_t(nodes), _t(cells), _t(bnd), preconditioner="auxgrid",
                              format="matfree", device="cpu"), 1e-10, chunk=10)
    adv = dict(K=1.0, b=(1.0, 0.5), c=0.5, preconditioner="auxgrid")
    compare("MatrixFreeElliptic advection (bicgstab)",
            JElliptic((jnp.asarray(x), jnp.asarray(y)), jnp.asarray(cells), jnp.asarray(bnd), **adv),
            MatrixFreeElliptic((_t(x), _t(y)), _t(cells), _t(bnd), device="cpu", **adv), 1e-10)

    xs, ys, cells_s, bnd_s = _scrambled_mesh(n, S=256, G=89)
    lane = dict(K=1.0, c=0.5, preconditioner="auxgrid", gather_kernel="lane")
    jm = JElliptic((jnp.asarray(xs), jnp.asarray(ys)), jnp.asarray(cells_s), jnp.asarray(bnd_s), **lane)
    tm = MatrixFreeElliptic((_t(xs), _t(ys)), _t(cells_s), _t(bnd_s), device="cpu", **lane)
    assert tm.preconditioner == jm.preconditioner == "auxgrid+lane"
    assert tm.op.vals.dtype == torch.float32 and tm.op_ref.vals.dtype == torch.float64
    assert plan_split_width(tm.op_ref) == (None, 0), "scrambled numbering must be rejected"
    compare("MatrixFreeElliptic lane", jm, tm, 1e-10, it_slack=1)
    with pytest.raises(NotImplementedError):  # the plan accepts the lattice numbering
        MatrixFreeElliptic((_t(x), _t(y)), _t(cells), _t(bnd), K=1.0, device="cpu")

    # gather_kernel / aux_kernel validation (JAX accepts these silently)
    mesh = ((_t(xs), _t(ys)), _t(cells_s), _t(bnd_s))
    for bad in (dict(aux_kernel="lanes", gather_kernel="lane"), dict(aux_kernel="lane"),
                dict(gather_kernel="pallas")):
        with pytest.raises(ValueError):
            MatrixFreeElliptic(*mesh, preconditioner="auxgrid", device="cpu", **bad)
    with pytest.raises(NotImplementedError):
        MatrixFreeElliptic(*mesh, preconditioner="auxgrid", gather_kernel="lane", aux_kernel="lane",
                           device="cpu")
    with pytest.raises(NotImplementedError):
        MatrixFreeElliptic.from_space(None)
    with pytest.raises(NotImplementedError):
        MatrixFreeParabolic(_t(nodes), _t(cells), _t(bnd), dt=1e-3, device="cpu")

