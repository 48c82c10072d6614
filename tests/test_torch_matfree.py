"""Port parity: the general-mesh gather path of fdapde_core_tpu_torch
(SoA pipeline in P1 and P2 and on tets, the element-local AoS forms and
the C-last assembly, assembled ELL on the K2 gather SpMV, the 2D and 3D
banded splits, aux-grid preconditioners (2D with its LaneAuxGrid, 3D),
Krylov solvers, on-device refinement and strip ordering, the matrix-free
models in 2D and 3D) against the JAX package, on the same numpy inputs.

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
from fdapde_core_tpu.geometry.structured import cube_mesh_device as j_cube
from fdapde_core_tpu.geometry.structured import cube_mesh_device_soa as j_cube_soa
from fdapde_core_tpu.geometry.structured import irregular_mesh_device as j_mesh
from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa as j_mesh_soa
from fdapde_core_tpu.linear_algebra import solvers as jsol
from fdapde_core_tpu.models.matfree import MatrixFreeElliptic as JElliptic
from fdapde_core_tpu.models.matfree import MatrixFreeParabolic as JParabolic
from fdapde_core_tpu.models.matfree import MatrixFreePoisson as JPoisson
from fdapde_core_tpu.ops import dia_split as jds
from fdapde_core_tpu.ops import matfree_soa as jms
from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner as JAux
from fdapde_core_tpu.ops.dia_split import plan_split_width as j_plan
from fdapde_core_tpu.ops.pallas_gather_spmv import LaneRoutedELL as JLane
from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
from fdapde_core_tpu_torch.geometry import (
    cube_mesh_device,
    cube_mesh_device_soa,
    irregular_mesh_device,
    irregular_mesh_device_soa,
)
from fdapde_core_tpu_torch.interop import ell_from_numpy
from fdapde_core_tpu_torch.linear_algebra import solvers as tsol
from fdapde_core_tpu_torch.models import (
    MatrixFreeElliptic,
    MatrixFreeParabolic,
    MatrixFreePoisson,
)
from fdapde_core_tpu_torch.fem.solvers import solve_parabolic
from fdapde_core_tpu_torch.ops import dia_split as tds
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


def _delaunay(nx, seed=7, amp=0.35):
    """A jittered (nx+1)^2 lattice of the unit square, scipy Delaunay:
    (nodes (N, 2), cells (C, 3) int32, boundary (N,) bool)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    return pts, Delaunay(pts).simplices.astype(np.int32), ~interior


def _p2_spaces(nx):
    """The JAX package's and the port's order-2 FEMSpace on _delaunay(nx)."""
    from fdapde_core_tpu.fem.space import FEMSpace as JSpace
    from fdapde_core_tpu.geometry.triangulation import Triangulation as JTri
    from fdapde_core_tpu_torch.fem import FEMSpace
    from fdapde_core_tpu_torch.geometry import Triangulation

    pts, cells, bnd = _delaunay(nx)
    jspace, tspace = JSpace(JTri(pts, cells, bnd), 2), FEMSpace(Triangulation(pts, cells, bnd), 2)
    np.testing.assert_array_equal(tspace.dofs, jspace.dofs, err_msg="P2 dof table")
    np.testing.assert_array_equal(tspace.boundary_dofs, jspace.boundary_dofs)
    return jspace, tspace


def _masked_reference(vals, cols, x, warp_w):
    """K2's plain version summing each row's slots only up to its warp's
    width (the slots the kernel reads with ``warp_w``), in slot order."""
    n = vals.shape[1]
    w = warp_w.long().repeat_interleave(gs.WARP)[:n]
    acc = torch.zeros(n, dtype=x.dtype)
    for k in range(int(w.max()) if n else 0):
        acc = torch.where(k < w, acc + vals[k].to(x.dtype) * x[cols[k].long()], acc)
    return acc


def _check_warp_widths(E, v, what, jref=None):
    """K2's warp widths of a compact (K, n) table E (an ELLSoA or a
    LaneRoutedELL): (ceil(n / 32),) int32; every slot at or past its warp's
    width is padding (col = row, val = 0); the plain version masked to the
    widths equals the full plain version (torch.equal) and ``jref``, JAX's
    product on the same table (1e-13 of scale); the CPU wrapper takes the
    widths, returns the plain version and counts no launch."""
    W = E.warp_w
    K, n = E.vals.shape
    assert W.dtype == torch.int32 and tuple(W.shape) == (-(-n // 32),), what
    past = torch.arange(K)[:, None] >= W.long().repeat_interleave(32)[:n][None, :]
    rows = torch.arange(n, dtype=E.cols.dtype).expand(K, n)
    assert torch.equal(E.cols[past], rows[past]) and not bool(E.vals[past].any()), \
        f"{what}: a slot past its warp's width is not padding"
    x = _t(v).to(gs.accumulation_dtype(E.vals.dtype))
    full = gs.ell_spmv_reference(E.vals, E.cols, x)
    masked = _masked_reference(E.vals, E.cols, x, W)
    assert torch.equal(masked, full), f"{what}: the widths skip a nonzero term"
    if jref is not None:
        jref = np.asarray(jref)
        assert np.abs(_np(masked) - jref).max() <= 1e-13 * np.abs(jref).max(), f"{what}: vs JAX"
    launches = gs.ell_spmv_launches
    assert torch.equal(gs.ell_spmv(E.vals, E.cols, x, W), full), what
    with pytest.raises(ValueError):  # widths of another length
        gs.ell_spmv(E.vals, E.cols, x, torch.cat([W, W[:1]]))
    with pytest.raises(ValueError):  # int64 widths
        gs.ell_spmv(E.vals, E.cols, x, W.long())
    assert gs.ell_spmv_launches == launches, f"{what}: a CPU product counted a launch"


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
    with_added_diagonal (1e-13 of scale) and the band plan (equal). The
    banded split of the Poisson ELL against JAX's, at the plan's W (every
    entry in the band: drop_empty_remainder) and at W + 1 (a remainder,
    and an overflow at max_rem=1): stencil layers to 1e-14 of scale, the
    remainder slot for slot (cols exact), split @ x == ELL @ x to 1e-14 of
    scale, diagonal, astype, with_added_diagonal and fold_dirichlet; a
    float64 BandedMG V-cycle to 1e-12 and banded_cg (x to 1e-12, |r|,
    and the breakdown flag, also on a negative definite shift).
    MatrixFreeP2SoA against JAX's and the assembled P2 matrix (tolerances
    at the check)."""
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
        # K2's warp widths: JAX's interpret-mode _spmv on the same table,
        # the widths shared by the tables that keep cols, and float32
        # values against a float64 v widened per product (no converted copy)
        _check_warp_widths(tE, v, f"warp widths ({kind})",
                           JLane.from_ell(jE, p_max=12, rounds=12) @ jnp.asarray(v))
        t32 = tE.astype(torch.float32)
        assert t32.warp_w is tE.warp_w and tE.with_added_diagonal(_t(dd)).warp_w is tE.warp_w
        lane = LaneRoutedELL.from_ell(t32, keep_remap=True)
        assert lane.warp_w is tE.warp_w and lane.with_vals(t32).warp_w is tE.warp_w
        assert lane.astype(torch.bfloat16).warp_w is tE.warp_w, f"widths lost ({kind})"
        y_mixed = t32 @ _t(v)
        assert y_mixed.dtype == torch.float64, f"float32 ELLSoA @ float64 v ({kind})"
        assert torch.equal(y_mixed, t32.astype(torch.float64) @ _t(v)), f"mixed @ ({kind})"

        # band plan: the lattice numbering is banded, the scrambled one not
        assert plan_split_width(tE) == j_plan(jE), f"plan_split_width ({kind})"
    vals, cols, nd_s = _scrambled_fem_ell(n, S=128, G=29)
    E_s = ell_from_numpy(vals, cols, (nd_s, nd_s), device="cpu")
    assert plan_split_width(E_s) == j_plan(jms.ELLSoA(jnp.asarray(vals), jnp.asarray(cols),
                                                      (nd_s, nd_s))) == (None, 0), \
        "plan_split_width must reject the scrambled numbering"

    # the banded split of the Poisson ELL
    jE, _ = jax.jit(lambda o: o.to_ell(9))(jms.MatrixFreeSoA.build(*J, nd, 8)[0])
    tE, _ = tms.MatrixFreeSoA.build(*T, nd, 8)[0].to_ell(9)
    W, amax = plan_split_width(tE)
    assert (W, amax) == (n + 1, 1)
    ve, mask = rng.standard_normal(nd), _t(bnd)

    def close(got, ref, what, rel=1e-14):
        ref = np.asarray(ref)
        assert np.abs(_np(got) - ref).max() <= rel * np.abs(ref).max(), what

    for w, max_rem in ((W, 2), (W + 1, 4)):
        jS, jover = jds.build_banded_split(jE, w, amax=amax, max_rem=max_rem)
        tS, tover = tds.build_banded_split(tE, w, amax=amax, max_rem=max_rem)
        what = f"banded split W={w}"
        assert not bool(tover) and not bool(jover), what
        assert tS.G.offsets2d == jS.G.offsets2d and tS.G.shape2d == jS.G.shape2d, what
        close(tS.G.data, jS.G.data, f"{what}: layers")
        np.testing.assert_array_equal(_np(tS.rem.cols), np.asarray(jS.rem.cols), err_msg=what)
        np.testing.assert_array_equal(_np(tS.rem.vals), np.asarray(jS.rem.vals), err_msg=what)
        rem_nnz = int((tS.rem.vals != 0).sum())
        assert (rem_nnz == 0) == (w == W), f"{what}: {rem_nnz} remainder entries"
        y_ell = _np(tE @ _t(ve))
        ops = [("", tS)] + ([("drop_empty_remainder", tS.drop_empty_remainder())] if w == W else [])
        for name, op in ops:
            assert np.abs(_np(op @ _t(ve)) - y_ell).max() <= 1e-14 * np.abs(y_ell).max(), \
                f"{what} {name}: split @ x != ELL @ x"
            close(op.diagonal(), jE.diagonal(), f"{what} {name}: diagonal")
        assert tS.astype(torch.float32).G.data.dtype == torch.float32
        dd = rng.uniform(0.5, 2.0, nd)
        close(tS.with_added_diagonal(_t(dd)).G.data,
              jS.with_added_diagonal(jnp.asarray(dd)).G.data, f"{what}: with_added_diagonal")
        jF, tF = jS.fold_dirichlet(jnp.asarray(bnd)), tS.fold_dirichlet(mask)
        close(tF.G.data, jF.G.data, f"{what}: fold_dirichlet layers")
        np.testing.assert_array_equal(_np(tF.rem.vals), np.asarray(jF.rem.vals), err_msg=what)
        jbmg = jds.BandedMGPreconditioner.build(jF, dtype=jnp.float64, coarse_n=4)
        tbmg = tds.BandedMGPreconditioner.build(tF, dtype=torch.float64, coarse_n=4)
        assert tbmg.mg.shapes == tuple(jbmg.mg.shapes) and len(tbmg.mg.shapes) >= 3, what
        close(tbmg(_t(ve)), jbmg(jnp.asarray(ve)), f"{what}: BandedMG V-cycle", 1e-12)
        bb = np.where(bnd, 0.0, rng.uniform(0.5, 1.5, nd))
        for name, F, FJ in (("SPD", tF, jF),
                            ("negative shift", tF.with_added_diagonal(_t(np.full(nd, -50.0))),
                             jF.with_added_diagonal(jnp.full(nd, -50.0)))):
            jx, jr, jok = jds.banded_cg(FJ, jnp.asarray(bb), 30)
            tx, tr, tok = tds.banded_cg(F, _t(bb), 30)
            assert bool(tok) == bool(jok) == (name == "SPD"), f"{what} {name}: breakdown flag"
            close(tx, jx, f"{what} {name}: banded_cg x", 1e-12)
            assert float(tr) == pytest.approx(float(jr), rel=1e-6, abs=1e-300), f"{what} {name}"
    assert bool(tds.build_banded_split(tE, W + 1, max_rem=1)[1])
    assert bool(jds.build_banded_split(jE, W + 1, max_rem=1)[1])

    # P2: MatrixFreeP2SoA against JAX's on the P2 space of a Delaunay mesh,
    # and against the port's assembled P2 matrix (JAX
    # tests/test_matfree_general.py:103-160): @ and diagonal to 1e-12 of
    # scale against JAX and rtol 1e-11 / atol 1e-12 against the assembly
    # (JAX's own tolerance there), the float32 copy's @ to 1e-6 of scale,
    # to_ell slot for slot (cols exact, vals to 1e-13 of scale)
    from fdapde_core_tpu_torch.fem import assemble_matrix
    from fdapde_core_tpu_torch.pde import advection, diffusion, laplacian, reaction

    jspace, space = _p2_spaces(8)
    C2, nd2 = space.mesh.n_cells, space.n_dofs
    Kt, bv, cr = np.array([[2.0, 0.3], [0.3, 1.5]]), np.array([1.0, 0.5]), 0.7
    p2_cases = (
        ("diffusion", dict(kxx=Kt[0, 0], kxy=Kt[0, 1], kyy=Kt[1, 1]), -diffusion(Kt)),
        ("advection", dict(kxx=1.0, bx=bv[0], by=bv[1]), -laplacian() + advection(bv)),
        ("reaction", dict(kxx=1.0, react=cr), -laplacian() + reaction(cr)),
    )
    p2_args = (space.mesh.nodes[:, 0], space.mesh.nodes[:, 1], space.dofs.T.astype(np.int32))
    v2 = rng.standard_normal(nd2)
    for kind, coef2, L in p2_cases:
        what = f"P2 {kind}"
        jop, jover = jms.MatrixFreeP2SoA.build(*(jnp.asarray(a) for a in p2_args), nd2, 8,
                                               **{k: jnp.full(C2, a) for k, a in coef2.items()})
        top, tover = tms.MatrixFreeP2SoA.build(*(_t(a) for a in p2_args), nd2, 8,
                                               **{k: _t(np.full(C2, a)) for k, a in coef2.items()})
        assert not bool(tover) and not bool(jover), what
        assert top.is_symmetric == jop.is_symmetric == (kind != "advection"), what
        A = assemble_matrix(space, L, device="cpu")
        ref = _np(A @ _t(v2))
        y = _np(top @ _t(v2))
        close(y, jop @ jnp.asarray(v2), f"{what}: @ vs JAX", 1e-12)
        np.testing.assert_allclose(y, ref, rtol=1e-11, atol=1e-12, err_msg=f"{what}: @ vs assembled")
        close(top.diagonal(), jop.diagonal(), f"{what}: diagonal vs JAX", 1e-12)
        np.testing.assert_allclose(_np(top.diagonal()), _np(A.diagonal()), rtol=1e-11, atol=1e-12,
                                   err_msg=f"{what}: diagonal vs assembled")
        t32 = top.astype(torch.float32)
        assert t32.s.dtype == torch.float32 and (t32.wq is None) == (top.wq is None), what
        close(t32 @ _t(v2).float(), jop.astype(jnp.float32) @ jnp.asarray(v2, jnp.float32),
              f"{what}: float32 @", 1e-6)
        jE2, jover2 = jax.jit(lambda o: o.to_ell(25))(jop)
        tE2, tover2 = tms.ell_from_op_blocked(top, 25)
        assert not bool(tover2) and not bool(jover2), what
        _assert_ell_close(tE2, jE2, f"{what}: to_ell")
        np.testing.assert_allclose(_np(tE2 @ _t(v2)), ref, rtol=1e-11, atol=1e-12,
                                   err_msg=f"{what}: ELL @ vs assembled")
        _check_warp_widths(tE2, v2, f"{what}: warp widths",
                           JLane.from_ell(jE2) @ jnp.asarray(v2) if kind == "diffusion" else None)
    assert bool(top.to_ell(12)[1]), "P2 to_ell(12) must overflow"

    # 3D: the cube meshes (topology exact, nodes to 1e-12, the boundary
    # exact: the jitter is masked to 0 there), the tet primitives (1e-12
    # relative), MatrixFreeSoA3D (build and build_general with K, b, c) @
    # and diagonal (1e-12 of scale), its (16, n) ELL slot for slot (cols
    # exact, vals to 1e-13 of scale), equal to ELLMatrix.from_local of the
    # AoS MatrixFreeLocal (JAX tests/test_dia_split.py:222-260, whose cols
    # are the transposed SoA cols); the AoS forms against JAX's
    from fdapde_core_tpu.ops import ell as jell
    from fdapde_core_tpu.ops import matfree as jmf
    from fdapde_core_tpu_torch.ops import ell as tell
    from fdapde_core_tpu_torch.ops import matfree as tmf

    n3 = 6
    for name, ref, got in (
        ("cube soa", j_cube_soa(n3, 0.2, dtype=jnp.float64), cube_mesh_device_soa(n3, 0.2, device="cpu")),
        ("cube stacked", j_cube(n3, 0.2, dtype=jnp.float64), cube_mesh_device(n3, 0.2, device="cpu")),
    ):
        for k, (r, g) in enumerate(zip(ref, got)):
            r, g = np.asarray(r), _np(g)
            assert r.shape == g.shape and r.dtype == g.dtype, f"mesh {name}[{k}]"
            if r.dtype.kind == "f":
                assert np.abs(r - g).max() <= 1e-12, f"mesh {name}[{k}] coordinates"
            else:
                np.testing.assert_array_equal(g, r, err_msg=f"mesh {name}[{k}] topology / boundary")
    x3, y3, z3, *cs3, bnd3 = (np.asarray(a) for a in j_cube_soa(n3, 0.2, dtype=jnp.float64))
    nd3, C3 = x3.shape[0], cs3[0].shape[0]
    coef3 = dict(kxx=rng.uniform(1, 2, C3), kxy=rng.uniform(-.2, .2, C3), kxz=rng.uniform(-.2, .2, C3),
                 kyy=rng.uniform(1, 2, C3), kyz=rng.uniform(-.2, .2, C3), kzz=rng.uniform(1, 2, C3),
                 bx=rng.uniform(-1, 1, C3), by=rng.uniform(-1, 1, C3), bz=rng.uniform(-1, 1, C3),
                 react=rng.uniform(0.1, 1.0, C3))
    J3 = [jnp.asarray(a) for a in (x3, y3, z3, *cs3)]
    T3 = [_t(a) for a in (x3, y3, z3, *cs3)]
    ref = jms.p1_general_soa_3d(*J3, **{k: jnp.asarray(v) for k, v in coef3.items()})
    got = tms.p1_general_soa_3d(*T3, **{k: _t(v) for k, v in coef3.items()})
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-12, atol=1e-12,
                                   err_msg=f"p1_general_soa_3d[{k}]")
    v3 = rng.standard_normal(nd3)
    for kind in ("poisson", "general"):
        if kind == "poisson":
            jop, jover = jms.MatrixFreeSoA3D.build(*J3, nd3, 24)
            top, tover = tms.MatrixFreeSoA3D.build(*T3, nd3, 24)
        else:
            jop, jover = jms.MatrixFreeSoA3D.build_general(
                *J3, nd3, 24, **{k: jnp.asarray(a) for k, a in coef3.items()})
            top, tover = tms.MatrixFreeSoA3D.build_general(
                *T3, nd3, 24, **{k: _t(a) for k, a in coef3.items()})
        what = f"MatrixFreeSoA3D ({kind})"
        assert not bool(tover) and not bool(jover) and top.is_symmetric == (kind == "poisson"), what
        np.testing.assert_array_equal(_np(top.adj), np.asarray(jop.adj), err_msg=what)
        close(top @ _t(v3), jop @ jnp.asarray(v3), f"{what} @", 1e-12)
        close(top.diagonal(), jop.diagonal(), f"{what} diagonal", 1e-12)
        close(top.astype(torch.float32) @ _t(v3).float(),
              jop.astype(jnp.float32) @ jnp.asarray(v3, jnp.float32), f"{what} float32 @", 1e-6)
        jE3, jo3 = jop.to_ell(16)  # eager: at this size cheaper than a compile
        tE3, to3 = tms.ell_from_op_blocked(top, 16)
        assert not bool(to3) and not bool(jo3) and tuple(tE3.vals.shape) == (16, nd3), what
        _assert_ell_close(tE3, jE3, f"{what}: to_ell")
        close(tE3 @ _t(v3), jE3 @ jnp.asarray(v3), f"{what}: ELL @", 1e-13)
        _check_warp_widths(tE3, v3, f"{what}: warp widths",
                           JLane.from_ell(jE3) @ jnp.asarray(v3) if kind == "poisson" else None)
        assert bool(top.to_ell(12)[1]), f"{what}: to_ell(12) must overflow"

    nodes3 = np.stack([x3, y3, z3], 1)
    cells3 = np.stack(cs3, 1)
    for name, jf, tf, nodes_, cells_ in (
        ("p1_local_stiffness", jmf.p1_local_stiffness, tmf.p1_local_stiffness,
         np.stack([np.asarray(a) for a in J[:2]], 1), np.stack([np.asarray(a) for a in J[2:]], 1)),
        ("p1_local_stiffness_3d", jmf.p1_local_stiffness_3d, tmf.p1_local_stiffness_3d, nodes3, cells3),
    ):
        nd_, nb_ = nodes_.shape[0], cells_.shape[1]
        kap_ = rng.uniform(0.5, 2.0, cells_.shape[0])
        A_j = jf(jnp.asarray(nodes_), jnp.asarray(cells_), jnp.asarray(kap_))
        A_t = tf(_t(nodes_), _t(cells_), _t(kap_))
        close(A_t, A_j, name, 1e-13)
        D_ = 8 if nb_ == 3 else 24
        mfj, _ = jmf.MatrixFreeLocal.build(A_j, jnp.asarray(cells_), nd_, D_)
        mft, overl = tmf.MatrixFreeLocal.build(A_t, _t(cells_), nd_, D_)
        assert not bool(overl) and bool(tmf.MatrixFreeLocal.build(A_t, _t(cells_), nd_, 3)[1]), name
        np.testing.assert_array_equal(_np(mft.adj), np.asarray(mfj.adj), err_msg=f"{name}: adjacency")
        np.testing.assert_array_equal(_np(mft.adj_mask), np.asarray(mfj.adj_mask))
        vv = rng.standard_normal(nd_)
        close(mft @ _t(vv), mfj @ jnp.asarray(vv), f"{name}: MatrixFreeLocal @", 1e-13)
        close(mft.diagonal(), mfj.diagonal(), f"{name}: MatrixFreeLocal diagonal", 1e-13)
        assert mft.astype(torch.float32).A_loc.dtype == torch.float32
        Kc = nb_ * D_ // 2 if nb_ == 3 else 15
        Ej, oj = jax.jit(lambda op: jell.ELLMatrix.from_local(op.A_loc, op.dofs, op.adj,
                                                              op.adj_mask, Kc))(mfj)
        Et, ot = tell.ELLMatrix.from_local(mft.A_loc, mft.dofs, mft.adj, mft.adj_mask, Kc)
        assert not bool(ot) and not bool(oj), name
        np.testing.assert_array_equal(_np(Et.cols), np.asarray(Ej.cols), err_msg=f"{name}: from_local cols")
        close(Et.vals, Ej.vals, f"{name}: from_local vals", 1e-13)
        close(Et @ _t(vv), Ej @ jnp.asarray(vv), f"{name}: ELLMatrix @", 1e-13)
        close(Et.diagonal(), Ej.diagonal(), f"{name}: ELLMatrix diagonal", 1e-13)
        dd = rng.uniform(0.5, 2.0, nd_)
        close(Et.with_added_diagonal(_t(dd)).vals, Ej.with_added_diagonal(jnp.asarray(dd)).vals,
              f"{name}: ELLMatrix with_added_diagonal", 1e-13)
        _check_warp_widths(Et._slot_major, vv, f"{name}: ELLMatrix warp widths")
        assert Et.astype(torch.float32).warp_w is Et.warp_w
        assert Et.with_added_diagonal(_t(dd)).warp_w is Et.warp_w, f"{name}: ELLMatrix widths"
        close(tell.ell_spmv(mft.A_loc, mft.dofs.long(), mft.adj, mft.adj_mask, _t(vv)),
              jell.ell_spmv(mfj.A_loc, mfj.dofs, mfj.adj, mfj.adj_mask, jnp.asarray(vv)),
              f"{name}: the element-local combine", 1e-13)
        if nb_ == 4:  # the SoA ELL of the same operator, transposed
            tE3, _ = tms.MatrixFreeSoA3D.build(*T3, nd3, 24, kappa=_t(kap_))[0].to_ell(15)
            np.testing.assert_array_equal(_np(tE3.cols).T, _np(Et.cols), err_msg="SoA vs AoS cols")
            close(_np(tE3.vals).T, Et.vals, "SoA vs AoS vals", 1e-13)

    # the C-last assembly (ops/soa_assembly.py) on a tet space and a P2
    # triangle space: affine maps and local matrices to 1e-13 of scale,
    # the assembled values (constant and varying coefficients) to 1e-13 of
    # scale against JAX's and the port's assemble_matrix
    from fdapde_core_tpu.fem.space import FEMSpace as JSpace
    from fdapde_core_tpu.geometry.triangulation import Triangulation as JTri
    from fdapde_core_tpu.ops import soa_assembly as jsa
    from fdapde_core_tpu.pde import advection as jadv
    from fdapde_core_tpu.pde import diffusion as jdiff
    from fdapde_core_tpu.pde import laplacian as jlap
    from fdapde_core_tpu.pde import reaction as jreac
    from fdapde_core_tpu_torch.fem import FEMSpace
    from fdapde_core_tpu_torch.geometry import Triangulation
    from fdapde_core_tpu_torch.ops import soa_assembly as tsa

    spaces = (("tets", JSpace(JTri(nodes3, cells3, bnd3), 1), FEMSpace(Triangulation(nodes3, cells3, bnd3), 1)),
              ("P2", jspace, space))
    for name, js_, ts_ in spaces:
        N_ = ts_.mesh.embed_dim
        Jn, Tn = jnp.asarray(ts_.mesh.nodes), _t(ts_.mesh.nodes)
        Jc, Tc = jnp.asarray(ts_.mesh.cells.T), _t(ts_.mesh.cells.T).long()
        for r, g in zip(jsa.affine_maps_soa(Jn, Jc), tsa.affine_maps_soa(Tn, Tc)):
            r, g = (np.asarray(r), torch.stack([torch.stack(row) for row in g]).numpy()) \
                if isinstance(r, list) else (np.asarray(r), _np(g))
            close(g, r, f"{name}: affine_maps_soa", 1e-13)
        Kd = np.eye(N_) + 0.2 * (np.ones((N_, N_)) - np.eye(N_))
        bv_ = np.linspace(0.5, 1.0, N_)
        for kind, cf in (("laplacian", None), ("diffusion", Kd), ("advection", bv_), ("reaction", 0.7)):
            args = (ts_.phi_tab, ts_.grad_tab, ts_.quad.weights)
            r = jsa.local_matrices_soa(kind, cf, Jn, Jc, *args)
            g = tsa.local_matrices_soa(kind, cf, Tn, Tc, *args)
            close(torch.stack([torch.stack(row) for row in g]), np.asarray(jnp.stack([jnp.stack(row) for row in r])),
                  f"{name}: local_matrices_soa {kind}", 1e-13)
        c_var = lambda p: 1.0 + p[..., 0] ** 2  # noqa: E731  (a varying reaction)
        for L, JL in ((-diffusion(Kd) + advection(bv_) + reaction(0.7), -jdiff(Kd) + jadv(bv_) + jreac(0.7)),
                      (-laplacian() + reaction(c_var), -jlap() + jreac(c_var))):
            ref = np.asarray(jsa.assemble_soa_values(js_, JL))
            got = tsa.assemble_soa_values(ts_, L, device="cpu")
            close(got, ref, f"{name}: assemble_soa_values", 1e-13)
            close(got, assemble_matrix(ts_, L, device="cpu").vals, f"{name}: soa vs assemble_matrix", 1e-13)


# the dtype pairs of a compact product: (table, operand)
_COMPACT_PAIRS = ((torch.float64, torch.float64), (torch.float32, torch.float32),
                  (torch.bfloat16, torch.float32), (torch.float32, torch.float64))


def _check_compact_faces():
    """The one compact-ELL operator (``gather_spmv.ELLSoA``) behind its
    faces: ELLSoA, ELLMatrix, LaneRoutedELL, WindowedELL and the aux grid's
    P, on the n = 24 lattice Poisson ELL (WindowedELL's band) and its
    (4, n) bilinear table, over the table / operand dtype pairs f64/f64,
    f32/f32, bf16/f32 and f32/f64: each product in
    ``accumulation_dtype(vals, x)`` (float32 values on a float64 x give
    float64 in every face, LaneRoutedELL included) and torch.equal to
    ``ell_spmv_reference`` on the widened table; astype, with_vals and
    with_added_diagonal share the warp widths; ELLMatrix and WindowedELL
    hold one table (their vals are views of the slot-major storage); a
    rectangular operator's diagonal is zeros and its operand check takes
    n_src."""
    from fdapde_core_tpu_torch.ops import ELLMatrix, WindowedELL

    x, y, c0, c1, c2, _ = irregular_mesh_device_soa(24, 0.2, device="cpu")
    E, _ = tms.MatrixFreeSoA.build(x, y, c0, c1, c2, x.shape[0], 8)[0].to_ell(9)
    P = AuxGridPreconditioner.build_device((x, y), torch.ones_like(x), grid_n=16,
                                           dtype=torch.float64).P
    n, n_grid = E.shape[0], P.shape[1]
    assert isinstance(P, tms.ELLSoA) and P.shape == (n, n_grid) and P.warp_w is None
    assert torch.equal(P.diagonal(), torch.zeros(n, dtype=torch.float64)), "rectangular diagonal"
    with pytest.raises(ValueError):
        P @ torch.zeros(n, dtype=torch.float64)
    M = ELLMatrix(E.vals.T, E.cols.T, E.shape, E.warp_w)
    faces = (("ELLSoA", E, E), ("ELLMatrix", M, E),
             ("LaneRoutedELL", LaneRoutedELL.from_ell(E, keep_remap=True), E),
             ("WindowedELL", WindowedELL.from_ell(E, block_rows=128), E), ("aux P", P, P))
    rng = np.random.default_rng(17)
    for name, F, T in faces:
        for vdt, xdt in _COMPACT_PAIRS:
            what = f"{name} {vdt} x {xdt}"
            Fd, Td = F.astype(vdt), T.astype(vdt)
            v = torch.from_numpy(rng.standard_normal(T.shape[1])).to(xdt)
            acc = gs.accumulation_dtype(vdt, xdt)
            got = Fd @ v
            assert got.dtype == acc, what
            ref = gs.ell_spmv_reference(Td.vals.to(acc), Td.cols, v.to(acc))
            assert torch.equal(got, ref), what
            if T.warp_w is not None and name != "WindowedELL":
                d = torch.ones(n, dtype=vdt)
                assert Fd.warp_w is Fd.with_added_diagonal(d).warp_w is E.warp_w, what
        if name == "LaneRoutedELL":
            assert F.with_vals(E.with_added_diagonal(torch.ones(n))).warp_w is E.warp_w, name
    assert M.vals.data_ptr() == M._slot_major.vals.data_ptr() and M.vals.shape == E.vals.T.shape
    M32 = M.astype(torch.float32)
    assert M32.vals.data_ptr() == M32._slot_major.vals.data_ptr(), "ELLMatrix holds two tables"
    W = faces[3][1]
    assert W.vals.data_ptr() == W._k2.vals.data_ptr(), "WindowedELL holds two tables"


def test_lane_routed_ell_matches_jax(tmp_path):
    """LaneRoutedELL on K2 against JAX's lane-routed Pallas kernel on the
    scrambled n_side = 64 FEM ELL: f64 to rtol 1e-13, f32 tables to 1e-5
    of max|y|, bf16 tables within the JAX bf16 test's bound (2e-2 of
    max|y|) of a bf16-rounded reference; a rectangular n_src; diagonal,
    astype, with_vals and its ValueError; n_remainder == 0; K2's sliced
    form (its plain version) on a skewed, rectangular, Psi^T-like table at
    sigma 1 and 128 against JAX's _spmv and SparseMatrix @ to 1e-13, with
    SparseMatrix @ on it; the CPU wrappers' argument checks (no launch
    counted on the CPU); and the refined, strip-ordered meshes of
    geometry/refine_device.py against JAX's (see the comment there)."""
    vals, cols, nd = _scrambled_fem_ell()
    jE = jms.ELLSoA(jnp.asarray(vals), jnp.asarray(cols), (nd, nd))
    E = ell_from_numpy(vals, cols, (nd, nd), device="cpu")
    assert E.warp_w is None and LaneRoutedELL.from_ell(E).warp_w is None, "unvouched widths"
    # JAX's assembled table holds one entry per (row, col): its widths hold
    E = tms.ELLSoA(E.vals, E.cols, E.shape, gs.ell_warp_widths(E.cols))
    jop = JLane.from_ell(jE, p_max=12, rounds=12)
    launches = gs.ell_spmv_launches
    op = LaneRoutedELL.from_ell(E, p_max=12, rounds=12)
    assert op.n_remainder == 0 and op.shape == (nd, nd), "n_remainder / shape"
    rng = np.random.default_rng(1)
    v = rng.standard_normal(nd)

    ref = np.asarray(jop @ jnp.asarray(v))
    got = _np(op @ _t(v))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13, err_msg="float64 @")
    _check_warp_widths(op, v, "LaneRoutedELL warp widths", ref)
    assert op.warp_w is E.warp_w and op.astype(torch.float32).warp_w is E.warp_w
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
    assert opS.warp_w is E.warp_w, "with_vals keeps the warp widths"
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

    # the strip-ordered, red-refined meshes LaneRoutedELL serves at scale
    # (bench.py's gendel): uniform_refine_device over 2 levels of a
    # Delaunay base equals JAX's exactly (coordinates, cells, boundary), the
    # base degrees are kept and new nodes have 6 cells (3 on the boundary);
    # strip_order and strip_order_binned give JAX's permutations; a mesh
    # with a hole raises in both packages. The two faults of JAX's
    # strip_order_binned are repaired: 2^17 strips raise ValueError, and
    # constant float32 coordinates give finite keys where JAX's normalised
    # coordinate is NaN (its 1e-300 guard is 0 in float32)
    from fdapde_core_tpu.geometry import refine_device as jrd
    from fdapde_core_tpu_torch.geometry import refine_device as trd

    pts, cells_b, bnd_b = _delaunay(12, seed=11)
    base = (pts[:, 0], pts[:, 1], *cells_b.T, bnd_b)
    ref = jrd.uniform_refine_device(*(jnp.asarray(a) for a in base), 2)
    got = trd.uniform_refine_device(*(_t(a) for a in base), 2)
    for k, (r_, g_) in enumerate(zip(ref, got)):
        assert _np(g_).dtype == np.asarray(r_).dtype, f"refined mesh [{k}] dtype"
        np.testing.assert_array_equal(_np(g_), np.asarray(r_), err_msg=f"refined mesh [{k}]")
    n0, n2 = pts.shape[0], got[0].shape[0]
    n_lvl, c_lvl = n0, cells_b.shape[0]
    for _ in range(2):  # each level adds one node an edge, n + C - 1 edges
        n_lvl, c_lvl = 2 * n_lvl + c_lvl - 1, 4 * c_lvl
    assert (n2, got[2].shape[0]) == (n_lvl, c_lvl), "refined sizes"
    deg = torch.bincount(torch.cat(got[2:5]).long(), minlength=n2)
    np.testing.assert_array_equal(_np(deg[:n0]), np.bincount(cells_b.ravel(), minlength=n0))
    assert set(_np(deg[n0:][~got[5][n0:]]).tolist()) == {6}
    assert set(_np(deg[n0:][got[5][n0:]]).tolist()) == {3}
    x2, y2 = np.asarray(ref[0]), np.asarray(ref[1])
    for fn, pop in (("strip_order", 100), ("strip_order_binned", 100), ("strip_order_binned", 1)):
        jo, jr = getattr(jrd, fn)(jnp.asarray(x2), jnp.asarray(y2), pop)
        to, tr = getattr(trd, fn)(_t(x2), _t(y2), pop)
        assert to.dtype == tr.dtype == torch.int32, fn
        np.testing.assert_array_equal(_np(to), np.asarray(jo), err_msg=f"{fn}({pop}) order")
        np.testing.assert_array_equal(_np(tr), np.asarray(jr), err_msg=f"{fn}({pop}) rank")
    hole = np.delete(cells_b, np.flatnonzero(~bnd_b[cells_b].any(1))[0], axis=0)  # an annulus
    with pytest.raises(ValueError):
        jrd.uniform_refine_device(*(jnp.asarray(a) for a in (pts[:, 0], pts[:, 1], *hole.T, bnd_b)), 1)
    with pytest.raises(ValueError):
        trd.uniform_refine_device(*(_t(a) for a in (pts[:, 0], pts[:, 1], *hole.T, bnd_b)), 1)
    with pytest.raises(ValueError):  # 2^17 strips overflow the int32 key
        trd.strip_order_binned(torch.zeros(1 << 17), torch.zeros(1 << 17), 1)
    trd.strip_order_binned(torch.zeros((1 << 17) - 1), torch.zeros((1 << 17) - 1), 1)
    flat = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    const = np.full(64, 0.5, dtype=np.float32)
    for xs_, ys_ in ((const, const), (flat, const), (const, flat)):
        keys = _np(trd._strip_keys(_t(xs_), _t(ys_), 8))
        assert keys.min() >= 0 and keys.max() < 8 * 16384, "strip keys out of range"
        order, _ = trd.strip_order_binned(_t(xs_), _t(ys_), 8)
        expect = np.lexsort((np.minimum((xs_ - xs_.min()) / max(np.ptp(xs_), 1e-30) * 16384, 16383)
                             .astype(np.int64), np.minimum((ys_ - ys_.min()) / max(np.ptp(ys_), 1e-30)
                                                           * 8, 7).astype(np.int64)))
        np.testing.assert_array_equal(_np(order), expect, err_msg="float32 strip order")
    jc = jnp.asarray(const)
    assert bool(jnp.isnan((jc - jc.min()) / jnp.maximum(jc.max() - jc.min(), 1e-300)).all()), \
        "JAX's float32 guard no longer underflows"
    _check_compact_faces()
    _check_halo_ell_and_lane_match_jax(tmp_path)


def _check_halo_ell_and_lane_match_jax(tmp_path):
    """The halo ELL solvers on 4 gloo CPU ranks against JAX's on 4 virtual
    devices (``torch_sharded.check_against_jax``: solutions within
    max(rtol, 1e-12) max|x|, iterations equal within 1): HaloELLSolver on
    the n = 24 irregular mesh at 1e-11 (tests/test_parallel.py:464);
    HaloLaneSolver on the n = 40 block-scrambled mesh (S = 64, G = 19) at
    1e-11 with Jacobi and at 1e-10 with the distributed aux grid
    (grid_n = 16; :640): no remainder in the port, and the aux grid's
    count below Jacobi's and within 2x + 2 of the single-device aux-PCG's
    (JAX's bound)."""
    from fdapde_core_tpu.parallel.halo_ell import HaloELLSolver as JHaloELL
    from fdapde_core_tpu.parallel.halo_lane import HaloLaneSolver as JHaloLane
    from fdapde_core_tpu_torch.parallel import HaloLaneSolver, make_device_mesh
    from torch_sharded import check_against_jax

    def ell_of(n):
        x, y, c0, c1, c2, bnd = j_mesh_soa(n, 0.2, dtype=jnp.float64)
        soa, _ = jms.MatrixFreeSoA.build(x, y, c0, c1, c2, (n + 1) ** 2, 8)
        E, _ = soa.to_ell(9)
        return x, y, E, bnd

    def case(name, cls, E, bnd, rtol, maxiter, aux=None, kw=None):
        b = np.asarray(jnp.where(bnd, 0.0, 1.0)) / (n_of[name] ** 2)
        free = (~np.asarray(bnd)).astype(np.float64)
        kind = "halo_ell" if cls is JHaloELL else "halo_lane"
        spec = dict(kind=kind, vals=np.asarray(E.vals), cols=np.asarray(E.cols), b=b, free=free,
                    rtol=rtol, maxiter=maxiter, aux=aux)

        def jax_solve(dm):
            jaux = None if aux is None else JAux.build(aux[0], aux[1], grid_n=aux[2],
                                                       dtype=jnp.float64)
            extra = {} if cls is JHaloELL else dict(aux=jaux, rounds=12)
            x, _, k = cls(E, dm, **extra).solve(b, free, rtol=rtol, maxiter=maxiter)
            return x, k
        return name, spec, jax_solve, rtol, 1

    n_of = {"HaloELLSolver": 24, "HaloLaneSolver": 40, "HaloLaneSolver aux": 40}
    _, _, E24, bnd24 = ell_of(24)
    x, y, E0, bnd = ell_of(40)
    nd = 41 * 41
    S, G = 64, 19
    GI = pow(G, -1, S)
    i = np.arange(nd)
    nfull = (nd // S) * S
    pm = np.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
    pinv = np.where(i < nfull, (i // S) * S + (GI * (i % S)) % S, i)
    E = jms.ELLSoA(E0.vals[:, pinv], jnp.asarray(pm)[E0.cols[:, pinv]], (nd, nd))
    bnd_s = bnd[pinv]
    diag = np.asarray(jax.jit(lambda s_, m: JDirichlet(s_, m).diagonal())(E, bnd_s))
    coords = np.stack([np.asarray(x)[pinv], np.asarray(y)[pinv]], axis=1)
    cases = [case("HaloELLSolver", JHaloELL, E24, bnd24, 1e-11, 2000),
             case("HaloLaneSolver", JHaloLane, E, bnd_s, 1e-11, 4000),
             case("HaloLaneSolver aux", JHaloLane, E, bnd_s, 1e-10, 500, aux=(coords, diag, 16))]
    got, _ = check_against_jax(tmp_path / "halo_ell", cases)
    # each of 4 shards' (K, block) tables of the n = 24 ELL: its warp
    # widths (the global rows', cut to the shard's) leave only padding
    # (halo-local col = local row + H, val = 0) past each warp's width; the
    # masked plain product over the halo-extended vector equals the full one
    from types import SimpleNamespace
    from fdapde_core_tpu_torch.parallel import HaloELLSolver

    E24t = ell_from_numpy(np.asarray(E24.vals), np.asarray(E24.cols), E24.shape, device="cpu")
    mesh0 = SimpleNamespace(rank=0, size=4, device=torch.device("cpu"))
    assert HaloELLSolver(E24t, mesh0).warp_w is None, "a table without widths reads all K slots"
    E24t = tms.ELLSoA(E24t.vals, E24t.cols, E24t.shape, gs.ell_warp_widths(E24t.cols))
    rng = np.random.default_rng(3)
    for rank in range(4):
        sh = HaloELLSolver(E24t, SimpleNamespace(rank=rank, size=4, device=torch.device("cpu")))
        K, block = sh.vals.shape
        W = sh.warp_w
        assert W.dtype == torch.int32 and tuple(W.shape) == (-(-block // 32),), rank
        past = torch.arange(K)[:, None] >= W.long().repeat_interleave(32)[:block][None, :]
        pad = (torch.arange(block, dtype=sh.lcols.dtype) + sh.H).expand(K, block)
        assert torch.equal(sh.lcols[past], pad[past]) and not bool(sh.vals[past].any()), rank
        ext = torch.from_numpy(rng.standard_normal(block + 2 * sh.H))
        assert torch.equal(_masked_reference(sh.vals, sh.lcols, ext, W),
                           gs.ell_spmv_reference(sh.vals, sh.lcols, ext)), f"shard {rank}"
    k_jacobi, k_aux = int(got[1]["N"]["k"]), int(got[2]["N"]["k"])
    Et = ell_from_numpy(np.asarray(E.vals), np.asarray(E.cols), (nd, nd), device="cpu")
    mask = torch.as_tensor(np.array(bnd_s))
    assert HaloLaneSolver(Et, make_device_mesh(1, device="cpu")).n_remainder == 0
    aux = AuxGridPreconditioner.build(coords, torch.as_tensor(np.array(diag)), grid_n=16,
                                      dtype=torch.float64, device="cpu")
    b = torch.where(mask, 0.0, 1.0).double() / 1600
    _, info = tsol.cg(DirichletSystem(Et, mask), b, M_inv=aux, rtol=1e-10, maxiter=500)
    assert k_aux < k_jacobi and k_aux <= 2 * info.iterations + 2, (k_aux, k_jacobi, info.iterations)


def test_auxgrid_and_solvers_match_jax():
    """AuxGridPreconditioner (build_device and host build) against JAX: idx
    exact, weights and inverse diagonal to 1e-6 relative (float32), the
    apply to 1e-5 relative and equal across two calls, P^T r (K2's sliced
    form) against JAX's segment_sum to 1e-6. DirichletSystem + cg / cg_chunked /
    cg_split_programs / bicgstab (+ chunked) against JAX in float64: equal
    iteration counts, x to 1e-10 relative. LaneAuxGrid, interp_transpose_ell
    and lane_friendly_grid_n against the plain apply and JAX (tolerances at
    the check)."""
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

    # LaneAuxGrid (the aux grid's apply: P on K2's compact form, P^T its
    # sliced ELL) against the plain composition with P z as a torch gather
    # (float32: to 1e-6 of max|z|) and
    # JAX's lane-routed apply (interpret mode, JAX's own bound 2e-5 of
    # max|z|); its three stages compose to the apply bitwise, and JAX's
    # routing arguments change nothing. interp_transpose_ell is the adjoint
    # of P: <P z, r> == <z, P^T r> in float64 to 1e-12 relative.
    # lane_friendly_grid_n equals JAX's.
    from fdapde_core_tpu.ops.lane_aux import LaneAuxGrid as JLaneAux
    from fdapde_core_tpu.ops.lane_aux import lane_friendly_grid_n as j_grid_n
    from fdapde_core_tpu_torch.ops.lane_aux import (
        LaneAuxGrid,
        interp_transpose_ell,
        lane_friendly_grid_n,
    )

    sizes = list(range(1, 3000, 7)) + [65_537, 10 ** 6, 2_076_481, 5_130_225, 10_246_401]
    assert [lane_friendly_grid_n(k) for k in sizes] == [j_grid_n(k) for k in sizes]
    m2 = (aux.n_grid + 1) ** 2
    PT64 = interp_transpose_ell(aux.idx, aux.w.double(), nd, m2)
    assert PT64.shape == (m2, nd) and PT64.dest.shape == (aux.idx.numel(),), "every entry in the ELL"
    z, r64 = _t(rng.standard_normal(m2)), _t(rng.standard_normal(nd))
    lhs = float((z[aux.idx.long()] * aux.w.double()).sum(0) @ r64)
    assert abs(lhs - float(z @ (PT64 @ r64))) <= 1e-12 * abs(lhs), "P^T is not the adjoint of P"
    lane = LaneAuxGrid.from_aux(aux)
    assert lane.PT is aux.PT and lane.idx is aux.idx and lane.n_grid == aux.n_grid
    zg = aux.mg.v_cycle(aux.PT @ _t(r))
    ref = _np(aux.omega * aux.dinv * _t(r) + (zg[aux.idx.long()] * aux.w).sum(0))
    got = _np(lane(_t(r)))
    assert got.dtype == np.float32 and np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), \
        "LaneAuxGrid apply vs the plain apply"
    v = _t(r)
    for stage in lane.split_stages:
        v = stage(v, _t(r))
    assert np.array_equal(_np(v), got), "split_stages do not compose to the apply"
    assert np.array_equal(_np(LaneAuxGrid.from_aux(aux, rounds=2, max_k=1, k_cap=1)(_t(r))), got)
    jlane = JLaneAux.from_aux(jaux)
    jref = np.asarray(jax.jit(lambda la, r_: la(r_))(jlane, jnp.asarray(r)))
    assert np.abs(got - jref).max() <= 2e-5 * np.abs(jref).max(), "LaneAuxGrid apply vs JAX"

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

    # AuxGridPreconditioner3D in float64, build_device ((n, 3) and the
    # (x, y, z) tuple) and the host build, against JAX: the grid, idx
    # exact, w and dinv to 1e-14, the apply to 1e-12 of max|z| and equal
    # across two calls; carried across by interop (JAX's levels) to 1e-12;
    # P^T is P's adjoint, <P z, r> == <z, P^T r> to 1e-12 relative; and
    # solve_elliptic's ("auxgrid", coords) takes it on 3D coordinates
    from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner3D as JAux3
    from fdapde_core_tpu_torch.fem.solvers import solve_elliptic
    from fdapde_core_tpu_torch.interop import aux_grid_3d_from_numpy
    from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner3D

    nodes3, cells3, bnd3 = (np.asarray(a) for a in j_cube(8, 0.2, dtype=jnp.float64))
    nd3 = nodes3.shape[0]
    diag3 = rng.uniform(0.5, 2.0, nd3)
    r3 = rng.standard_normal(nd3)
    j3 = (("build_device", JAux3.build_device(jnp.asarray(nodes3), jnp.asarray(diag3), dtype=jnp.float64)),
          ("build", JAux3.build(nodes3, jnp.asarray(diag3))))
    t3 = (("build_device", AuxGridPreconditioner3D.build_device(_t(nodes3), _t(diag3), dtype=torch.float64)),
          ("build", AuxGridPreconditioner3D.build(nodes3, _t(diag3), device="cpu")))
    soa3 = AuxGridPreconditioner3D.build_device(tuple(_t(nodes3[:, d]) for d in range(3)), _t(diag3),
                                                dtype=torch.float64)
    for (name, j), (_, t) in zip(j3, t3):
        name = f"3D aux grid {name}"
        assert t.n_grid == j.n_grid == 8 and t.mg.shapes == tuple(j.mg.shapes), name
        assert t.idx.shape == (8, nd3) and t.PT.shape == ((t.n_grid + 1) ** 3, nd3), name
        np.testing.assert_array_equal(_np(t.idx), np.asarray(j.idx), err_msg=name)
        for what in ("w", "dinv"):
            np.testing.assert_allclose(_np(getattr(t, what)), np.asarray(getattr(j, what)),
                                       rtol=1e-14, atol=1e-14, err_msg=f"{name}: {what}")
        ref = np.asarray(jax.jit(lambda a, v: a(v))(j, jnp.asarray(r3)))
        got = t(_t(r3))
        assert np.abs(_np(got) - ref).max() <= 1e-12 * np.abs(ref).max(), f"{name}: apply"
        assert torch.equal(t(_t(r3)), got), f"{name}: apply differs between calls"
        carried = aux_grid_3d_from_numpy(
            j.idx, j.w, j.dinv, ([np.asarray(d) for d in j.mg.datas], j.mg.offsets, j.mg.shapes,
                                 j.mg.omega, j.mg.nu, j.mg.coarse_iters), j.omega, j.n_grid, device="cpu")
        assert np.abs(_np(carried(_t(r3))) - ref).max() <= 1e-12 * np.abs(ref).max(), f"{name}: interop"
        zg = _t(rng.standard_normal(t.PT.shape[0]))
        lhs = float(t.interpolate(zg) @ _t(r3))
        assert abs(lhs - float(zg @ (t.PT @ _t(r3)))) <= 1e-12 * abs(lhs), f"{name}: P^T adjoint"
    assert torch.equal(soa3(_t(r3)), t3[0][1](_t(r3))), "the (x, y, z) tuple gives another aux grid"
    jE3, _ = jms.MatrixFreeSoA3D.build(*(jnp.asarray(nodes3[:, d]) for d in range(3)),
                                       *(jnp.asarray(cells3[:, j]) for j in range(4)), nd3, 24)[0].to_ell(16)
    A3 = ell_from_numpy(jE3.vals, jE3.cols, jE3.shape, device="cpu")
    b3, g3, m3 = _t(np.where(bnd3, 0.0, 1.0)), torch.zeros(nd3, dtype=torch.float64), _t(bnd3)
    x3, info3 = solve_elliptic(A3, b3, m3, g3, rtol=1e-10, preconditioner=("auxgrid", nodes3))
    pre3 = AuxGridPreconditioner3D.build(nodes3, DirichletSystem(A3, m3).diagonal(), device="cpu")
    x3b, info3b = solve_elliptic(A3, b3, m3, g3, rtol=1e-10, preconditioner=pre3)
    assert info3.converged and info3.iterations == info3b.iterations <= 30, (info3, info3b)
    assert torch.equal(x3, x3b), "solve_elliptic's 3D aux grid is not AuxGridPreconditioner3D.build's"


def test_models_match_jax():
    """MatrixFreePoisson (auxgrid) and MatrixFreeElliptic (K=1, c=0.5,
    auxgrid, gather_kernel='lane', scrambled numbering; and an advection
    case through BiCGStab) against JAX at n_side = 48: iteration counts
    equal (within 1 on the lane path, whose float32 sums reassociate),
    true residuals <= rtol, solutions within 1e-7 relative, load vectors
    to 1e-14. On the lattice numbering the band plan accepts, "auto" takes
    "banded_mg" in both packages (MatrixFreePoisson; MatrixFreeElliptic
    with advection, through BiCGStab): iterations equal, solutions to 1e-7.
    MatrixFreeParabolic at n_side = 24 over 4 steps against JAX's, on the
    banded route (iterations equal) and the aux-grid route (iterations
    within 1: float32 aux sums reassociate), trajectories to 1e-10; the
    aux-grid route at dt = h^2 for n_side = 24 and 48, whose step
    iterations grow with n in both packages (within 1 of each other); the
    banded route against the port's solve_parabolic(lumped=True) on the
    same mesh to 1e-10, and chunked stepping bitwise equal. The port
    validates gather_kernel / aux_kernel up front. The shared build: the
    max_degree / max_cols overflows and "banded_mg" without a band raise in
    all three models, solve(chunk=...) takes solve()'s iterates, and
    MatrixFreeParabolic preconditions the shifted operator on both routes.
    aux_kernel="lane" and from_space (order 1 and 2) against JAX: the same
    aux grid, equal iterations, solutions to 1e-10 relative; P2 reproduces
    x^2 + y^2 to 1e-10 of max|u|."""
    n = 48
    C = 2 * n * n
    rng = np.random.default_rng(21)
    f = rng.uniform(0.5, 1.5, C)
    x, y, c0, c1, c2, bnd = (np.asarray(a) for a in j_mesh_soa(n, 0.2, dtype=jnp.float64))
    nodes, cells = np.stack([x, y], 1), np.stack([c0, c1, c2], 1)

    def compare(name, jm, tm, rtol, it_slack=0, sol_tol=1e-7, f=f, **kw):
        jb = jm.load_vector(jnp.asarray(f))
        tb = tm.load_vector(_t(f))
        np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-14, atol=1e-14 * np.abs(jb).max(),
                                   err_msg=f"{name}: load_vector")
        jx, jit_, jrel = jm.solve(jb, rtol=rtol, maxiter=300, **kw)
        tx, tit, trel = tm.solve(tb, rtol=rtol, maxiter=300, **kw)
        assert abs(int(tit) - int(jit_)) <= it_slack, f"{name}: {int(tit)} vs {int(jit_)} iterations"
        assert float(trel) <= rtol and float(jrel) <= rtol, f"{name}: residuals {trel} / {jrel}"
        jx = np.asarray(jx)
        assert np.abs(_np(tx) - jx).max() <= sol_tol * np.abs(jx).max(), f"{name}: solution"

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

    # the lattice numbering: "auto" takes the banded split and its multigrid
    banded = (
        ("MatrixFreePoisson banded",
         JPoisson(jnp.asarray(nodes), jnp.asarray(cells), jnp.asarray(bnd)),
         MatrixFreePoisson(_t(nodes), _t(cells), _t(bnd), device="cpu")),
        ("MatrixFreeElliptic banded advection (bicgstab)",
         JElliptic((jnp.asarray(x), jnp.asarray(y)), jnp.asarray(cells), jnp.asarray(bnd),
                   K=1.0, b=(1.0, 0.5), c=0.5, split_plan=(n + 1, 1)),
         MatrixFreeElliptic((_t(x), _t(y)), _t(cells), _t(bnd), K=1.0, b=(1.0, 0.5), c=0.5,
                            split_plan=(n + 1, 1), gather_kernel="lane", device="cpu")),
    )
    for name, jm, tm in banded:
        assert tm.preconditioner == jm.preconditioner == "banded_mg", name
        assert tm.aux.mg.shapes == tuple(jm.aux.mg.shapes), name
        compare(name, jm, tm, 1e-10)
    # the one operator build of the three models: a max_degree or max_cols
    # overflow and an explicit "banded_mg" on the scrambled numbering (no
    # band) raise in each
    mesh_s = (_t(np.stack([xs, ys], 1)), _t(cells_s), _t(bnd_s))
    for cls, extra in ((MatrixFreePoisson, {}), (MatrixFreeElliptic, dict(K=1.0)),
                       (MatrixFreeParabolic, dict(dt=0.01))):
        for kw, match in ((dict(max_degree=3), "max_degree=3"),
                          (dict(max_cols=4), "4 distinct columns"),
                          (dict(preconditioner="banded_mg"), "no concentrated band")):
            with pytest.raises(ValueError, match=match):
                cls(*mesh_s, device="cpu", **extra, **kw)
    # solve(chunk=...) takes solve()'s iterates (CG and BiCGStab), calling
    # on_chunk every chunk iterations
    for tm in (MatrixFreePoisson(_t(nodes), _t(cells), _t(bnd), preconditioner="auxgrid",
                                 device="cpu"),
               MatrixFreeElliptic((_t(x), _t(y)), _t(cells), _t(bnd), device="cpu", **adv)):
        tb, seen = tm.load_vector(_t(f)), []
        x1, k1, r1 = tm.solve(tb, rtol=1e-10, maxiter=300)
        xc, kc, rc = tm.solve(tb, rtol=1e-10, maxiter=300, chunk=3,
                              on_chunk=lambda k, rn: seen.append(k))
        assert torch.equal(xc, x1) and kc == k1 and torch.equal(rc, r1), type(tm).__name__
        assert seen == list(range(3, k1, 3)) + [k1], seen

    # MatrixFreeParabolic on both routes, and against solve_parabolic
    n_p, dt, steps = 24, 0.01, 4
    xp, yp, q0, q1, q2, bp = (np.asarray(a) for a in j_mesh_soa(n_p, 0.2, dtype=jnp.float64))
    nodes_p, cells_p = np.stack([xp, yp], 1), np.stack([q0, q1, q2], 1)
    u0 = np.sin(np.pi * xp) * np.sin(np.pi * yp)
    for route, kw, slack in (("banded_mg", {}, 0),
                             ("auxgrid", dict(preconditioner="auxgrid", bbox=((0.0, 0.0), (1.0, 1.0))), 1)):
        jp = JParabolic(jnp.asarray(nodes_p), jnp.asarray(cells_p), jnp.asarray(bp), dt, **kw)
        tp = MatrixFreeParabolic(_t(nodes_p), _t(cells_p), _t(bp), dt, device="cpu", **kw)
        assert tp.preconditioner == jp.preconditioner == route
        ju, jinfo = jp.solve(jnp.asarray(u0), n_steps=steps, rtol=1e-11, maxiter=200)
        tu, tinfo = tp.solve(_t(u0), n_steps=steps, rtol=1e-11, maxiter=200, keep_trajectory=True)
        assert all(abs(a - b) <= slack for a, b in zip(tinfo["iterations"], jinfo["iterations"])), \
            (route, tinfo["iterations"], jinfo["iterations"])
        assert max(tinfo["rel_residuals"]) < 1e-10, route
        assert np.abs(_np(tu) - np.asarray(ju)).max() <= 1e-10, route
        assert torch.equal(tinfo["trajectory"][:, -1], tu)
    # the aux-grid route at dt = h^2: its grid stencil is the unshifted
    # Laplacian in both packages, so its step iterations grow with n (at
    # dt = 0.01 they stay near 12); the port's counts are JAX's within 1
    first = {}
    for n_h in (24, 48):
        xh, yh, h0, h1, h2, bh = (np.asarray(a) for a in j_mesh_soa(n_h, 0.2, dtype=jnp.float64))
        mesh_h = (np.stack([xh, yh], 1), np.stack([h0, h1, h2], 1), bh)
        uh = np.sin(np.pi * xh) * np.sin(np.pi * yh)
        kw = dict(preconditioner="auxgrid", bbox=((0.0, 0.0), (1.0, 1.0)))
        jp = JParabolic(*(jnp.asarray(a) for a in mesh_h), 1.0 / n_h ** 2, **kw)
        tp = MatrixFreeParabolic(*(_t(a) for a in mesh_h), 1.0 / n_h ** 2, device="cpu", **kw)
        ju, jinfo = jp.solve(jnp.asarray(uh), n_steps=3, rtol=1e-9, maxiter=400)
        tu, tinfo = tp.solve(_t(uh), n_steps=3, rtol=1e-9, maxiter=400)
        assert all(abs(a - b) <= 1 for a, b in zip(tinfo["iterations"], jinfo["iterations"])), \
            (n_h, tinfo["iterations"], jinfo["iterations"])
        assert max(tinfo["rel_residuals"]) <= 1e-9 and max(jinfo["rel_residuals"]) <= 1e-9
        assert np.abs(_np(tu) - np.asarray(ju)).max() <= 1e-8 * np.abs(uh).max(), n_h
        first[n_h] = (tinfo["iterations"][0], jinfo["iterations"][0])
    assert all(first[48][k] >= 1.4 * first[24][k] >= 1.4 * 12 for k in (0, 1)), first
    # the banded route is the lumped implicit Euler of the assembled operator
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_matrix
    from fdapde_core_tpu_torch.geometry import Triangulation
    from fdapde_core_tpu_torch.pde import laplacian, reaction

    tp = MatrixFreeParabolic(_t(nodes_p), _t(cells_p), _t(bp), dt, device="cpu")
    tu, _ = tp.solve(_t(u0), n_steps=steps, rtol=1e-11, maxiter=200)
    space = FEMSpace(Triangulation(nodes_p, cells_p, bp), 1)
    zero = torch.zeros((space.n_dofs, steps + 1), dtype=torch.float64)
    us = solve_parabolic(assemble_matrix(space, -laplacian(), device="cpu"),
                         assemble_matrix(space, reaction(1.0), device="cpu"), zero, _t(bp), zero,
                         _t(u0), np.arange(steps + 1) * dt, rtol=1e-11, lumped=True)
    assert np.abs(_np(tu) - _np(us[:, -1])).max() <= 1e-10
    uc, _ = tp.solve(_t(u0), n_steps=steps, rtol=1e-11, maxiter=200, chunk=5)
    assert torch.equal(uc, tu), "chunked stepping differs"
    # both routes precondition the shifted operator A + M_L / dt: the
    # banded V-cycle is its fold's, the aux grid's inverse diagonal its own
    tpois = MatrixFreePoisson(_t(nodes_p), _t(cells_p), _t(bp), device="cpu")
    assert torch.equal(tp.op.diagonal(), tpois.op.diagonal() + tp.mdiag / dt)
    r32 = torch.from_numpy(rng.standard_normal(tp.n_dofs)).float()
    fold = tds.BandedMGPreconditioner.build(tp.op.astype(torch.float32).fold_dirichlet(_t(bp)))
    assert tp.preconditioner == "banded_mg" and torch.equal(tp.aux(r32), fold(r32))
    tpa = MatrixFreeParabolic(_t(nodes_p), _t(cells_p), _t(bp), dt, preconditioner="auxgrid",
                              device="cpu")
    d = tpa.op.diagonal().float()
    assert torch.equal(tpa.aux.dinv, torch.where(d != 0, 1 / d, 1.0)), "aux grid not shifted"

    # gather_kernel / aux_kernel validation (JAX accepts these silently)
    mesh = ((_t(xs), _t(ys)), _t(cells_s), _t(bnd_s))
    for bad in (dict(aux_kernel="lanes", gather_kernel="lane"), dict(aux_kernel="lane"),
                dict(gather_kernel="pallas")):
        with pytest.raises(ValueError):
            MatrixFreeElliptic(*mesh, preconditioner="auxgrid", device="cpu", **bad)

    # aux_kernel="lane" (JAX tests/test_lane_aux.py:134-159): a LaneAuxGrid
    # over lane_friendly_grid_n(n) cells a side in both packages, equal
    # iterations, solutions to 1e-10 relative
    from fdapde_core_tpu.fem.space import FEMSpace as JSpace
    from fdapde_core_tpu.geometry.triangulation import Triangulation as JTri
    from fdapde_core_tpu_torch.ops.lane_aux import LaneAuxGrid, lane_friendly_grid_n

    xl, yl, l0, l1, l2, bl = (np.asarray(a) for a in j_mesh_soa(24, 0.2, dtype=jnp.float64))
    cells_l = np.stack([l0, l1, l2], 1)
    lane_aux = dict(gather_kernel="lane", aux_kernel="lane", preconditioner="auxgrid")
    jm = JElliptic((jnp.asarray(xl), jnp.asarray(yl)), jnp.asarray(cells_l), jnp.asarray(bl), **lane_aux)
    tm = MatrixFreeElliptic((_t(xl), _t(yl)), _t(cells_l), _t(bl), device="cpu", **lane_aux)
    assert isinstance(tm.aux, LaneAuxGrid) and type(jm.aux).__name__ == "LaneAuxGrid"
    assert tm.aux.n_grid == jm.aux.n_grid == lane_friendly_grid_n(xl.shape[0])
    compare("MatrixFreeElliptic aux_kernel='lane'", jm, tm, 1e-10, sol_tol=1e-10,
            f=np.ones(cells_l.shape[0]))

    # from_space, order 1 and 2, on a Delaunay mesh (K = 1, c = 1): the
    # space's dof table, the same route ("auto" takes the aux grid on P2's
    # nodes-then-edges numbering), equal iterations, solutions to 1e-10
    pts, cells_d, bnd_d = _delaunay(10)
    for order in (1, 2):
        jspace = JSpace(JTri(pts, cells_d, bnd_d), order)
        tspace = FEMSpace(Triangulation(pts, cells_d, bnd_d), order)
        jm = JElliptic.from_space(jspace, K=1.0, c=1.0)
        tm = MatrixFreeElliptic.from_space(tspace, K=1.0, c=1.0, device="cpu")
        name = f"from_space order {order}"
        assert tm.n_dofs == jm.n_dofs == tspace.n_dofs and tm.preconditioner == jm.preconditioner, name
        assert order == 1 or tm.preconditioner == "auxgrid", name
        np.testing.assert_array_equal(_np(tm.dofs), np.asarray(jm.dofs), err_msg=name)
        if tm.preconditioner == "auxgrid":
            assert tm.aux.n_grid == jm.aux.n_grid, name
        compare(name, jm, tm, 1e-12, sol_tol=1e-10, f=rng.uniform(0.5, 1.5, cells_d.shape[0]))
    # P2 reproduces u = x^2 + y^2: f = -4 per cell, g = u at the dofs
    u = _t((tspace.dof_coords ** 2).sum(1))
    tq = MatrixFreeElliptic.from_space(tspace, K=1.0, device="cpu")
    xq, _, relq = tq.solve(tq.load_vector(torch.full((cells_d.shape[0],), -4.0, dtype=torch.float64)),
                           g=u, rtol=1e-12, maxiter=300)
    assert float(relq) <= 1e-12 and (xq - u).abs().max() <= 1e-10 * u.abs().max(), "P2 quadratic"
    with pytest.raises(ValueError):
        MatrixFreeElliptic.from_space(FEMSpace(Triangulation(pts, cells_d, bnd_d), 3), device="cpu")

    # 3D on the jittered n = 6 cube. plan_split_3d reads (m, m^2) in both
    # packages and rejects a block-scrambled numbering; the split at the
    # plan is exact with an empty remainder, at (m + 1, m (m + 1)) its
    # remainder equals JAX's slot for slot (cols exact, vals to 1e-14 of
    # scale); layers and fold to 1e-14 of scale, and at the plan a float64
    # BandedMGPreconditioner3D V-cycle (levels 9, 5, 3) to 1e-12 of scale
    from fdapde_core_tpu.ops import dia_split3d as jds3
    from fdapde_core_tpu_torch.interop import banded_split_3d_from_numpy, mesh_from_numpy
    from fdapde_core_tpu_torch.ops import dia_split3d as tds3

    n3 = 6
    m3 = n3 + 1
    nodes3, cells3, bnd3 = (np.asarray(a) for a in j_cube(n3, 0.2, dtype=jnp.float64))
    nd3, C3 = nodes3.shape[0], cells3.shape[0]
    J3 = [jnp.asarray(nodes3[:, d]) for d in range(3)] + [jnp.asarray(cells3[:, j]) for j in range(4)]
    jE3, _ = jax.jit(lambda o: o.to_ell(16))(jms.MatrixFreeSoA3D.build(*J3, nd3, 24)[0])
    tE3, _ = tms.MatrixFreeSoA3D.build(*(_t(_np(a)) for a in J3), nd3, 24)[0].to_ell(16)
    assert tds3.plan_split_3d(tE3) == jds3.plan_split_3d(jE3) == (m3, m3 * m3)
    v3 = rng.standard_normal(nd3)
    y3 = _np(tE3 @ _t(v3))
    for (w1, w2, max_rem) in ((m3, m3 * m3, 2), (m3 + 1, m3 * (m3 + 1), 6)):
        what = f"3D split ({w1}, {w2})"
        jS, jo = jax.jit(lambda E: jds3.build_banded_split_3d(E, w1, w2, max_rem=max_rem))(jE3)
        tS, to = tds3.build_banded_split_3d(tE3, w1, w2, max_rem=max_rem)
        assert not bool(to) and not bool(jo), what
        assert tS.G.offsets3d == jS.G.offsets3d and tS.G.shape3d == jS.G.shape3d, what
        sc = np.abs(np.asarray(jS.G.data)).max()
        assert np.abs(_np(tS.G.data) - np.asarray(jS.G.data)).max() <= 1e-14 * sc, what
        np.testing.assert_array_equal(_np(tS.rem.cols), np.asarray(jS.rem.cols), err_msg=what)
        assert np.abs(_np(tS.rem.vals) - np.asarray(jS.rem.vals)).max() <= 1e-14 * sc, what
        rem_nnz = int((tS.rem.vals != 0).sum())
        assert (rem_nnz == 0) == (w1 == m3), f"{what}: {rem_nnz} remainder entries"
        ops = [tS] + ([tS.drop_empty_remainder()] if rem_nnz == 0 else [])
        for op in ops:
            assert np.abs(_np(op @ _t(v3)) - y3).max() <= 1e-14 * np.abs(y3).max(), f"{what}: inexact"
            np.testing.assert_allclose(_np(op.diagonal()), _np(tE3.diagonal()), rtol=1e-14)
        dd = rng.uniform(0.5, 2.0, nd3)
        np.testing.assert_allclose(_np(tS.with_added_diagonal(_t(dd)) @ _t(v3)), y3 + dd * v3,
                                   rtol=0, atol=1e-14 * np.abs(y3).max(), err_msg=what)
        carried = banded_split_3d_from_numpy(
            np.asarray(jS.G.data), jS.G.offsets3d, jS.G.shape3d, nd3,
            (np.asarray(jS.rem.vals), np.asarray(jS.rem.cols)), device="cpu")
        assert np.abs(_np(carried @ _t(v3)) - y3).max() <= 1e-14 * np.abs(y3).max(), f"{what}: interop"
        jF, tF = jS.fold_dirichlet(jnp.asarray(bnd3)), tS.fold_dirichlet(_t(bnd3))
        assert np.abs(_np(tF.G.data) - np.asarray(jF.G.data)).max() <= 1e-14 * sc, what
        assert tF.astype(torch.float32).G.data.dtype == torch.float32
        if rem_nnz == 0:
            jb = jds3.BandedMGPreconditioner3D.build(jF, dtype=jnp.float64, coarse_n=2)
            tb = tds3.BandedMGPreconditioner3D.build(tF, dtype=torch.float64, coarse_n=2)
            assert tb.mg.shapes == tuple(jb.mg.shapes) == (9, 5, 3), what
            zr = np.asarray(jax.jit(lambda b_, v_: b_(v_))(jb, jnp.asarray(v3)))
            assert np.abs(_np(tb(_t(v3))) - zr).max() <= 1e-12 * np.abs(zr).max(), f"{what}: V-cycle"
    assert bool(tds3.build_banded_split_3d(tE3, m3 + 1, m3 * (m3 + 1), max_rem=1)[1])
    p3, pinv3 = _scramble_ids(nd3, 256, 89)
    cs3, ns3, bs3 = p3[cells3].astype(np.int32), nodes3[pinv3], bnd3[pinv3]
    tsc = MatrixFreePoisson(_t(ns3), _t(cs3), _t(bs3), device="cpu")
    jsc = jms.ELLSoA(jnp.asarray(np.asarray(jE3.vals)[:, pinv3]),
                     jnp.asarray(p3[np.asarray(jE3.cols)[:, pinv3]].astype(np.int32)), jE3.shape)
    assert tds3.plan_split_3d(tsc.op) == jds3.plan_split_3d(jsc) == (None, None)
    assert tsc.preconditioner == "auxgrid", "the scrambled cube is not rejected"
    with pytest.raises(ValueError):
        MatrixFreePoisson(_t(ns3), _t(cs3), _t(bs3), preconditioner="banded_mg", device="cpu")

    # the 3D models against JAX at rtol 1e-12 (the lane path 1e-10):
    # iterations within 1, solutions to 1e-10 relative, load vectors to
    # 1e-14. MatrixFreePoisson "auto" (banded_mg) and "auxgrid";
    # MatrixFreeElliptic with JAX tests/test_matfree_general.py:346's
    # coefficients (BiCGStab) on the aux grid, and gather_kernel="lane"
    # with aux_kernel="lane" (a 3D aux grid, not a LaneAuxGrid, as in JAX)
    f3 = rng.standard_normal(C3)
    nodes3_t = mesh_from_numpy(nodes3, cells3, bnd3, device="cpu")
    assert nodes3_t[1].dtype == torch.int32 and nodes3_t[2].dtype == torch.bool
    nodes3_j = (jnp.asarray(nodes3), jnp.asarray(cells3), jnp.asarray(bnd3))
    gen3 = dict(K=(1.3, 0.2, -0.1, 0.9, 0.15, 1.1), b=(0.8, -0.4, 0.3), c=0.5, grid_n=n3)
    lane3 = dict(K=(1.3, 0.2, -0.1, 0.9, 0.15, 1.1), c=0.5, preconditioner="auxgrid",
                 gather_kernel="lane", aux_kernel="lane")
    for name, cls_j, cls_t, kw, route, rtol in (
        ("3D MatrixFreePoisson auto", JPoisson, MatrixFreePoisson, {}, "banded_mg", 1e-12),
        ("3D MatrixFreePoisson auxgrid", JPoisson, MatrixFreePoisson,
         dict(preconditioner="auxgrid"), "auxgrid", 1e-12),
        ("3D MatrixFreeElliptic auxgrid", JElliptic, MatrixFreeElliptic,
         dict(gen3, preconditioner="auxgrid"), "auxgrid", 1e-12),
        ("3D MatrixFreeElliptic lane", JElliptic, MatrixFreeElliptic, lane3, "auxgrid+lane", 1e-10),
    ):
        jm, tm = cls_j(*nodes3_j, **kw), cls_t(*nodes3_t, device="cpu", **kw)
        assert tm.preconditioner == jm.preconditioner == route, name
        assert tm.dim == jm.dim == 3, name
        if route == "banded_mg":
            assert tm.aux.mg.shapes == tuple(jm.aux.mg.shapes), name
        else:
            assert type(tm.aux).__name__ == type(jm.aux).__name__ == "AuxGridPreconditioner3D", name
            assert tm.aux.n_grid == jm.aux.n_grid, name
        compare(name, jm, tm, rtol, it_slack=1, sol_tol=1e-10, f=f3)

    # MatrixFreeParabolic in 3D (JAX :392) at dt = 0.01 over 3 steps on
    # both routes: iterations within 1, trajectories to 1e-10; the
    # aux-grid route without bbox takes the unit box (JAX passes None)
    u3 = np.sin(np.pi * nodes3[:, 0]) * np.sin(np.pi * nodes3[:, 1]) * np.sin(np.pi * nodes3[:, 2])
    for route, kw_t, kw_j in (("banded_mg", {}, {}),
                              ("auxgrid", dict(preconditioner="auxgrid"),
                               dict(preconditioner="auxgrid", bbox=((0.0,) * 3, (1.0,) * 3)))):
        jp = JParabolic(*nodes3_j, 0.01, **kw_j)
        tp = MatrixFreeParabolic(*nodes3_t, 0.01, device="cpu", **kw_t)
        assert tp.preconditioner == jp.preconditioner == route
        ju, jinfo = jp.solve(jnp.asarray(u3), n_steps=3, rtol=1e-12, maxiter=200)
        tu, tinfo = tp.solve(_t(u3), n_steps=3, rtol=1e-12, maxiter=200)
        assert all(abs(a - b) <= 1 for a, b in zip(tinfo["iterations"], jinfo["iterations"])), \
            (route, tinfo["iterations"], jinfo["iterations"])
        assert max(tinfo["rel_residuals"]) <= 1e-12, route
        assert np.abs(_np(tu) - np.asarray(ju)).max() <= 1e-10, route
