"""Port parity: the fused coords->stencil assembly (K1) of
fdapde_core_tpu_torch against the JAX package, on the same numpy inputs.

On the CPU the port's wrapper runs its plain PyTorch version and the JAX
function its non-TPU branch; the CUDA kernel itself is checked against the
plain version by the `cuda`-marked test (skipped without a card).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdapde_core_tpu  # noqa: F401  (enables x64 for the f64 cases)
from fdapde_core_tpu.ops import closed_form as jcf
from fdapde_core_tpu.ops.grid_assembly import stencil_from_coords as j_stencil_from_coords
from fdapde_core_tpu.ops.grid_dia import prune_zero_offsets_grid as j_prune
from fdapde_core_tpu.ops.pallas_assembly import (
    p1_offdiag_planes_from_coords as j_offdiag_planes,
)
from fdapde_core_tpu.ops.pallas_assembly import (
    p1_stencil_layers_from_coords as j_layers,
)
from fdapde_core_tpu_torch.ops import assembly_kernels as ak
from fdapde_core_tpu_torch.ops import closed_form as tcf
from fdapde_core_tpu_torch.ops.grid_assembly import (
    GRID_OFFSETS2D,
    stencil_from_coords,
)
from fdapde_core_tpu_torch.ops.grid_dia import prune_zero_offsets_grid

PORT = Path(__file__).resolve().parent.parent / "fdapde_core_tpu_torch"


def _planes(n, perturbed, seed=9, W=128, junk=7.0):
    """Junk-padded coordinate planes (n+8, W): node (i, j) at row i, lane j;
    interior nodes jittered by +-0.12 h when perturbed."""
    m = n + 1
    rng = np.random.default_rng(seed)
    gi, gj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    nodes = np.stack([gi, gj], axis=-1).astype(np.float64)
    if perturbed:
        interior = (gi > 0) & (gi < n) & (gj > 0) & (gj < n)
        nodes[interior] += rng.uniform(-0.12, 0.12, size=(interior.sum(), 2))
    nodes /= n
    X = np.full((n + 8, W), junk)
    Y = np.full((n + 8, W), junk)
    X[:m, :m] = nodes[..., 0]
    Y[:m, :m] = nodes[..., 1]
    return X, Y


def _tol(dtype, ref):
    """f64: 1e-12 absolute. f32: 8 eps32 max|L| (the two frameworks round
    the same formulas in different fused orders)."""
    if dtype == np.float64:
        return 1e-12
    return 8 * np.finfo(np.float32).eps * np.abs(ref).max()


def test_stencil_layers_match_jax():
    """Plain version and CPU wrapper == JAX p1_stencil_layers_from_coords,
    padded layout, element for element, in f64 and f32."""
    for dtype in (np.float64, np.float32):
        for perturbed in (False, True):
            for n in (8, 16, 37):
                case = f"{dtype.__name__} n={n} perturbed={perturbed}"
                X, Y = _planes(n, perturbed)
                X, Y = X.astype(dtype), Y.astype(dtype)
                ref = np.asarray(j_layers(jnp.asarray(X), jnp.asarray(Y), n))
                tX, tY = torch.from_numpy(X), torch.from_numpy(Y)
                plain = ak.p1_stencil_layers_from_coords_reference(tX, tY, n).numpy()
                wrapped = ak.p1_stencil_layers_from_coords(tX, tY, n).numpy()
                assert plain.shape == ref.shape == (7, n + 16, 128), case
                atol = _tol(dtype, ref)
                np.testing.assert_allclose(plain, ref, rtol=0, atol=atol, err_msg=case)
                np.testing.assert_array_equal(wrapped, plain, err_msg=case)
                if perturbed:  # the anti-diagonal layers are live here
                    assert np.abs(ref[GRID_OFFSETS2D.index((-1, 1))]).max() > 1e-3, case


def test_stencil_from_coords_matches_jax():
    """stencil_from_coords: compact (7, m, m) layers, and the same offsets
    survive prune_zero_offsets_grid (5 on the uniform grid, 7 perturbed)."""
    n = 16
    for perturbed, n_kept in ((False, 5), (True, 7)):
        X, Y = _planes(n, perturbed)
        Gj = j_stencil_from_coords(jnp.asarray(X), jnp.asarray(Y), n)
        Gt = stencil_from_coords(torch.from_numpy(X), torch.from_numpy(Y), n)
        assert Gt.offsets2d == Gj.offsets2d and Gt.shape2d == Gj.shape2d
        assert Gt.data.is_contiguous() and Gt.data.shape == (7, n + 1, n + 1)
        np.testing.assert_allclose(Gt.data.numpy(), np.asarray(Gj.data), rtol=0, atol=1e-12)
        Pj, Pt = j_prune(Gj), prune_zero_offsets_grid(Gt)
        assert Pt.offsets2d == Pj.offsets2d and len(Pt.offsets2d) == n_kept
        np.testing.assert_allclose(Pt.data.numpy(), np.asarray(Pj.data), rtol=0, atol=1e-12)


def test_stencil_oracles_agree_with_fused_path():
    """The plain-torch oracles reach the fused path's operator another way:
    closed-form local stiffness + slice-add scatter (full and off-diagonal
    packings), and quad-grid off-diagonal planes (K3) + pad-sum conversion.
    The slice-add scatter also matches JAX's on the same local matrices, and
    K3's plain version JAX's p1_offdiag_planes_from_coords (n = 16 and 257,
    f32 and f64, junk-padded planes)."""
    from fdapde_core_tpu.ops.grid_assembly import p1_grid_stencil as j_p1_grid_stencil
    from fdapde_core_tpu_torch.ops.grid_assembly import (
        p1_grid_stencil,
        p1_grid_stencil_offdiag,
        stencil_from_offdiag_planes,
    )

    n = 16
    m = n + 1
    X, Y = (torch.from_numpy(a) for a in _planes(n, True))
    fused = stencil_from_coords(X, Y, n).data

    i, j = np.divmod(np.arange(n * n), n)
    a = i * m + j
    b = a + m
    cells = np.concatenate([np.stack([a, b, a + 1], 1), np.stack([b, b + 1, a + 1], 1)])
    nodes = torch.stack([X[:m, :m].reshape(-1), Y[:m, :m].reshape(-1)], 1)
    corners = nodes[torch.from_numpy(cells)]  # (2 n^2, 3, 2)
    coords = corners.reshape(-1, 6).T  # rows x1, y1, x2, y2, x3, y3
    A6 = tcf.p1_stiffness_2d_sym(coords)
    full = p1_grid_stencil(A6, n)
    offdiag = p1_grid_stencil_offdiag(A6[[1, 2, 4]], n)
    before = ak.p1_offdiag_planes_launches
    pad_sum = stencil_from_offdiag_planes(ak.p1_offdiag_planes_from_coords(X, Y, n), n)
    for G in (full, offdiag, pad_sum):
        assert G.offsets2d == GRID_OFFSETS2D
        np.testing.assert_allclose(G.data.numpy(), fused.numpy(), rtol=0, atol=1e-12)
    ref = np.asarray(j_p1_grid_stencil(jnp.asarray(A6.numpy()), n).data)
    np.testing.assert_allclose(full.data.numpy(), ref, rtol=0, atol=1e-12)

    # K3's plain version == JAX's p1_offdiag_planes_from_coords on
    # junk-padded planes; the CPU wrapper takes it and launches nothing
    for dtype in (np.float64, np.float32):
        for n in (16, 257):
            case = f"K3 {dtype.__name__} n={n}"
            Xn, Yn = (a.astype(dtype) for a in _planes(n, True, W=-(-(n + 1) // 128) * 128))
            ref = np.asarray(j_offdiag_planes(jnp.asarray(Xn), jnp.asarray(Yn), n))
            tX, tY = torch.from_numpy(Xn), torch.from_numpy(Yn)
            plain = ak.p1_offdiag_planes_from_coords_reference(tX, tY, n)
            assert plain.shape == ref.shape == (6, n, n) and plain.is_contiguous(), case
            np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=_tol(dtype, ref), err_msg=case)
            assert torch.equal(ak.p1_offdiag_planes_from_coords(tX, tY, n), plain), case
    assert ak.p1_offdiag_planes_launches == before
    with pytest.raises(ValueError):  # too few rows for n
        ak.p1_offdiag_planes_from_coords(tX[:n], tY[:n], n)


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    """On CPU tensors the wrapper takes the plain version (no launch is
    counted) and still checks its arguments."""
    n = 8
    X, Y = (torch.from_numpy(a) for a in _planes(n, True))
    before = ak.p1_stencil_launches
    out = torch.empty((7, n + 1, n + 1), dtype=torch.float64)
    ak.p1_stencil_layers_into(X, Y, n, out)
    assert ak.p1_stencil_launches == before
    ref = ak.p1_stencil_layers_from_coords_reference(X, Y, n)[:, 7:7 + n + 1, :n + 1]
    assert torch.equal(out, ref)
    with pytest.raises(TypeError):
        ak.p1_stencil_layers_into(X.to(torch.int64), Y, n, out)
    with pytest.raises(ValueError):  # too few columns for n
        ak.p1_stencil_layers_into(X[:, :n], Y[:, :n], n, out)
    with pytest.raises(ValueError):  # non-unit column stride
        ak.p1_stencil_layers_into(X.t(), Y.t(), n, out)
    with pytest.raises(ValueError):  # wrong output shape
        ak.p1_stencil_layers_into(X, Y, n, out[:, :n])


def test_closed_form_matches_jax():
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(6, 50))
    ref = np.asarray(jcf.p1_stiffness_2d_sym(jnp.asarray(coords)))
    got = tcf.p1_stiffness_2d_sym(torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert tcf.SYM_TO_FULL == jcf.SYM_TO_FULL


def test_port_never_imports_jax():
    """No module of the port imports jax (an AST scan of every .py file)."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        if "_build" in path.relative_to(PORT).parts:  # build outputs, not source
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if any(nm == "jax" or nm.startswith(("jax.", "jaxlib", "fdapde_core_tpu."))
                   or nm == "fdapde_core_tpu" for nm in names):
                offenders.append(f"{path.relative_to(PORT)}:{node.lineno}")
    assert not offenders, offenders


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernels K1-K7 == their plain versions on the card, bitwise
    stable from run to run. K1, K3-K6: perturbed geometry, junk-padded
    planes, n not a multiple of 128, cell counts not a multiple of the
    block, f32 and f64 (tolerance 8 eps max|out|: nvcc contracts products
    into FMAs). K2 (float32, float64 and bfloat16 values, a rectangular
    operator; its sliced form in f32 and f64 at sigma 1 and 256 on a
    skewed table, vectors and strided blocks, each block column bitwise
    its vector product) and K7 (f32 and f64, offsets past either end, n
    not a multiple of the block): per-row bound K eps(acc) sum_k |a x|."""
    from fdapde_core_tpu_torch.ops import dia_spmv as ds
    from fdapde_core_tpu_torch.ops import gather_spmv as gs
    from fdapde_core_tpu_torch.ops import local_stiffness as ls

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from test_torch_matfree import _scrambled_fem_ell

    vals, cols, nd = _scrambled_fem_ell()
    rng = np.random.default_rng(2)
    cases = [(vals, cols, nd, dt) for dt in (torch.float32, torch.float64, torch.bfloat16)]
    rcols = rng.integers(0, nd + 333, size=(5, nd - 77)).astype(np.int32)
    cases.append((rng.standard_normal((5, nd - 77)), rcols, nd + 333, torch.float32))
    for v_np, c_np, n_src, dt in cases:
        V = torch.from_numpy(np.ascontiguousarray(v_np)).to("cuda", dt)
        Cc = torch.from_numpy(np.ascontiguousarray(c_np)).cuda()
        acc = gs.accumulation_dtype(dt)
        x = torch.from_numpy(rng.standard_normal(n_src)).to("cuda", acc)
        before = gs.ell_spmv_launches
        got = gs.ell_spmv(V, Cc, x)
        torch.cuda.synchronize()
        assert gs.ell_spmv_launches == before + 1
        ref = gs.ell_spmv_reference(V, Cc, x)
        bound = V.shape[0] * torch.finfo(acc).eps * gs.ell_spmv_reference(V.abs(), Cc, x.abs())
        assert bool(((got - ref).abs() <= bound).all()), f"K2 {dt} n_src={n_src}"
        assert torch.equal(got, gs.ell_spmv(V, Cc, x)), "K2 is not bitwise stable"
    # K2's sliced form: a skewed table (row lengths 0-40, n not a multiple
    # of the slice), vector and block products, the block as a transposed
    # view and row-major 9 wide (rows mapping) and row-major 70 wide
    # (columns mapping)
    n_t, n_src_t = 3001, 5003
    lens = np.minimum(rng.geometric(0.1, n_t) - 1, 40)
    t_rows = torch.from_numpy(np.repeat(np.arange(n_t), lens))
    t_cols = torch.from_numpy(np.concatenate(
        [np.sort(rng.choice(n_src_t, L, replace=False)) for L in lens]))
    t_vals = torch.from_numpy(rng.standard_normal(t_rows.shape[0]))
    for dt in (torch.float32, torch.float64):
        for sigma in (1, 256):
            A = gs.SlicedELL.from_coo(t_rows.cuda(), t_cols.cuda(), t_vals.to("cuda", dt),
                                      (n_t, n_src_t), sigma=sigma)
            U = torch.from_numpy(rng.standard_normal((70, n_src_t))).to("cuda", dt)
            for X in (U[0], U[:9].T, U[:9].T.contiguous(), U.T.contiguous()):
                before = gs.ell_spmv_launches
                got = A @ X
                torch.cuda.synchronize()
                assert gs.ell_spmv_launches == before + 1
                ref = gs.sliced_ell_spmm_reference(A, X)
                absA = A.with_vals(A.vals.abs()[A.dest])
                bound = A.width * torch.finfo(dt).eps * gs.sliced_ell_spmm_reference(absA, X.abs())
                where = f"sliced K2 {dt} sigma={sigma} X {tuple(X.shape)} {X.stride()}"
                assert bool(((got - ref).abs() <= bound).all()), where
                assert torch.equal(got, A @ X), f"{where}: not bitwise stable"
                if X.dim() == 2:
                    cols = torch.stack([A @ X[:, j].contiguous() for j in range(X.shape[1])], 1)
                    assert torch.equal(got, cols), f"{where}: a column differs from its vector"
    for dtype in (torch.float32, torch.float64):
        for n, offsets in ((1, (0,)), (70001, (-70001, -258, -1, 0, 1, 258, 1300, 70005))):
            data = torch.from_numpy(rng.standard_normal((len(offsets), n))).to("cuda", dtype)
            x = torch.from_numpy(rng.standard_normal(n)).to("cuda", dtype)
            before = ds.dia_spmv_launches
            got = ds.dia_spmv(data, offsets, x)
            torch.cuda.synchronize()
            assert ds.dia_spmv_launches == before + 1
            ref = ds.dia_spmv_reference(data, offsets, x)
            bound = len(offsets) * torch.finfo(dtype).eps * ds.dia_spmv_reference(
                data.abs(), offsets, x.abs())
            assert bool(((got - ref).abs() <= bound).all()), f"K7 {dtype} n={n}"
            assert torch.equal(got, ds.dia_spmv(data, offsets, x)), "K7 is not bitwise stable"
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.float64):
        for C in (1, 777, 70001):
            p = rng.uniform(size=(C, 3, 2))
            coords = torch.from_numpy(p.reshape(C, 6).T.copy()).to("cuda", dtype)
            edges = torch.from_numpy(np.stack([p[:, 1, 0] - p[:, 0, 0], p[:, 1, 1] - p[:, 0, 1],
                                               p[:, 2, 0] - p[:, 0, 0], p[:, 2, 1] - p[:, 0, 1]]))
            edges = edges.to("cuda", dtype)
            for name, kernel, plain, inp in (
                ("K6", ls.p1_stiffness_2d, ls.p1_stiffness_2d_reference, coords),
                ("K4", ls.p1_stiffness_edges, ls.p1_stiffness_edges_reference, edges),
                ("K5", ls.p1_stiffness_edges_offdiag, ls.p1_stiffness_edges_offdiag_reference, edges),
            ):
                counter = {"K6": "p1_stiffness_2d_launches", "K4": "p1_stiffness_edges_launches",
                           "K5": "p1_stiffness_edges_offdiag_launches"}[name]
                before = getattr(ls, counter)
                got = kernel(inp)
                torch.cuda.synchronize()
                assert getattr(ls, counter) == before + 1, name
                ref = plain(inp)
                tol = 8 * torch.finfo(dtype).eps * ref.abs().max().item()
                assert (got - ref).abs().max().item() <= tol, f"{name} {dtype} C={C}"
                assert torch.equal(got, kernel(inp)), f"{name} is not bitwise stable"
    for dtype in (torch.float32, torch.float64):
        for n in (8, 37, 257):
            X, Y = _planes(n, True, W=-(-(n + 1) // 128) * 128)
            tX = torch.from_numpy(X).to("cuda", dtype)
            tY = torch.from_numpy(Y).to("cuda", dtype)
            before = ak.p1_stencil_launches
            got = ak.p1_stencil_layers_from_coords(tX, tY, n)
            torch.cuda.synchronize()
            assert ak.p1_stencil_launches == before + 1
            ref = ak.p1_stencil_layers_from_coords_reference(tX, tY, n)
            tol = 8 * torch.finfo(dtype).eps * ref.abs().max().item()
            assert (got - ref).abs().max().item() <= tol
            again = ak.p1_stencil_layers_from_coords(tX, tY, n)
            assert torch.equal(got, again)  # no atomics: bitwise stable
            before = ak.p1_offdiag_planes_launches
            got = ak.p1_offdiag_planes_from_coords(tX, tY, n)
            torch.cuda.synchronize()
            assert ak.p1_offdiag_planes_launches == before + 1
            ref = ak.p1_offdiag_planes_from_coords_reference(tX, tY, n)
            tol = 8 * torch.finfo(dtype).eps * ref.abs().max().item()
            assert (got - ref).abs().max().item() <= tol, f"K3 {dtype} n={n}"
            assert torch.equal(got, ak.p1_offdiag_planes_from_coords(tX, tY, n))
