"""Port parity: the fused coords->stencil assembly (K1) of
fdapde_core_tpu_torch against the JAX package, on the same numpy inputs.

On the CPU the port's wrapper runs its plain PyTorch version and the JAX
function its non-TPU branch; the CUDA kernel itself is checked against the
plain version by the `cuda`-marked test (skipped without a card).
"""

import ast
import subprocess
import sys
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


def _check_k2_autograd_on_cpu():
    """K2's autograd Function (linear_algebra.sparse.SparseProduct) on CPU
    tensors: gradcheck and gradgradcheck in f64 on a rectangular matrix,
    with respect to the values and a vector or a block; the gradients equal
    the plain product's (matmul_reference) to 1e-13; a product with no
    input that requires grad is the plain launch, bit for bit; no launch is
    counted on the CPU."""
    from fdapde_core_tpu_torch.linear_algebra.sparse import SparseMatrix
    from fdapde_core_tpu_torch.ops import gather_spmv as gs

    rng = np.random.default_rng(4)
    a = np.where(rng.uniform(size=(9, 7)) < 0.4, rng.standard_normal((9, 7)), 0.0)
    A = SparseMatrix.from_dense(a, device="cpu")
    before = (gs.ell_spmv_launches, gs.ell_spmv_backward_launches)
    v = A.vals.clone().requires_grad_(True)
    for X in (torch.from_numpy(rng.standard_normal(7)), torch.from_numpy(rng.standard_normal((7, 3)))):
        X = X.requires_grad_(True)
        product = lambda vals, x: A.with_vals(vals) @ x  # noqa: E731
        assert torch.autograd.gradcheck(product, (v, X))
        assert torch.autograd.gradgradcheck(product, (v, X))
        G = torch.from_numpy(rng.standard_normal((9,) + tuple(X.shape[1:])))
        got = torch.autograd.grad(product(v, X), (v, X), G)
        ref = torch.autograd.grad(A.with_vals(v).matmul_reference(X), (v, X), G)
        for g, r in zip(got, ref):
            assert (g - r).abs().max() <= 1e-13 * r.abs().max()
        assert torch.equal(A @ X.detach(), A.sliced() @ X.detach())
    assert (gs.ell_spmv_launches, gs.ell_spmv_backward_launches) == before


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    """On CPU tensors the wrapper takes the plain version (no launch is
    counted) and still checks its arguments; so does K2's autograd
    Function (``_check_k2_autograd_on_cpu``)."""
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
    _check_k2_autograd_on_cpu()


def _f_np(x, m):
    """sin(x0) x1^2 + exp(x0 x1) in either framework's math module m."""
    return m.sin(x[0]) * x[1] ** 2 + m.exp(x[0] * x[1])


def _check_fields_match_jax():
    """fields: values, gradients and Hessians of ScalarField (auto mode to
    1e-12 of JAX's, FD mode to 1e-6 of the analytic ones and to 1e-9 of
    JAX's FD), the algebra, the unary wrappers, VectorField.dot and
    MatrixField products, at seeded points."""
    from fdapde_core_tpu import fields as jf
    from fdapde_core_tpu_torch import fields as tf

    rng = np.random.default_rng(6)
    for x in rng.uniform(-1.0, 1.0, size=(3, 2)):
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        fj, ft = jf.ScalarField(lambda p: _f_np(p, jnp)), tf.ScalarField(lambda p: _f_np(p, torch))
        gj, gt = (2.0 * fj - fj / (fj + 3.0)) * jf.sin(fj), (2.0 * ft - ft / (ft + 3.0)) * tf.sin(ft)
        for what, a, b in (("value", gj(xj), gt(xt)),
                           ("grad", fj.derive()(xj), ft.derive()(xt)),
                           ("hessian", fj.derive_twice()(xj), ft.derive_twice()(xt)),
                           ("composed grad", gj.derive()(xj), gt.derive()(xt))):
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-12 * max(1.0, np.abs(a).max()), what
        exact = np.asarray(fj.derive()(xj))
        for what, a, b in (("fd grad", fj.derive(mode="fd")(xj), ft.derive(mode="fd")(xt)),
                           ("fd hessian", fj.derive_twice(mode="fd")(xj), ft.derive_twice(mode="fd")(xt))):
            # the quotients amplify torch's and XLA's one-ulp differences in
            # sin/exp by up to 16 / (12 h^2) ~ 1.3e6
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-9, what
        assert np.abs(ft.derive(mode="fd")(xt).numpy() - exact).max() <= 1e-6
        hexact = np.asarray(fj.derive_twice()(xj))
        assert np.abs(ft.derive_twice(mode="fd")(xt).numpy() - hexact).max() <= 1e-6
    vt = tf.VectorField([lambda p: p[0], lambda p: p[1]])
    assert float(vt.dot(torch.tensor([2.0, 3.0]))(torch.tensor([1.0, 1.0]))) == 5.0
    assert float(vt.dot(vt)(torch.tensor([3.0, 4.0]))) == 25.0
    K = tf.MatrixField([[lambda p: p[0], lambda p: 0.0], [lambda p: 0.0, lambda p: p[1]]])
    p = torch.tensor([2.0, 5.0], dtype=torch.float64)
    np.testing.assert_array_equal((K @ K)(p).numpy(), [[4.0, 0.0], [0.0, 25.0]])
    np.testing.assert_array_equal(K.matvec(torch.ones(2, dtype=torch.float64))(p).numpy(), [2.0, 5.0])
    H = tf.TwiceDifferentiableScalarField(lambda p: p[0], lambda p: p, lambda p: torch.eye(2) * 7.0)
    assert float(H.derive_twice()(p)[1, 1]) == 7.0 and float(H.derive()(p)[1]) == 5.0
    if not torch.cuda.is_available():  # a point that is not a tensor goes to the card: no fallback
        with pytest.raises((AssertionError, RuntimeError)):
            ft([1.0, 2.0])


def _check_optimizers_match_jax():
    """optimization: JAX's tests/test_optimization.py on both packages, the
    port's x to 1e-8 of JAX's (grid search: the same point), iterations
    equal where the test pins them."""
    from fdapde_core_tpu import optimization as jo
    from fdapde_core_tpu_torch import optimization as to

    def quadratic(x):
        return (x[0] - 1.0) ** 2 + 4.0 * (x[1] + 2.0) ** 2

    def rosenbrock(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    xs = np.linspace(-2, 2, 41)
    grid = np.stack(np.meshgrid(xs, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    cases = (
        ("grid", lambda m, a: m.grid_search(quadratic, a(grid))),
        ("gd backtracking", lambda m, a: m.gradient_descent(
            quadratic, a([5.0, 5.0]), step=1.0, tol=1e-8, max_iter=2000, line_search="backtracking")),
        ("newton quadratic", lambda m, a: m.newton(quadratic, a([8.0, -5.0]))),
        ("newton rosenbrock", lambda m, a: m.newton(rosenbrock, a([-1.2, 1.0]), max_iter=100, tol=1e-10)),
        ("bfgs wolfe", lambda m, a: m.bfgs(rosenbrock, a([-1.2, 1.0]), tol=1e-8, max_iter=500,
                                           line_search="wolfe")),
        ("bfgs backtracking", lambda m, a: m.bfgs(quadratic, a([8.0, -5.0]), line_search="backtracking")),
        ("custom line search", lambda m, a: m.gradient_descent(
            quadratic, a([5.0, 5.0]), tol=1e-10, max_iter=200, line_search=lambda f, g, x, p, s: 0.1)),
    )
    for name, run in cases:
        rj = run(jo, lambda v: jnp.asarray(v, jnp.float64))
        rt = run(to, lambda v: torch.tensor(v, dtype=torch.float64))
        assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() <= 1e-8, name
        if name in ("grid", "newton quadratic"):
            assert rt.n_iter == int(rj.n_iter), name
    if not torch.cuda.is_available():  # a point that is not a tensor goes to the card: no fallback
        for run in (lambda: to.newton(quadratic, [1.0, 1.0]), lambda: to.grid_search(quadratic, grid)):
            with pytest.raises((AssertionError, RuntimeError)):
                run()


def _check_host_input_goes_to_the_operators_device():
    """Host input (NumPy) at five entry points: MatrixFreeParabolic.solve,
    banded_cg and AMG.v_cycle put it on the operator's device, so a CPU
    operator given NumPy equals the same call given a CPU tensor (bitwise);
    dense_solve and lump put a host matrix on the card, so without one they
    raise rather than compute on the host. On CPU tensors dense_solve and
    lump match JAX's (1e-12 relative; JAX's Gauss-Jordan and row sums)."""
    from fdapde_core_tpu.linear_algebra.lumping import lump as j_lump
    from fdapde_core_tpu.linear_algebra.solvers import dense_solve as j_dense_solve
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device
    from fdapde_core_tpu_torch.linear_algebra import AMG, SparseMatrix, dense_solve, lump
    from fdapde_core_tpu_torch.models import MatrixFreeParabolic, MatrixFreePoisson
    from fdapde_core_tpu_torch.ops.dia_split import banded_cg

    rng = np.random.default_rng(12)
    nodes, cells, bnd = irregular_mesh_device(8, 0.2, device="cpu")
    u0 = rng.uniform(size=nodes.shape[0])
    heat = MatrixFreeParabolic(nodes, cells, bnd, dt=1e-3, device="cpu")
    host, tensor = (heat.solve(u, n_steps=2, rtol=1e-10) for u in (u0, torch.from_numpy(u0)))
    assert torch.equal(host[0], tensor[0]) and host[1] == tensor[1], "MatrixFreeParabolic.solve"
    folded = MatrixFreePoisson(nodes, cells, bnd, device="cpu").op.fold_dirichlet(bnd)
    b = np.where(bnd.numpy(), 0.0, rng.uniform(0.5, 1.5, nodes.shape[0]))
    got, ref = banded_cg(folded, b, 10), banded_cg(folded, torch.from_numpy(b), 10)
    assert all(torch.equal(g, r) for g, r in zip(got, ref)), "banded_cg"
    n = 120
    d = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    mg = AMG.build(SparseMatrix.from_dense(d, device="cpu"), coarse_max=20)
    r = rng.standard_normal(n)
    assert mg.n_levels >= 2 and torch.equal(mg.v_cycle(r), mg.v_cycle(torch.from_numpy(r)))
    sym = d + np.diag(rng.uniform(0.5, 1.0, n))
    rhs = rng.standard_normal((n, 2))
    x = dense_solve(torch.from_numpy(sym), torch.from_numpy(rhs)).numpy()
    xj = np.asarray(j_dense_solve(jnp.asarray(sym), jnp.asarray(rhs)))
    assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max(), "dense_solve"
    np.testing.assert_allclose(lump(torch.from_numpy(sym)).numpy(),
                               np.asarray(j_lump(jnp.asarray(sym))), rtol=1e-12, atol=0)
    if not torch.cuda.is_available():  # a host matrix goes to the card: no fallback
        for run in (lambda: dense_solve(sym, rhs), lambda: lump(sym)):
            with pytest.raises((AssertionError, RuntimeError)):
                run()
    _check_host_input_goes_to_the_card()


def _check_host_input_goes_to_the_card():
    """Five more entry points where JAX calls jnp.asarray: SparseMatrix.
    from_coo and dia_from_coo (host vals), smw_solve (host U, V, invC),
    the dense kron and MatrixFreeLocal.build (host A_loc). A tensor keeps
    its device, so CPU tensors give CPU results equal to JAX's (1e-12
    relative); a host operand beside a tensor takes the tensor's device;
    host input alone goes to the card, so without one these raise rather
    than compute on the host."""
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo as j_dia_from_coo
    from fdapde_core_tpu.linear_algebra.sparse import SparseMatrix as JSparse
    from fdapde_core_tpu_torch.linear_algebra import SparseMatrix, kron, smw_solve
    from fdapde_core_tpu_torch.linear_algebra.dia import dia_from_coo
    from fdapde_core_tpu_torch.linear_algebra.solvers import dense_solve
    from fdapde_core_tpu_torch.ops.matfree import MatrixFreeLocal

    rng = np.random.default_rng(13)
    n = 40
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n), np.arange(n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1), np.arange(n)])
    vals = rng.uniform(0.5, 1.5, rows.size)
    S = SparseMatrix.from_coo(rows, cols, torch.from_numpy(vals), (n, n))
    Sj = JSparse.from_coo(rows, cols, jnp.asarray(vals), (n, n))
    assert S.vals.device.type == "cpu" and np.abs(S.vals.numpy() - np.asarray(Sj.vals)).max() <= \
        1e-12 * np.abs(np.asarray(Sj.vals)).max()
    D = dia_from_coo(rows, cols, torch.from_numpy(vals), n, (-1, 0, 1))
    Dj = j_dia_from_coo(rows, cols, jnp.asarray(vals), n, (-1, 0, 1))
    assert D.data.device.type == "cpu"
    np.testing.assert_allclose(D.data.numpy(), np.asarray(Dj.data), rtol=1e-12, atol=0)
    A = torch.from_numpy(np.diag(rng.uniform(2.0, 3.0, n)))
    U, V, b = rng.standard_normal((n, 2)), rng.standard_normal((2, n)), rng.standard_normal(n)
    x = smw_solve(lambda r: dense_solve(A, r), U, np.eye(2), torch.from_numpy(V),
                  torch.from_numpy(b))  # host U and invC beside a CPU V: the CPU
    ref = np.linalg.solve(A.numpy() + U @ V, b)
    assert x.device.type == "cpu" and np.abs(x.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    a, c = rng.standard_normal((3, 2)), rng.standard_normal((2, 4))
    K = kron(torch.from_numpy(a), c)  # a host operand beside a CPU tensor: the CPU
    assert K.device.type == "cpu"
    np.testing.assert_allclose(K.numpy(), np.asarray(jnp.kron(a, c)), rtol=1e-12, atol=0)
    A_loc = rng.standard_normal((4, 3, 3))
    dofs = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 5]], dtype=np.int32)
    op, _ = MatrixFreeLocal.build(torch.from_numpy(A_loc), dofs, 6, 4)
    assert op.A_loc.device.type == op.dofs.device.type == op.adj.device.type == "cpu"
    if not torch.cuda.is_available():  # host input alone goes to the card: no fallback
        for run in (lambda: SparseMatrix.from_coo(rows, cols, vals, (n, n)),
                    lambda: dia_from_coo(rows, cols, vals, n, (-1, 0, 1)),
                    lambda: smw_solve(lambda r: r, U, np.eye(2), V, b),
                    lambda: kron(a, c),
                    lambda: MatrixFreeLocal.build(A_loc, dofs, 6, 4)):
            with pytest.raises((AssertionError, RuntimeError)):
                run()


def test_closed_form_matches_jax():
    """The closed forms (2D and tet), and the host-side analytic layers
    beside them: fields (``_check_fields_match_jax``), the optimizers
    (``_check_optimizers_match_jax``) and host input at ten entry points
    (``_check_host_input_goes_to_the_operators_device``,
    ``_check_host_input_goes_to_the_card``)."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(6, 50))
    ref = np.asarray(jcf.p1_stiffness_2d_sym(jnp.asarray(coords)))
    got = tcf.p1_stiffness_2d_sym(torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert tcf.SYM_TO_FULL == jcf.SYM_TO_FULL

    # the tet form, from the edge vectors of random positive tets, to 1e-13
    # of the largest entry; pack_cell_axis reshapes alike
    p = rng.uniform(size=(4, 3, 256))
    edges = np.concatenate([p[1] - p[0], p[2] - p[0], p[3] - p[0]])
    ref = np.asarray(jcf.p1_stiffness_3d_sym(jnp.asarray(edges)))
    got = tcf.p1_stiffness_3d_sym(torch.from_numpy(edges)).numpy()
    assert got.shape == ref.shape == (10, 256)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max(), "p1_stiffness_3d_sym"
    assert tcf.SYM4_TO_FULL == jcf.SYM4_TO_FULL
    packed = tcf.pack_cell_axis(torch.from_numpy(edges))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jcf.pack_cell_axis(jnp.asarray(edges))))
    with pytest.raises(ValueError):
        tcf.pack_cell_axis(torch.zeros(9, 100))
    _check_fields_match_jax()
    _check_optimizers_match_jax()
    _check_host_input_goes_to_the_operators_device()


def test_port_never_imports_jax():
    """No module of the port imports jax (an AST scan of every .py file,
    the modules of the device-scale P2, lane aux grid and refinement paths,
    and the solver-breadth modules: fields, optimization, Neumann data,
    the semilinear solver, FSPAI, block and binary matrices, integration
    and the native library; the geometry host copies, io, checkpoints,
    profiling and sanitize; the multi-device layer, among them). Only
    parallel/comm.py imports torch.distributed."""
    offenders, scanned, distributed = [], set(), set()
    for path in sorted(PORT.rglob("*.py")):
        if "_build" in path.relative_to(PORT).parts:  # build outputs, not source
            continue
        scanned.add(path.relative_to(PORT).as_posix())
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if any(nm.startswith("torch.distributed") for nm in names):
                distributed.add(path.relative_to(PORT).as_posix())
            if any(nm == "jax" or nm.startswith(("jax.", "jaxlib", "fdapde_core_tpu."))
                   or nm == "fdapde_core_tpu" for nm in names):
                offenders.append(f"{path.relative_to(PORT)}:{node.lineno}")
    assert not offenders, offenders
    assert {"ops/matfree_soa.py", "ops/lane_aux.py", "geometry/refine_device.py",
            "models/matfree.py", "fields/fields.py", "fields/__init__.py",
            "optimization/optimizers.py", "optimization/__init__.py", "fem/neumann.py",
            "fem/nonlinear.py", "linear_algebra/fspai.py", "linear_algebra/block.py",
            "linear_algebra/binary.py", "native/__init__.py", "native/build.py",
            "native/topology.py", "utils/integration.py", "geometry/network.py",
            "geometry/kd_tree.py", "geometry/projection.py", "geometry/voronoi.py",
            "geometry/hyperplane.py", "geometry/simplex.py", "geometry/walk_search.py",
            "utils/io.py", "utils/checkpoint.py", "utils/binary_tree.py", "utils/block_frame.py",
            "utils/shp_reader.py", "utils/profiling.py", "utils/sanitize.py", "parallel/comm.py",
            "parallel/cg.py", "parallel/sharded.py", "parallel/halo.py", "parallel/halo_ell.py",
            "parallel/halo_lane.py", "parallel/halo_grid.py", "parallel/mg.py",
            "parallel/banded.py", "parallel/space_time.py", "parallel/partition.py",
            "parallel/reorder.py", "parallel/dryrun.py", "models/sharded_driver.py",
            "ops/window_spmv.py"} <= scanned
    assert not [p for p in distributed if p != "parallel/comm.py"], distributed
    # and at run time: importing the new modules loads neither package
    code = ("import sys\n"
            "import fdapde_core_tpu_torch.fields, fdapde_core_tpu_torch.optimization\n"
            "import fdapde_core_tpu_torch.fem.neumann, fdapde_core_tpu_torch.fem.nonlinear\n"
            "import fdapde_core_tpu_torch.linear_algebra.fspai, fdapde_core_tpu_torch.native\n"
            "import fdapde_core_tpu_torch.geometry.walk_search, fdapde_core_tpu_torch.geometry.simplex\n"
            "from fdapde_core_tpu_torch.utils import checkpoint, io, profiling, sanitize\n"
            "from fdapde_core_tpu_torch.utils import binary_tree, block_frame, shp_reader\n"
            "import fdapde_core_tpu_torch.parallel.dryrun, fdapde_core_tpu_torch.ops.window_spmv\n"
            "import fdapde_core_tpu_torch.models.sharded_driver\n"
            "assert not {'jax', 'fdapde_core_tpu'} & set(sys.modules), sorted(sys.modules)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernels K1-K7 == their plain versions on the card, bitwise
    stable from run to run. K1, K3-K6: perturbed geometry, junk-padded
    planes, n not a multiple of 128, cell counts not a multiple of the
    block, f32 and f64 (tolerance 8 eps max|out|: nvcc contracts products
    into FMAs). K2 (float32, float64 and bfloat16 values, float32 values
    on a float64 x, a rectangular operator; the square tables also with
    their warp widths, bitwise the launch without; its sliced form in f32
    and f64 at sigma 1 and 256 on a
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
    cases = [(vals, cols, nd, dt, gs.accumulation_dtype(dt))
             for dt in (torch.float32, torch.float64, torch.bfloat16)]
    cases.append((vals, cols, nd, torch.float32, torch.float64))
    rcols = rng.integers(0, nd + 333, size=(5, nd - 77)).astype(np.int32)
    cases.append((rng.standard_normal((5, nd - 77)), rcols, nd + 333, torch.float32, torch.float32))
    for v_np, c_np, n_src, dt, acc in cases:
        V = torch.from_numpy(np.ascontiguousarray(v_np)).to("cuda", dt)
        Cc = torch.from_numpy(np.ascontiguousarray(c_np)).cuda()
        x = torch.from_numpy(rng.standard_normal(n_src)).to("cuda", acc)
        before = gs.ell_spmv_launches
        got = gs.ell_spmv(V, Cc, x)
        torch.cuda.synchronize()
        assert gs.ell_spmv_launches == before + 1
        ref = gs.ell_spmv_reference(V, Cc, x)
        bound = V.shape[0] * torch.finfo(acc).eps * gs.ell_spmv_reference(V.abs(), Cc, x.abs())
        assert bool(((got - ref).abs() <= bound).all()), f"K2 {dt} x {acc} n_src={n_src}"
        assert torch.equal(got, gs.ell_spmv(V, Cc, x)), "K2 is not bitwise stable"
        if n_src == V.shape[1]:  # the square FEM table: with its warp widths
            W = gs.ell_warp_widths(Cc)
            assert torch.equal(gs.ell_spmv(V, Cc, x, W), got), f"K2 {dt} x {acc} warp widths"
            torch.cuda.synchronize()
            assert gs.ell_spmv_launches == before + 3
        if acc != gs.accumulation_dtype(dt):  # widened per product
            assert torch.equal(got, gs.ell_spmv(V.to(acc), Cc, x)), "K2 float32 values, float64 x"
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
