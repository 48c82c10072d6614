"""Separable space-time operators: sums of Kronecker products, matrix-free.

Port of ``fdapde_core_tpu/models/space_time.py``. The reference provides
the Kronecker building block (linear_algebra/kronecker_product.h) that
downstream fdaPDE space-time models combine into penalties like
R = T1 (x) S0 + T0 (x) S1 (spline penalty in time, FEM matrices in space).
The operator stays a sum of Kronecker factors and every matvec is two
products per term (vec identity: (A (x) B) vec(X) = vec(B X A^T)); sparse
factors run on K2 (``SparseMatrix @`` with a block operand), dense float32
factors without TF32 (``linear_algebra.kron.matmul_highest``, where JAX asks
for ``Precision.HIGHEST``).

Differences from the JAX module:
- ``SpaceTimeSmoothing.fit`` forms Psi^T Psi and Phi^T Phi as sparse
  products (scipy, on the host) with the same values, where JAX forms
  Psi^T Psi as a dense (n_s, n_s) array: 35 GB in float64 on
  unit_square_mesh(256), 2.2 TB at 519,841 dofs;
- the observation sites are located on the model's device
  (``DeviceCellLocator``, the same cells as the host locator);
- ``ModeMGPreconditioner`` applies one V-cycle per time mode in a loop
  where JAX vmaps them, and ``solve_space_time_fdm`` solves its mode
  systems in a loop of vector CG solves where JAX vmaps one batched CG:
  the same per-mode iterates;
- ``solve_space_time_fdm(device_mesh=...)``, the mode-parallel multi-chip
  form, raises NotImplementedError (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..linear_algebra.kron import matmul_highest
from ..linear_algebra.solvers import SolveInfo, bicgstab, cg, gmres
from ..linear_algebra.sparse import SparseMatrix

__all__ = ["ModeDiagPreconditioner", "ModeMGPreconditioner", "SeparableOperator",
           "SpaceTimeSmoothing", "solve_space_time", "solve_space_time_fdm"]


def _space_n(S):
    return S.shape2d[0] * S.shape2d[1] if hasattr(S, "shape2d") else S.shape[0]


def _apply_space_batch(S, X):
    """S applied to every row of X (n_t, n_s): sparse matrices as one block
    product on K2, stencil operators through their batched hook, dense
    matrices as one product."""
    if hasattr(S, "matvec_batch"):
        return S.matvec_batch(X)
    if isinstance(S, SparseMatrix):
        return (S @ X.T).T
    return matmul_highest(X, S.T)


def _diag_of(M):
    return torch.diagonal(M) if isinstance(M, torch.Tensor) else M.diagonal()


def _host_dense(T):
    """Small time factor as a host numpy array (for the eigh setup)."""
    if hasattr(T, "toarray"):
        return np.asarray(T.toarray())
    return T.cpu().numpy() if isinstance(T, torch.Tensor) else np.asarray(T)


class SeparableOperator:
    """sum_k  T_k (x) S_k  as a matrix-free linear operator.

    T_k act on the time index (n_t x n_t), S_k on space (n_s x n_s); the
    operator acts on vec(u) with u of shape (n_t, n_s) row-major. T_k may be
    a dense tensor or a SparseMatrix; S_k dense, SparseMatrix, or any
    operator exposing ``matvec_batch(X)`` + ``diagonal()`` (e.g.
    ops/grid_dia.GridDIAMatrix).
    """

    def __init__(self, terms):
        self.terms = list(terms)  # [(T, S), ...]
        T0, S0 = self.terms[0]
        self.n_t = T0.shape[0]
        self.n_s = _space_n(S0)
        self.shape = (self.n_t * self.n_s, self.n_t * self.n_s)

    def __call__(self, x):
        X = x.reshape(self.n_t, self.n_s)
        out = None
        for T, S in self.terms:
            SX = _apply_space_batch(S, X)
            y = (T @ SX) if isinstance(T, SparseMatrix) else matmul_highest(T, SX)
            out = y if out is None else out + y
        return out.reshape(-1)

    __matmul__ = __call__

    def diagonal(self):
        """Diagonal of the operator (for Jacobi preconditioning)."""
        d = None
        for T, S in self.terms:
            term = torch.kron(_diag_of(T), _diag_of(S))
            d = term if d is None else d + term
        return d


class ModeDiagPreconditioner:
    """Mode-diagonal preconditioner for  R = T1 (x) S0 + T0 (x) S1.

    With the generalized time eigenbasis Z^T T1 Z = diag(lam),
    Z^T T0 Z = I (host eigh on the tiny n_t x n_t pair), the exact
    transform (Z (x) I)^T R (Z (x) I) = diag(lam) (x) S0 + I (x) S1
    decouples time; replacing S0/S1 by their DIAGONALS gives the SPD
    approximation  M^{-1} r = (Z (x) I) D^{-1} (Z^T (x) I) r  with
    D_t = lam_t diag(S0) + diag(S1): two small time products plus an
    elementwise scale per application. The exact per-mode solve is
    solve_space_time_fdm.
    """

    def __init__(self, Z, Dinv):
        self.Z = Z  # (n_t, n_t)
        self.Dinv = Dinv  # (n_t, n_s)

    @classmethod
    def build(cls, T0, T1, dS0, dS1, floor: float = 0.0):
        """Host-side setup (T0/T1 host arrays, tiny); dS0/dS1 (n_s,) tensors."""
        import scipy.linalg as sla

        lam, Z = sla.eigh(np.asarray(T1), np.asarray(T0))
        lamt = torch.as_tensor(lam, dtype=dS0.dtype, device=dS0.device)
        D = lamt[:, None] * dS0[None, :] + dS1[None, :]
        D = torch.where(D.abs() > floor, D, 1.0)
        return cls(torch.as_tensor(Z, dtype=dS0.dtype, device=dS0.device), 1.0 / D)

    def __call__(self, r):
        X = r.reshape(self.Z.shape[0], -1)
        W = matmul_highest(self.Z.T, X) * self.Dinv
        return matmul_highest(self.Z, W).reshape(-1)

    __matmul__ = __call__


class ModeMGPreconditioner:
    """Mode-batched multigrid preconditioner for R = T1 (x) S0 + T0 (x) S1
    on structured space grids (S0/S1 ops/grid_dia.GridDIAMatrix).

    Time is diagonalized exactly (host eigh of the tiny (T1, T0) pencil);
    each time mode's space system  S1 + lam_t S0  gets one GridMG V-cycle
    (the two Galerkin chains share the bilinear P, so level data is the
    AXPY  A_l + lam_t E_l, one (n_t, K_l, m_l, m_l) stack per level). Against
    the kappa ~ 1e6 space conditioning that defeats diagonal
    preconditioning, this makes the space-time CG converge h-independently.
    """

    def __init__(self, Z, mg):
        from ..ops.grid_mg import GridMG

        self.Z = Z  # (n_t, n_t) time eigenbasis, T0-orthonormal
        self.mg = mg  # GridMG with mode-batched level data
        self._modes = [
            GridMG([d[t] for d in mg.datas], mg.offsets, mg.shapes, mg.omega, mg.nu,
                   mg.coarse_iters)
            for t in range(Z.shape[0])
        ]

    @classmethod
    def build(cls, T0, T1, S0, S1, dtype=torch.float32, coarse_n: int = 32,
              omega: float = 0.8, nu: int = 2, coarse_iters: int = 64):
        """T0/T1 host (n_t, n_t); S0/S1 GridDIAMatrix with IDENTICAL
        offsets2d (pad the sparser one with zero layers) and boundary
        treatment already folded (with_dirichlet_identity on S1)."""
        import scipy.linalg as sla

        from ..ops.grid_mg import GridMG, galerkin_coarsen

        if S0.offsets2d != S1.offsets2d:
            raise ValueError("S0/S1 must share offsets2d (pad zero layers)")
        lam, Z = sla.eigh(np.asarray(T1), np.asarray(T0))
        device = S1.data.device
        lamt = torch.as_tensor(lam, dtype=dtype, device=device)

        # the level plan of GridMG.build
        shapes = [S1.shape2d[0]]
        offsets = [S1.offsets2d]
        while True:
            nn = shapes[-1] - 1
            if nn % 2 != 0 or nn // 2 < coarse_n:
                break
            shapes.append(nn // 2 + 1)
            offsets.append(tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)))

        GA, GE = S1, S0
        datas = []
        for level in range(len(shapes)):
            datas.append(GA.data[None].to(dtype)
                         + lamt[:, None, None, None] * GE.data[None].to(dtype))
            if level + 1 < len(shapes):
                GA, GE = galerkin_coarsen(GA), galerkin_coarsen(GE)
        mg = GridMG(datas, tuple(offsets), tuple(shapes), omega, nu, coarse_iters)
        return cls(torch.as_tensor(Z, dtype=dtype, device=device), mg)

    def __call__(self, r):
        X = r.reshape(self.Z.shape[0], -1)
        W = matmul_highest(self.Z.T, X)
        W = torch.stack([mg.v_cycle(w) for mg, w in zip(self._modes, W)])
        return matmul_highest(self.Z, W).reshape(-1)

    __matmul__ = __call__


def solve_space_time(op: SeparableOperator, b, symmetric=True, rtol=1e-10, maxiter=None,
                     recovery=True):
    """Solve (sum_k T_k (x) S_k) x = b matrix-free with Jacobi-CG/BiCGStab.

    Failure recovery: on a stalled/diverged Krylov loop, one escalation —
    for the two-term penalty form T_a (x) S_a + T_b (x) S_b the retry swaps
    Jacobi for the mode-diagonal preconditioner (exact time
    diagonalization; the conditioning of the time pencil, e.g. a spline
    bilaplacian Gram spanning ~h_t^-3, is what usually defeats plain Jacobi
    here); otherwise GMRES(50)."""
    d = op.diagonal()
    inv = 1.0 / torch.where(d.abs() > 0, d, 1.0)
    solver = cg if symmetric else bicgstab
    x, info = solver(op, b, M_inv=lambda r: inv * r, rtol=rtol, maxiter=maxiter)
    if recovery and not info.converged:
        x_start = x if bool(torch.isfinite(x).all()) else torch.zeros_like(x)
        pre = None
        if len(op.terms) == 2 and symmetric:
            # terms [(T_b, S_a), (T_a, S_b)]: mode system S_b + lam S_a from
            # eigh(T_b, T_a), the R = T1 (x) S0 + T0 (x) S1 convention of
            # ModeDiagPreconditioner.build(T0, T1, dS0, dS1)
            (Tb, Sa), (Ta, Sb) = op.terms
            try:
                pre = ModeDiagPreconditioner.build(
                    _host_dense(Ta), _host_dense(Tb), _diag_of(Sa), _diag_of(Sb))
            except (np.linalg.LinAlgError, ValueError):  # non-SPD pencil: GMRES
                pre = None
        if pre is not None:
            warnings.warn("space-time solve stalled; escalating to the "
                          "mode-diagonal preconditioner", stacklevel=2)
            x, info = cg(op, b, M_inv=pre, x0=x_start, rtol=rtol, maxiter=maxiter)
        else:
            warnings.warn("space-time solve stalled; escalating to GMRES(50)", stacklevel=2)
            x, info = gmres(op, b, M_inv=lambda r: inv * r, x0=x_start, rtol=rtol,
                            maxiter=maxiter, restart=50)
    return x, info


class SpaceTimeSmoothing:
    """Separable space-time field estimation (spline-in-time x FEM-in-space).

    The downstream fdaPDE space-time model on a monitoring design (fixed
    spatial locations p_i observed at all instants t_j): estimate
    f(p, t) = sum_{uv} c_{uv} phi_u(t) psi_v(p) minimizing

        ||Y - Phi C Psi^T||_F^2 + lam_s * <(Mt (x) As) c, c>
                                 + lam_t * <(Pt (x) Ms) c, c>

    with As/Ms the FEM stiffness/mass on the spatial mesh, Mt/Pt the spline
    mass/bilaplacian penalty in time. On the grid design the normal
    equations are a sum of Kronecker products,

        [(Phi^T Phi) (x) (Psi^T Psi) + lam_s Mt (x) As + lam_t Pt (x) Ms] c
            = vec(Phi^T Y Psi),

    solved matrix-free on ``device`` (the card by default).
    """

    def __init__(self, mesh, time_interval, fem_order=1, spline_order=3, dtype=torch.float64,
                 device="cuda"):
        from ..fem.assembler import assemble_matrix
        from ..fem.space import FEMSpace
        from ..pde.operators import bilaplacian, laplacian, reaction
        from ..splines.assembler import assemble_mass, assemble_operator
        from ..splines.space import SplineSpace

        self.device = torch.device(device)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=self.device)
        self.space = FEMSpace(mesh, fem_order)
        self.tspace = SplineSpace(time_interval, spline_order)
        self.As = assemble_matrix(self.space, -laplacian(), **kw)
        self.Ms = assemble_matrix(self.space, reaction(1.0), **kw)
        self.Mt = assemble_mass(self.tspace, **kw)
        self.Pt = assemble_operator(self.tspace, -bilaplacian(), **kw)

    def _bases(self, locs, times):
        from ..fem.evaluation import eval_basis_pointwise

        kw = dict(dtype=self.dtype, device=self.device)
        Psi, _ = eval_basis_pointwise(self.space, np.asarray(locs), device_locate=True, **kw)
        Phi, _ = self.tspace.eval(np.asarray(times), **kw)
        return Psi, Phi

    def fit(self, locs, times, Y, lam_s, lam_t, rtol=1e-10, maxiter=20000):
        """locs (n_i, d) spatial points; times (n_j,); Y (n_i, n_j)."""
        Psi, Phi = self._bases(locs, times)
        kw = dict(dtype=self.dtype, device=self.device)

        def gram(B):  # B^T B as a sparse product, exact zeros dropped
            G = (B.to_scipy().T @ B.to_scipy()).tocoo()
            G.eliminate_zeros()
            return SparseMatrix.from_scipy(G, **kw)

        op = SeparableOperator([
            (gram(Phi), gram(Psi)),
            (lam_t * self.Pt, self.Ms),
            (lam_s * self.Mt, self.As),
        ])
        Yt = torch.as_tensor(Y, **kw)
        rhs_mat = Phi.rmatvec(Yt.T)  # (nt_basis, n_i)
        rhs = Psi.rmatvec(rhs_mat.T).T  # (nt_basis, ns)
        self._op = op
        c, info = solve_space_time(op, rhs.reshape(-1), rtol=rtol, maxiter=maxiter)
        self.coefficients_ = c.reshape(self.tspace.n_dofs, self.space.n_dofs)
        self.solve_info_ = info
        return self.coefficients_

    def predict(self, locs, times):
        """Field values at the (locs x times) grid: (n_i, n_j)."""
        Psi, Phi = self._bases(locs, times)
        tmp = Psi @ self.coefficients_.T  # (n_i, nt_basis)
        return (Phi @ tmp.T).T  # (n_i, n_j)


def solve_space_time_fdm(T0, T1, S0, S1, b, rtol: float = 1e-10, maxiter: int = 2000,
                         device_mesh=None):
    """Fast diagonalization (Lynch–Rice–Thomas) for the 2-term operator
    R = T1 (x) S0 + T0 (x) S1.

    Host-side generalized time eigenbasis T1 Z = T0 Z diag(lam) with
    Z^T T0 Z = I decouples the system into n_t independent space solves

        (S1 + lam_t S0) w_t = (Z^T (x) I) b,   x = (Z (x) I) w,

    each a Jacobi CG on the same SpMVs as the elliptic path (K2 for
    SparseMatrix factors): the Kronecker structure costs n_t elliptic
    solves and two (n_t, n_t) products (kronecker_product.h:27-80 is the
    reference's building block).

    Requirements: T0 SPD, T1 symmetric PSD (dense or SparseMatrix, n_t
    small); S0 SPD, S1 symmetric PSD with S1 + lam_min S0 SPD (the usual
    mass/stiffness pairs qualify). Returns (x, SolveInfo) with iterations
    the max over modes and converged the AND. ``device_mesh`` (the
    mode-parallel multi-chip form) is not ported yet.
    """
    import scipy.linalg as sla

    if device_mesh is not None:
        raise NotImplementedError(
            "solve_space_time_fdm(device_mesh=...) is not ported yet: ROADMAP queue 1 "
            "item 6 (the multi-device slice)")
    lam, Z = sla.eigh(_host_dense(T1), _host_dense(T0))  # Z^T T0 Z = I
    n_t = Z.shape[0]
    B = b.reshape(n_t, -1)
    Zt = torch.as_tensor(Z, dtype=B.dtype, device=B.device)
    Bt = matmul_highest(Zt.T, B)  # (Z^T (x) I) b on the (t, s) row-major layout
    d0, d1 = S0.diagonal(), S1.diagonal()
    W, iters, conv = [], [], []
    for lam_t, rhs in zip(lam.tolist(), Bt):
        def op(v, lam_t=lam_t):
            return (S1 @ v) + lam_t * (S0 @ v)

        d = d1 + lam_t * d0
        dinv = 1.0 / torch.where(d.abs() > 0, d, 1.0)
        x, info = cg(op, rhs, M_inv=lambda r, dinv=dinv: dinv * r, rtol=rtol, maxiter=maxiter)
        W.append(x)
        iters.append(info.iterations)
        conv.append(info.converged)
    X = matmul_highest(Zt, torch.stack(W))
    return X.reshape(-1), SolveInfo(max(iters), torch.zeros((), dtype=B.dtype), all(conv))
