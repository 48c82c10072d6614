"""General-mesh P1 at device scale: the matrix-free gather pipeline (2D).

Port of the 2D P1 parts of ``fdapde_core_tpu/models/matfree.py``:

  mesh arrays (nodes, cells, boundary) -> per-cell closed-form local
  matrices and a slot-major incidence table (ops/matfree_soa.py) ->
  assembled (K, n) ELL -> Dirichlet masking (fem/solvers.py) -> CG or
  BiCGStab preconditioned by the auxiliary-grid V-cycle (ops/auxgrid.py)
  in float32 under the model's precision.

With ``gather_kernel="lane"`` the solve is mixed-precision refinement:
inner CG on a float32 copy of the ELL, outer residuals through the
full-precision ELL (``_lane_refined_solve``). Every ELL product is the K2
kernel (ops/gather_spmv.py). Nothing assumes a topology: the solver sees
index tensors.

Not ported yet, and raising NotImplementedError with the ROADMAP item: 3D
meshes, ``from_space`` (P2), ``MatrixFreeParabolic``, ``aux_kernel="lane"``
(ops/lane_aux.py) and operators that ``plan_split_width`` accepts (the
banded split and its multigrid).
"""

from __future__ import annotations

import functools

import torch

from ..fem.solvers import DirichletSystem
from ..linear_algebra.solvers import (
    bicgstab,
    bicgstab_chunked,
    cg,
    cg_chunked,
    cg_split_programs,
)
from ..ops.auxgrid import AuxGridPreconditioner
from ..ops.dia_split import plan_split_width
from ..ops.gather_spmv import LaneRoutedELL
from ..ops.matfree_soa import MatrixFreeSoA

__all__ = ["MatrixFreePoisson", "MatrixFreeElliptic", "MatrixFreeParabolic"]

_TODO_3D = "3D meshes are not ported yet (ROADMAP queue 1, slice 4)"
_TODO_BANDED = (
    "plan_split_width accepted this operator, and the banded DIA split with "
    "BandedMGPreconditioner (ops/dia_split.py) is not ported yet (ROADMAP "
    "queue 1, slice 3); pass preconditioner='auxgrid'"
)
_TODO_LANE_AUX = ("aux_kernel='lane' (ops/lane_aux.py) is not ported yet "
                  "(ROADMAP queue 1, slice 3)")
_KERNELS = ("xla", "lane")


def _reject_banded(op, split_plan):
    """Raise where JAX's preconditioner='auto' would take the banded split."""
    W, _ = plan_split_width(op) if split_plan is None else split_plan
    if W is not None:
        raise NotImplementedError(_TODO_BANDED)


def _aux_diag32(op, boundary):
    return DirichletSystem(op, boundary).diagonal().to(torch.float32)


class MatrixFreePoisson:
    """-Laplace u = f with Dirichlet data g, P1 on an arbitrary 2D
    triangulation.

    nodes (N, 2), cells (C, 3), boundary (N,) bool: tensors or arrays,
    moved to ``device``; the node dtype is the operator's. max_degree
    bounds the cell incidences per node (a violated bound raises
    ValueError); grid_n sets the auxiliary grid (default ~sqrt(N)); kappa
    is an optional (C,) or scalar diffusivity.
    """

    def __init__(self, nodes, cells, boundary, max_degree: int | None = None,
                 grid_n: int | None = None, bbox=None,
                 format: str = "ell", max_cols: int | None = None,
                 kappa=None, preconditioner: str = "auto",
                 split_plan=None, device="cuda"):
        self.nodes = torch.as_tensor(nodes, device=device)
        self.cells = torch.as_tensor(cells, device=device).to(torch.int32)
        self.boundary = torch.as_tensor(boundary, device=device).to(torch.bool)
        self.n_dofs = self.nodes.shape[0]
        self.format = format
        self.dim = self.nodes.shape[1]
        if self.dim == 3:
            raise NotImplementedError(_TODO_3D)
        if self.dim != 2:
            raise ValueError(f"2D/3D only, got embedding dim {self.dim}")
        if max_degree is None:
            max_degree = 8
        if max_cols is None:
            max_cols = max_degree + 1  # neighbours + self
        if bbox is None:
            bbox = ((0.0, 0.0), (1.0, 1.0))

        x, y = self.nodes[:, 0], self.nodes[:, 1]
        corners = [self.cells[:, j].contiguous() for j in range(3)]
        if kappa is not None:
            kappa = torch.as_tensor(kappa, dtype=self.nodes.dtype, device=device)
        mf, over = MatrixFreeSoA.build(x, y, *corners, self.n_dofs, max_degree, kappa=kappa)
        if bool(over):
            raise ValueError(
                f"a node exceeds max_degree={max_degree} cell incidences; "
                "rebuild with a larger bound"
            )
        # the load_vector combine rides the adjacency regardless of format
        self.adj, self.adj_mask = mf.adj, mf.adj_mask
        if format == "ell":
            E, overc = mf.to_ell(max_cols)
            if bool(overc):
                raise ValueError(
                    f"a row exceeds {max_cols} distinct columns; "
                    "rebuild with a larger max_cols"
                )
            self.op = E
        elif format == "matfree":
            self.op = mf
        else:
            raise ValueError(format)
        self.system = DirichletSystem(self.op, self.boundary)
        self.preconditioner = "auxgrid"
        if preconditioner in ("auto", "banded_mg") and format == "ell":
            _reject_banded(self.op, split_plan)
        if preconditioner == "banded_mg":
            raise ValueError(
                "banded_mg requested but the operator has no concentrated "
                "band (plan_split_width rejected it); use 'auto' or 'auxgrid'"
            )
        self.aux = AuxGridPreconditioner.build_device(
            self.nodes, _aux_diag32(self.op, self.boundary), grid_n=grid_n, bbox=bbox)

    def load_vector(self, f_cells):
        """P1 load b_i = sum_T |T|/3 f(centroid_T) over incident cells;
        f_cells: (C,) forcing at the centroids."""
        return _load_vector(
            (self.nodes[:, 0], self.nodes[:, 1]), self.cells.T, self.adj, self.adj_mask,
            torch.as_tensor(f_cells, device=self.nodes.device),
        )

    def solve(self, b, g=None, rtol: float = 1e-9, maxiter: int = 100,
              chunk: int | None = None, on_chunk=None):
        """Mixed-precision converged solve (CG vectors in b's dtype, float32
        aux V-cycle). Returns (x, iterations, true relative residual).
        With ``chunk``, on_chunk(k, ||r||) is called every chunk
        iterations; the iterates are the same."""
        if g is None:
            g = torch.zeros_like(b)
        if chunk is not None:
            return _solve_chunked(self.op, self.boundary, self.aux, b, g,
                                  True, rtol, maxiter, chunk, on_chunk)
        return _solve(self.op, self.boundary, self.aux, b, g, True, rtol, maxiter)


def _load_vector(coords, dofs, adj, adj_mask, f_cells):
    """P1 load vector from per-cell forcing at the centroids: |T|/3 f per
    incident cell, combined over the slot-major incidence table (JAX's
    ``_p1_load_fn`` and ``_load_vector_fn(order=1)``)."""
    e = [[coords[d][dofs[j + 1]] - coords[d][dofs[0]] for d in range(2)]
         for j in range(2)]
    meas = 0.5 * torch.abs(e[0][0] * e[1][1] - e[0][1] * e[1][0])
    fa = meas * f_cells / 3.0
    floc = torch.cat([fa] * 3)  # slot-major (3C,)
    return (floc[adj] * adj_mask.to(floc.dtype)).sum(dim=0)


def _aux_apply(aux, r):
    """float32 aux V-cycle inside a higher-precision Krylov loop."""
    return aux(r.to(torch.float32)).to(r.dtype)


def _rel_residual(sys, x, b_mod):
    res = b_mod - sys(x)
    return torch.sqrt(torch.sum(res * res) / torch.sum(b_mod * b_mod))


def _solve_chunked(op, bnd, aux, b, g, symmetric, rtol, maxiter, chunk,
                   on_chunk):
    sys = DirichletSystem(op, bnd)
    b_mod = sys.rhs(b, g)
    x0 = torch.where(bnd, g, 0.0)
    solver = cg_chunked if symmetric else bicgstab_chunked
    x, info = solver(sys, b_mod, M_inv=functools.partial(_aux_apply, aux), x0=x0,
                     rtol=rtol, maxiter=maxiter, chunk=chunk, on_chunk=on_chunk)
    return x, info.iterations, _rel_residual(sys, x, b_mod)


def _solve(op, bnd, aux, b, g, symmetric, rtol, maxiter):
    """CG (symmetric) or BiCGStab on the Dirichlet system with the float32
    aux apply (JAX's ``_solve_fn`` and ``_general_solve_fn``); returns
    (x, iterations, true relative residual)."""
    sys = DirichletSystem(op, bnd)
    b_mod = sys.rhs(b, g)
    x0 = torch.where(bnd, g, 0.0)
    solver = cg if symmetric else bicgstab
    x, info = solver(sys, b_mod, M_inv=functools.partial(_aux_apply, aux),
                     x0=x0, rtol=rtol, maxiter=maxiter)
    return x, info.iterations, _rel_residual(sys, x, b_mod)


def _percell(value, C, dtype, device):
    """A coefficient as a per-cell (C,) tensor (or None)."""
    if value is None:
        return None
    v = torch.as_tensor(value, dtype=dtype, device=device)
    if v.dim() == 0:
        v = v.expand(C).clone()
    return v


def _normalize_K(K, centroids, C, dim, dtype, device):
    """Diffusion spec -> upper-triangle per-cell tensors (kxx, kxy, kyy) or
    Nones. Accepts None (identity), a scalar, a (2, 2) tensor, the
    upper-triangle tuple of scalars/(C,) tensors, a per-cell (C,) scalar
    field, or a callable evaluated at the cell centroids."""
    ntri = 3
    if K is None:
        return (None,) * ntri
    if callable(K):
        K = K(centroids())
    if isinstance(K, tuple):
        if len(K) != ntri:
            raise ValueError(
                f"tuple K must be the {ntri} upper-triangle entries for "
                f"dim={dim}, got {len(K)}"
            )
        return tuple(_percell(v, C, dtype, device) for v in K)
    K_arr = torch.as_tensor(K, dtype=dtype, device=device)
    if K_arr.dim() == 2 and tuple(K_arr.shape) == (dim, dim):
        iu = [(i, j) for i in range(dim) for j in range(i, dim)]
        return tuple(_percell(K_arr[i, j], C, dtype, device) for i, j in iu)
    return (_percell(K_arr, C, dtype, device),) + (None,) * (ntri - 1)  # isotropic


def _normalize_b(b, centroids, C, dim, dtype, device):
    if b is None:
        return (None,) * dim
    if callable(b):
        b = b(centroids())
    if isinstance(b, tuple):
        if len(b) != dim:
            raise ValueError(
                f"tuple b must have {dim} components for dim={dim}, "
                f"got {len(b)} (a short tuple would silently zero the rest)"
            )
        return tuple(_percell(v, C, dtype, device) for v in b)
    b_arr = torch.as_tensor(b, dtype=dtype, device=device)
    if b_arr.dim() == 1 and b_arr.shape[0] == dim:
        return tuple(_percell(b_arr[d], C, dtype, device) for d in range(dim))
    return tuple(_percell(b_arr[..., d], C, dtype, device) for d in range(dim))


class MatrixFreeElliptic:
    """-div(K grad u) + b . grad u + c u = f,  u = g on the boundary, P1
    on an arbitrary 2D triangulation. CG when symmetric (b is None),
    BiCGStab otherwise, preconditioned by the auxiliary grid.

    K: None | scalar | (2, 2) | (kxx, kxy, kyy) | (C,) | callable(centroids);
    b: None | (2,) | (bx, by) | callable; c: None | scalar | (C,) | callable.
    nodes: (N, 2) or an (x, y) tuple of (N,) coordinates; the coordinate
    dtype is the operator's. gather_kernel: "xla" (ELL SpMV in the model's
    precision) or "lane" (float32 inner solves with refinement, when the
    operator stays on the aux-grid path). aux_kernel: "xla"; "lane" is
    not ported yet.
    """

    def __init__(self, nodes, cells, boundary, order: int = 1, K=None,
                 b=None, c=None, max_degree: int | None = None,
                 grid_n: int | None = None, bbox=None,
                 format: str = "ell", max_cols: int | None = None,
                 preconditioner: str = "auto", split_plan=None,
                 gather_kernel: str = "xla", aux_kernel: str = "xla",
                 device="cuda"):
        if gather_kernel not in _KERNELS:
            raise ValueError(f"gather_kernel must be one of {_KERNELS}, got {gather_kernel!r}")
        if aux_kernel not in _KERNELS:
            raise ValueError(f"aux_kernel must be one of {_KERNELS}, got {aux_kernel!r}")
        if aux_kernel == "lane" and gather_kernel != "lane":
            raise ValueError("aux_kernel='lane' needs gather_kernel='lane'")
        if aux_kernel == "lane":
            raise NotImplementedError(_TODO_LANE_AUX)

        if isinstance(nodes, tuple):
            coords = [torch.as_tensor(v, device=device) for v in nodes]
        else:
            nodes = torch.as_tensor(nodes, device=device)
            coords = [nodes[:, d] for d in range(nodes.shape[1])]
        dim = len(coords)
        if dim == 3:
            raise NotImplementedError(_TODO_3D)
        if dim != 2:
            raise ValueError(f"2D/3D only, got embedding dim {dim}")
        if order != 1:
            raise ValueError("order=2 needs a dof table: use from_space(space, ...)")
        if max_degree is None:
            max_degree = 8
        dofs = torch.as_tensor(cells, device=device).to(torch.int32).T.contiguous()  # (3, C)
        n_dofs = coords[0].shape[0]
        dtype = coords[0].dtype
        self.dof_x, self.dof_y = coords[0], coords[1]
        C = dofs.shape[1]

        # centroids are made only for callable coefficients
        _cent_cache = []

        def centroids():
            if not _cent_cache:
                cs = [sum(co[dofs[j]] for j in range(dim + 1)) / (dim + 1.0)
                      for co in coords]
                _cent_cache.append(torch.stack(cs, dim=1))
            return _cent_cache[0]

        ktri = _normalize_K(K, centroids, C, dim, dtype, device)
        badv = _normalize_b(b, centroids, C, dim, dtype, device)
        react = _percell(c(centroids()) if callable(c) else c, C, dtype, device)
        coef = dict(zip(("kxx", "kxy", "kyy"), ktri))
        coef.update(zip(("bx", "by"), badv))
        coef["react"] = react

        self.order = order
        self.dim = dim
        self.n_dofs = n_dofs
        self.boundary = torch.as_tensor(boundary, device=device).to(torch.bool)
        self.is_symmetric = all(v is None for v in badv)
        if max_cols is None and format == "ell":
            max_cols = max_degree + 1  # neighbours + self

        mf, over = MatrixFreeSoA.build_general(*coords, *dofs, n_dofs, max_degree, **coef)
        if bool(over):
            raise ValueError(
                f"a dof exceeds max_degree={max_degree} cell incidences; "
                "rebuild with a larger bound"
            )
        self.adj, self.adj_mask = mf.adj, mf.adj_mask
        self.dofs = dofs
        self._coords = coords
        if format == "ell":
            E, overc = mf.to_ell(max_cols)
            del mf
            if bool(overc):
                raise ValueError(
                    f"a row exceeds {max_cols} distinct columns; "
                    "rebuild with a larger max_cols"
                )
            self.op = E
        elif format == "matfree":
            self.op = mf
        else:
            raise ValueError(format)
        self.system = DirichletSystem(self.op, self.boundary)
        self.preconditioner = "auxgrid"
        if preconditioner in ("auto", "banded_mg") and format == "ell":
            _reject_banded(self.op, split_plan)
        if preconditioner == "banded_mg":
            raise ValueError(
                "banded_mg requested but the operator has no concentrated "
                "band (plan_split_width rejected it); use 'auto' or 'auxgrid'"
            )
        if gather_kernel == "lane" and format == "ell":
            # float32 copy of the ELL for the inner solves; the
            # full-precision ELL stays as op_ref for the outer residuals
            self.op_ref = self.op
            lane_src = (self.op.astype(torch.float32)
                        if self.op.vals.dtype == torch.float64 else self.op)
            self.op = LaneRoutedELL.from_ell(lane_src)
            self.system = DirichletSystem(self.op_ref, self.boundary)
            self.preconditioner = "auxgrid+lane"
        if bbox is None:
            bbox = ((0.0,) * dim, (1.0,) * dim)
        self.aux = AuxGridPreconditioner.build_device(
            (self.dof_x, self.dof_y), _aux_diag32(self.op, self.boundary),
            grid_n=grid_n, bbox=bbox,
        )

    @classmethod
    def from_space(cls, space, K=None, b=None, c=None, **kw):
        """Build from a host FEMSpace (order 1 or 2): not ported yet."""
        raise NotImplementedError(
            "from_space (P2 via MatrixFreeP2SoA) is not ported yet (ROADMAP queue 1, slice 3)")

    def load_vector(self, f_cells):
        """Load vector from per-cell forcing values (centroid rule):
        b_a = sum_T |T|/3 f over the cells incident to a."""
        return _load_vector(
            self._coords, self.dofs, self.adj, self.adj_mask,
            torch.as_tensor(f_cells, device=self.dof_x.device),
        )

    def solve(self, b, g=None, rtol: float = 1e-9, maxiter: int = 200,
              chunk: int | None = None, on_chunk=None):
        """Converged solve; returns (x, iterations, true relative residual).
        CG when symmetric, BiCGStab otherwise, float32 aux V-cycle; on the
        lane path, refinement with float32 inner CG (``chunk`` sets its
        check cadence, chunk // 2, default 50)."""
        if self.preconditioner == "auxgrid+lane":
            return _lane_refined_solve(
                self.op_ref, self.op, self.boundary, self.aux, b, g,
                rtol, maxiter, chunk or 50, on_chunk)
        if g is None:
            g = torch.zeros_like(b)
        if chunk is not None:
            return _solve_chunked(self.op, self.boundary, self.aux, b, g,
                                  self.is_symmetric, rtol, maxiter, chunk, on_chunk)
        return _solve(self.op, self.boundary, self.aux, b, g, self.is_symmetric, rtol, maxiter)


def _lane_refined_solve(op_ref, lane, bnd, aux, b, g, rtol, maxiter, chunk,
                        on_chunk=None, inner_rtol=1e-6, max_outer=8):
    """Mixed-precision iterative refinement: inner CG on the float32 ELL
    with the float32 aux V-cycle (``cg_split_programs``, stop test every
    chunk // 2 iterations, at most 100 iterations per round), outer
    residuals through the full-precision ELL ``op_ref``. g=None is the
    homogeneous case (b_mod = masked b, no operator application in the
    set-up). Returns (x, total inner iterations, true relative residual).
    """
    lane_sys = DirichletSystem(lane, bnd)
    sysr = DirichletSystem(op_ref, bnd)
    if g is None:
        b_mod = torch.where(bnd, 0.0, b)
        x = torch.zeros_like(b)
        r = b_mod
    else:
        b_mod = sysr.rhs(b, g)
        x = torch.where(bnd, g, 0.0)
        r = b_mod - sysr(x)
    bnf = max(float(torch.linalg.norm(b_mod)), 1e-300)
    rel = float(torch.linalg.norm(r)) / bnf
    total_it = 0
    for _ in range(max_outer):
        if rel <= rtol or total_it >= maxiter:
            break
        dx, info = cg_split_programs(
            lane_sys, r.to(torch.float32), aux, rtol=inner_rtol,
            maxiter=min(maxiter - total_it, 100),
            check_every=max(1, chunk // 2),
            on_check=None if on_chunk is None else (
                lambda k, v: on_chunk(total_it + k, v)))
        total_it += int(info.iterations)
        x = x + dx.to(x.dtype)
        r = b_mod - sysr(x)
        rel = float(torch.linalg.norm(r)) / bnf
    return x, total_it, rel


class MatrixFreeParabolic:
    """Implicit-Euler stepping on the gather pipeline: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("MatrixFreeParabolic is not ported yet (ROADMAP queue 1, slice 3)")
