"""General meshes at device scale: the matrix-free gather pipeline (2D
triangulations and 3D tetrahedralizations).

Port of ``fdapde_core_tpu/models/matfree.py``:

  mesh arrays (nodes, cells, boundary), or a P1/P2 FEMSpace through
  ``MatrixFreeElliptic.from_space`` -> per-cell closed-form local matrices
  and a slot-major incidence table (ops/matfree_soa.py) -> assembled
  (K, n) ELL -> Dirichlet masking (fem/solvers.py) -> CG or BiCGStab
  preconditioned in float32 under the model's precision.

The preconditioner follows the operator (``preconditioner="auto"``): when
the ELL's offset histogram is band-concentrated (``plan_split_width``; in
3D ``plan_split_3d``), the operator becomes the banded split
(ops/dia_split.py: a stencil over an (R, W) index grid plus an ELL
remainder; ops/dia_split3d.py: over an (R, W2/W1, W1) lattice) and the
preconditioner its gather-free multigrid ("banded_mg"); otherwise the
auxiliary-grid V-cycle (ops/auxgrid.py, "auxgrid"; the 3D grid
``AuxGridPreconditioner3D`` on tet meshes). With ``gather_kernel="lane"`` on the aux-grid
path the solve is mixed-precision refinement: inner CG on a float32 copy
of the ELL, outer residuals through the full-precision ELL
(``_lane_refined_solve``); ``aux_kernel="lane"`` there also takes the
lane grid size and names the aux grid ``LaneAuxGrid`` (ops/lane_aux.py;
2D only, as in JAX: in 3D it changes nothing).
Every ELL product, the aux grid's P and P^T included, is the K2 kernel
(ops/gather_spmv.py). ``MatrixFreeParabolic`` steps implicit
Euler with the lumped mass on the same operator stack.

``MatrixFreeParabolic``'s aux-grid route takes the unit box as the grid's
box when ``bbox`` is not given, in 2D and 3D; JAX passes None there, which
its ``build_device`` does not take.
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
from ..ops.auxgrid import AuxGridPreconditioner, AuxGridPreconditioner3D
from ..ops.dia_split import BandedMGPreconditioner, build_banded_split, plan_split_width
from ..ops.dia_split3d import (
    BandedMGPreconditioner3D,
    BandedSplit3D,
    build_banded_split_3d,
    plan_split_3d,
)
from ..ops.gather_spmv import LaneRoutedELL
from ..ops.lane_aux import LaneAuxGrid, lane_friendly_grid_n
from ..ops.matfree_soa import MatrixFreeP2SoA, MatrixFreeSoA, MatrixFreeSoA3D

__all__ = ["MatrixFreePoisson", "MatrixFreeElliptic", "MatrixFreeParabolic"]

_NO_BAND = ("banded_mg requested but the operator has no concentrated "
            "band (plan_split_width rejected it); use 'auto' or 'auxgrid'")
_KERNELS = ("xla", "lane")


def _banded_split(E, split_plan=None, dim=2):
    """preconditioner="auto": the banded split of the assembled ELL when
    its offset histogram is band-concentrated (decided from the matrix
    alone by plan_split_width's coverage guard, or given as
    ``split_plan=(W, amax)``; in 3D by plan_split_3d, or
    ``split_plan=(W1, W2)``) and its window is the 9-point (3D: 27-point)
    one that the banded multigrid coarsens; else None, keeping the aux-grid
    path.

    The split is unfolded (exactly A): the boundary stays with
    DirichletSystem, whose right-hand side needs A's boundary columns. The
    Dirichlet fold happens only inside the multigrid build (``_banded_mg``).
    """
    if dim == 3:
        W1, W2 = plan_split_3d(E) if split_plan is None else split_plan
        if W1 is None:
            return None
        S, over = build_banded_split_3d(E, W1, W2)
    else:
        W, amax = plan_split_width(E) if split_plan is None else split_plan
        if W is None or amax > 1:
            return None
        S, over = build_banded_split(E, W, amax=amax)
    if bool(over):
        return None
    if not bool((S.rem.vals != 0.0).any()):
        S = S.drop_empty_remainder()
    return S


def _route(op, boundary, format, preconditioner, split_plan, dim=2):
    """(operator, preconditioner name) after the "auto" structure check:
    (the banded split, "banded_mg") or (op, "auxgrid"). An explicit
    "banded_mg" that the band plan rejects raises ValueError."""
    if preconditioner in ("auto", "banded_mg") and format == "ell":
        S = _banded_split(op, split_plan, dim)
        if S is not None:
            return S, "banded_mg"
    if preconditioner == "banded_mg":
        raise ValueError(_NO_BAND)
    return op, "auxgrid"


def _banded_mg(S, boundary):
    """The split's multigrid, built on its float32 Dirichlet fold."""
    cls = BandedMGPreconditioner3D if isinstance(S, BandedSplit3D) else BandedMGPreconditioner
    return cls.build(S.astype(torch.float32).fold_dirichlet(boundary))


def _aux_grid(coords, diag32, grid_n, bbox):
    """The device-built aux grid over the dof coordinates (a tuple of (n,)
    tensors, 2 or 3 of them) in the unit box unless ``bbox`` is given."""
    dim = len(coords)
    cls = AuxGridPreconditioner if dim == 2 else AuxGridPreconditioner3D
    if bbox is None:
        bbox = ((0.0,) * dim, (1.0,) * dim)
    return cls.build_device(tuple(coords), diag32, grid_n=grid_n, bbox=bbox)


def _aux_diag32(op, boundary):
    return DirichletSystem(op, boundary).diagonal().to(torch.float32)


def _p1_operator(model, nodes, cells, boundary, max_degree=None, format="ell", max_cols=None,
                 kappa=None, preconditioner="auto", split_plan=None, device="cuda"):
    """The operator half of MatrixFreePoisson and MatrixFreeParabolic:
    sets model's mesh tensors, the incidence table of load_vector, the
    assembled operator ``op`` (the banded split where ``_route`` takes it)
    and the ``preconditioner`` name; builds no preconditioner."""
    model.nodes = torch.as_tensor(nodes, device=device)
    model.cells = torch.as_tensor(cells, device=device).to(torch.int32)
    model.boundary = torch.as_tensor(boundary, device=device).to(torch.bool)
    model.n_dofs = model.nodes.shape[0]
    model.format = format
    model.dim = dim = model.nodes.shape[1]
    if dim not in (2, 3):
        raise ValueError(f"2D/3D only, got embedding dim {dim}")
    if max_degree is None:
        max_degree = 8 if dim == 2 else 24
    if max_cols is None:
        # 2D: neighbours + self; 3D: the Euler bound on the vertex link (an
        # interior vertex of F tets has 2 + F/2 neighbours) + self + 1
        # (Freudenthal, max_degree 24: 16 slots for 15 entries)
        max_cols = max_degree + 1 if dim == 2 else max_degree // 2 + 4

    coords = [model.nodes[:, d].contiguous() for d in range(dim)]
    corners = [model.cells[:, j].contiguous() for j in range(dim + 1)]
    if kappa is not None:
        kappa = torch.as_tensor(kappa, dtype=model.nodes.dtype, device=device)
    soa_cls = MatrixFreeSoA if dim == 2 else MatrixFreeSoA3D
    mf, over = soa_cls.build(*coords, *corners, model.n_dofs, max_degree, kappa=kappa)
    if bool(over):
        raise ValueError(
            f"a node exceeds max_degree={max_degree} cell incidences; "
            "rebuild with a larger bound"
        )
    # the load_vector combine rides the adjacency regardless of format
    model.adj, model.adj_mask = mf.adj, mf.adj_mask
    if format == "ell":
        E, overc = mf.to_ell(max_cols)
        if bool(overc):
            raise ValueError(
                f"a row exceeds {max_cols} distinct columns; "
                "rebuild with a larger max_cols"
            )
        op = E
    elif format == "matfree":
        op = mf
    else:
        raise ValueError(format)
    model.op, model.preconditioner = _route(op, model.boundary, format, preconditioner,
                                            split_plan, dim)


class MatrixFreePoisson:
    """-Laplace u = f with Dirichlet data g, P1 on an arbitrary 2D
    triangulation or 3D tetrahedralization (after nodes.shape[1]).

    nodes (N, d), cells (C, d+1), boundary (N,) bool: tensors or arrays,
    moved to ``device``; the node dtype is the operator's. max_degree
    bounds the cell incidences per node (default 8 in 2D, 24 in 3D, the
    Freudenthal bound; a violated bound raises ValueError); grid_n sets the
    auxiliary grid (default ~N^(1/d)); kappa is an optional (C,) or scalar
    diffusivity. preconditioner: "auto" (the banded split with "banded_mg"
    where the band plan accepts the ELL, or ``split_plan`` given, (W, amax)
    in 2D, (W1, W2) in 3D; else "auxgrid"), "banded_mg" (raises ValueError
    without a band) or "auxgrid".
    """

    def __init__(self, nodes, cells, boundary, max_degree: int | None = None,
                 grid_n: int | None = None, bbox=None,
                 format: str = "ell", max_cols: int | None = None,
                 kappa=None, preconditioner: str = "auto",
                 split_plan=None, device="cuda"):
        _p1_operator(self, nodes, cells, boundary, max_degree, format, max_cols, kappa,
                     preconditioner, split_plan, device)
        self.system = DirichletSystem(self.op, self.boundary)
        if self.preconditioner == "banded_mg":
            self.aux = _banded_mg(self.op, self.boundary)
        else:
            self.aux = _aux_grid([self.nodes[:, d] for d in range(self.dim)],
                                 _aux_diag32(self.op, self.boundary), grid_n, bbox)

    def load_vector(self, f_cells):
        """P1 load b_i = sum_T |T|/(d+1) f(centroid_T) over incident cells;
        f_cells: (C,) forcing at the centroids."""
        return _load_vector(
            [self.nodes[:, d] for d in range(self.dim)], self.cells.T, self.adj, self.adj_mask,
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


def _load_vector(coords, dofs, adj, adj_mask, f_cells, order: int = 1):
    """Load vector from per-cell forcing at the centroids, combined over the
    slot-major incidence table (JAX's ``_p1_load_fn`` and
    ``_load_vector_fn``): P1 takes |T|/(d+1) f per incident cell; P2's
    vertex basis functions integrate to zero on an affine triangle and its
    edge ones to |T|/3."""
    dim = len(coords)
    e = [[coords[d][dofs[j + 1]] - coords[d][dofs[0]] for d in range(dim)]
         for j in range(dim)]
    if dim == 2:
        meas = 0.5 * torch.abs(e[0][0] * e[1][1] - e[0][1] * e[1][0])
    else:
        cxd = (e[1][1] * e[2][2] - e[1][2] * e[2][1],
               e[1][2] * e[2][0] - e[1][0] * e[2][2],
               e[1][0] * e[2][1] - e[1][1] * e[2][0])
        meas = torch.abs(e[0][0] * cxd[0] + e[0][1] * cxd[1] + e[0][2] * cxd[2]) / 6.0
    fa = meas * f_cells / (dim + 1.0)
    if order == 1:
        floc = torch.cat([fa] * (dim + 1))  # slot-major ((d+1) C,)
    else:
        zero = torch.zeros_like(fa)
        floc = torch.cat([zero, zero, zero] + [fa] * 3)  # slot-major (6C,)
    return (floc[adj] * adj_mask.to(floc.dtype)).sum(dim=0)


def _aux_apply(aux, r):
    """float32 preconditioner (aux-grid or banded V-cycle) inside a
    higher-precision Krylov loop."""
    return aux(r.to(torch.float32)).to(r.dtype)


def _rel_residual(sys, x, b_mod):
    res = b_mod - sys(x)
    return torch.sqrt(torch.sum(res * res) / torch.sum(b_mod * b_mod))


def _solve_chunked(op, bnd, aux, b, g, symmetric, rtol, maxiter, chunk,
                   on_chunk, u0=None):
    sys = DirichletSystem(op, bnd)
    b_mod = sys.rhs(b, g)
    x0 = torch.where(bnd, g, 0.0 if u0 is None else u0)
    solver = cg_chunked if symmetric else bicgstab_chunked
    x, info = solver(sys, b_mod, M_inv=functools.partial(_aux_apply, aux), x0=x0,
                     rtol=rtol, maxiter=maxiter, chunk=chunk, on_chunk=on_chunk)
    return x, info.iterations, _rel_residual(sys, x, b_mod)


def _solve(op, bnd, aux, b, g, symmetric, rtol, maxiter, u0=None):
    """CG (symmetric) or BiCGStab on the Dirichlet system with the float32
    preconditioner apply (JAX's ``_solve_fn``, ``_general_solve_fn`` and,
    warm-started from u0 on the free dofs, ``_parabolic_step_fn``);
    returns (x, iterations, true relative residual)."""
    sys = DirichletSystem(op, bnd)
    b_mod = sys.rhs(b, g)
    x0 = torch.where(bnd, g, 0.0 if u0 is None else u0)
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
    """Diffusion spec -> upper-triangle per-cell tensors or Nones: (kxx,
    kxy, kyy) in 2D, (kxx, kxy, kxz, kyy, kyz, kzz) in 3D. Accepts None
    (identity), a scalar, a (d, d) tensor, the upper-triangle tuple of
    scalars/(C,) tensors, a per-cell (C,) scalar field, or a callable
    evaluated at the cell centroids."""
    ntri = 3 if dim == 2 else 6
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
    on an arbitrary 2D triangulation (P2 through ``from_space``) or 3D
    tetrahedralization. CG when symmetric (b is None), BiCGStab otherwise,
    preconditioned as MatrixFreePoisson chooses ("banded_mg" or the
    auxiliary grid over the dof coordinates; the band plan rejects P2's
    nodes-then-edges numbering).

    K: None | scalar | (d, d) | upper-triangle tuple ((kxx, kxy, kyy) in
    2D, (kxx, kxy, kxz, kyy, kyz, kzz) in 3D) | (C,) | callable(centroids);
    b: None | (d,) | component tuple | callable; c: None | scalar | (C,) |
    callable. nodes: (N, d) or a tuple of d (N,) coordinate tensors; the
    coordinate dtype is the operator's. gather_kernel: "xla" (ELL SpMV in
    the model's precision) or "lane" (float32 inner solves with refinement,
    when the operator stays on the aux-grid path; the banded path ignores
    it). aux_kernel: "xla" or "lane" (with gather_kernel="lane" on the
    aux-grid path of a 2D mesh: the aux grid as ``LaneAuxGrid``, over a
    grid of ``lane_friendly_grid_n`` cells a side unless grid_n is given;
    in 3D, as in JAX, it changes nothing).
    """

    def __init__(self, nodes, cells, boundary, order: int = 1, K=None,
                 b=None, c=None, max_degree: int | None = None,
                 grid_n: int | None = None, bbox=None,
                 format: str = "ell", max_cols: int | None = None,
                 preconditioner: str = "auto", split_plan=None,
                 gather_kernel: str = "xla", aux_kernel: str = "xla",
                 device="cuda", _space=None):
        if gather_kernel not in _KERNELS:
            raise ValueError(f"gather_kernel must be one of {_KERNELS}, got {gather_kernel!r}")
        if aux_kernel not in _KERNELS:
            raise ValueError(f"aux_kernel must be one of {_KERNELS}, got {aux_kernel!r}")
        if aux_kernel == "lane" and gather_kernel != "lane":
            raise ValueError("aux_kernel='lane' needs gather_kernel='lane'")

        if isinstance(nodes, tuple):
            coords = [torch.as_tensor(v, device=device) for v in nodes]
        else:
            nodes = torch.as_tensor(nodes, device=device)
            coords = [nodes[:, d] for d in range(nodes.shape[1])]
        dim = len(coords)
        if dim not in (2, 3):
            raise ValueError(f"2D/3D only, got embedding dim {dim}")
        if max_degree is None:
            max_degree = 8 if dim == 2 else 24
        dtype = coords[0].dtype
        if _space is None:
            if order != 1:
                raise ValueError("order=2 needs a dof table: use from_space(space, ...)")
            dofs = torch.as_tensor(cells, device=device).to(torch.int32).T.contiguous()  # (d+1, C)
            n_dofs = coords[0].shape[0]
            dof_coords = coords
        else:  # the space decides the dofs: its order, its (nb, C) table
            # (nodes then edges for P2) and their coordinates; cells unused
            if dim != 2:
                raise ValueError("from_space is 2D-only")
            order = _space.order
            dofs = torch.as_tensor(_space.dofs.T, device=device).to(torch.int32).contiguous()
            n_dofs = _space.n_dofs
            dc = torch.as_tensor(_space.dof_coords, device=device).to(dtype)
            dof_coords = [dc[:, 0], dc[:, 1]]
        self.dof_x, self.dof_y = dof_coords[0], dof_coords[1]
        if dim == 3:
            self.dof_z = dof_coords[2]
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
        knames = (("kxx", "kxy", "kyy") if dim == 2
                  else ("kxx", "kxy", "kxz", "kyy", "kyz", "kzz"))
        coef = dict(zip(knames, ktri))
        coef.update(zip(("bx", "by", "bz")[:dim], badv))
        coef["react"] = react

        self.order = order
        self.dim = dim
        self.n_dofs = n_dofs
        self.boundary = torch.as_tensor(boundary, device=device).to(torch.bool)
        self.format = format
        self.is_symmetric = all(v is None for v in badv)
        if max_cols is None and format == "ell":
            # 2D P1: neighbours + self; P2 vertex rows: 1 + deg + 2 deg;
            # 3D P1: the Euler bound on the vertex link, 2 + F/2 neighbours
            # for F incident tets, + self + 1 for boundary links
            if dim == 3:
                max_cols = max_degree // 2 + 4
            else:
                max_cols = max_degree + 1 if order == 1 else 3 * max_degree + 1

        if dim == 3:
            mf, over = MatrixFreeSoA3D.build_general(*coords, *dofs, n_dofs, max_degree, **coef)
        elif order == 1:
            mf, over = MatrixFreeSoA.build_general(*coords, *dofs, n_dofs, max_degree, **coef)
        else:
            mf, over = MatrixFreeP2SoA.build(*coords, dofs, n_dofs, max_degree, **coef)
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
        self.op, self.preconditioner = _route(self.op, self.boundary, format, preconditioner,
                                              split_plan, dim)
        self.system = DirichletSystem(self.op, self.boundary)
        if self.preconditioner == "banded_mg":
            self.aux = _banded_mg(self.op, self.boundary)
        if gather_kernel == "lane" and format == "ell" and self.preconditioner == "auxgrid":
            # float32 copy of the ELL for the inner solves; the
            # full-precision ELL stays as op_ref for the outer residuals
            self.op_ref = self.op
            lane_src = (self.op.astype(torch.float32)
                        if self.op.vals.dtype == torch.float64 else self.op)
            self.op = LaneRoutedELL.from_ell(lane_src)
            self.system = DirichletSystem(self.op_ref, self.boundary)
            self.preconditioner = "auxgrid+lane"
        if self.preconditioner.startswith("auxgrid"):
            lane_aux = (aux_kernel == "lane" and dim == 2
                        and self.preconditioner == "auxgrid+lane")
            if lane_aux and grid_n is None:
                grid_n = lane_friendly_grid_n(n_dofs)
            self.aux = _aux_grid(dof_coords, _aux_diag32(self.op, self.boundary), grid_n, bbox)
            if lane_aux:
                self.aux = LaneAuxGrid.from_aux(self.aux)

    @classmethod
    def from_space(cls, space, K=None, b=None, c=None, **kw):
        """Build from a host FEMSpace of order 1 or 2 on a 2D mesh: the dof
        table, the boundary dofs and the dof coordinates come from the
        space."""
        if space.order not in (1, 2):
            raise ValueError(f"from_space takes order 1 or 2, got {space.order}")
        return cls(space.mesh.nodes, None, space.boundary_dofs, K=K, b=b, c=c, _space=space, **kw)

    def load_vector(self, f_cells):
        """Load vector from per-cell forcing values (centroid rule): P1
        b_a = sum_T |T|/(d+1) f over the cells incident to a; P2 |T|/3 on
        the edge dofs, 0 on the vertex dofs."""
        return _load_vector(
            self._coords, self.dofs, self.adj, self.adj_mask,
            torch.as_tensor(f_cells, device=self.dof_x.device), self.order,
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
    """Implicit-Euler heat stepping on the gather pipeline, P1 on 2D or 3D
    meshes, lumped mass (lumping.h:30: the P1 row-sum lumped mass is the
    load vector of 1, sum_T |T|/(d+1) over the incident cells).

    Each step solves (A + M_L / dt) u_next = M_L u / dt + f with the
    operator of MatrixFreePoisson (the other keyword arguments are its
    own): when the band plan accepts the operator, the shifted operator is
    the banded split (the shift changes only its centre layer) with a
    BandedMGPreconditioner of its float32 Dirichlet fold; otherwise the ELL
    with an aux grid built on the device from the shifted diagonal (its
    grid stencil is the unshifted Laplacian, as in JAX, so its iterations
    grow with n at dt ~ h^2). Only the shifted operator's preconditioner is
    built. The steps are a host loop of CG solves, each warm-started from
    the last instant (fem_linear_parabolic_solver.h:37-72 factorizes once;
    here the preconditioner build is the one-time cost).
    """

    def __init__(self, nodes, cells, boundary, dt: float, kappa=None, grid_n=None, bbox=None,
                 **kw):
        _p1_operator(self, nodes, cells, boundary, kappa=kappa, **kw)
        self.dt = float(dt)
        ones = torch.ones(self.cells.shape[0], dtype=self.nodes.dtype, device=self.nodes.device)
        self.mdiag = self.load_vector(ones)  # lumped mass
        self.op = self.op.with_added_diagonal(self.mdiag / self.dt)
        if self.preconditioner == "banded_mg":
            self.aux = _banded_mg(self.op, self.boundary)
        else:
            self.aux = _aux_grid([self.nodes[:, d] for d in range(self.dim)],
                                 self.op.diagonal().to(torch.float32), grid_n, bbox)

    load_vector = MatrixFreePoisson.load_vector

    def step(self, u, f=None, g=None, rtol: float = 1e-9, maxiter: int = 100,
             chunk: int | None = None, on_chunk=None):
        """One implicit-Euler step. f: the assembled load vector (n,) at the
        next instant (load_vector) or None; g: Dirichlet data at the next
        instant (default 0). Returns (u_next, iterations, true relative
        residual)."""
        if g is None:
            g = torch.zeros_like(u)
        b = self.mdiag * u / self.dt
        if f is not None:
            b = b + f
        if chunk is not None:
            return _solve_chunked(self.op, self.boundary, self.aux, b, g, True, rtol, maxiter,
                                  chunk, on_chunk, u0=u)
        return _solve(self.op, self.boundary, self.aux, b, g, True, rtol, maxiter, u0=u)

    def solve(self, u0, n_steps: int, f=None, g=None, rtol: float = 1e-9,
              maxiter: int = 100, chunk: int | None = None,
              keep_trajectory: bool = False, on_step=None):
        """March n_steps from u0 with constant-in-time f and g (drive
        ``step`` for data that varies). Returns (u_final, info) with the
        per-step "iterations" and "rel_residuals" (host numbers); with
        keep_trajectory=True also "trajectory", (n, n_steps); on_step(k, u,
        iterations, rel) is called after every step."""
        u = torch.as_tensor(u0)
        iters, rels, traj = [], [], []
        for k in range(n_steps):
            u, it, rel = self.step(u, f=f, g=g, rtol=rtol, maxiter=maxiter, chunk=chunk)
            iters.append(int(it))
            rels.append(float(rel))
            if keep_trajectory:
                traj.append(u)
            if on_step is not None:
                on_step(k, u, iters[-1], rels[-1])
        info = {"iterations": iters, "rel_residuals": rels}
        if keep_trajectory:
            info["trajectory"] = torch.stack(traj, dim=1)
        return u, info
