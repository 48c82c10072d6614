"""Batched FEM assembly: quadrature contraction + fixed-order scatter.

Port of ``fdapde_core_tpu/fem/assembler.py`` (the counterpart of
fdaPDE-core's serial assembly loop, fem_assembler.h:79-110). All cells are
processed at once,

    local[c,i,j] = measure[c] * sum_q w[q] * weak_form(c, q, i, j),

as einsum contractions, followed by one scatter into the sorted-COO slots
of ``space.scatter`` (the `setFromTriplets` scatter-add of
fem_assembler.h:112).

Weak forms (signs match the reference operator headers):
- Laplacian:  -(invJ^T grad_i) . (invJ^T grad_j)
- Diffusion:  -(invJ^T grad_i) . K (invJ^T grad_j)
- Advection:   psi_i * b . (invJ^T grad_j)
- Reaction:    c * psi_i * psi_j
- dt: zero spatial contribution
Matrix rows are test functions i, columns trial functions j.

The Laplacian term of a 2D P1 space (M = N = 2, 3 basis functions) takes
the closed-form kernel K6 (``ops/local_stiffness.p1_stiffness_2d``,
``csrc/p1_local_stiffness.cu``) on the (6, C) vertex coordinates; it gives
the positive form, which ``local_matrices`` negates as the einsum form is
negated. Every other term, order and dimension uses the einsum form.

Layout: the device path keeps local matrices cell-last, (nb, nb, C) (K6
writes (9, C)), and scatters them with the space's fixed-order
``SegmentSum`` tables, built once per space from ``space.scatter``'s
inverse permuted to that order. ``local_matrices`` keeps JAX's (C, nb, nb)
shape, as a view where K6 computed it. The scatter adds in a fixed order,
so an assembly is the same from run to run on CUDA.

Spans (``utils.profiling``): each call of ``assemble_matrix`` and
``assemble_forcing`` is three stages, in this order: ``assembly.upload``
(the host inputs to the device: coefficients or forcing values evaluated
on the host, the mesh and the basis tables), ``assembly.local`` (the
affine maps and the local matrices or vectors) and ``assembly.scatter``
(the host scatter tables, built once per space, the fixed-order segment
sum and, for a matrix, its pattern on the device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.affine import affine_maps
from ..linear_algebra.sparse import SparseMatrix
from ..ops.local_stiffness import p1_stiffness_2d
from ..pde.operators import Advection, BiLaplacian, Diffusion, Laplacian, Reaction
from ..utils.profiling import span

__all__ = ["assemble_dia", "assemble_forcing", "assemble_matrix", "local_matrices",
           "prepare_coefficient"]


def prepare_coefficient(space, value, kind: str, dtype=torch.float64, device="cuda"):
    """Normalize an operator coefficient to a constant or a per-(cell,
    quad-node) tensor.

    Accepted inputs: scalars/constant arrays; callables f(x) evaluated at
    the physical quadrature nodes; arrays indexed by global quadrature node
    ``nq * cell + q``. Returns (is_varying, tensor) with shapes
      scalar: () or (C, nq); vector: (N,) or (C, nq, N); matrix: (N, N) or
      (C, nq, N, N).
    """
    C = space.mesh.n_cells
    nq = space.n_quad
    N = space.mesh.embed_dim

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    if callable(value):
        from ..utils.callables import eval_at_points

        vals = eval_at_points(value, space.quadrature_nodes)  # batch -> constant -> loop
        return True, tensor(vals.reshape((C, nq) + vals.shape[1:]))
    arr = np.asarray(value, dtype=np.float64)
    if kind == "scalar":
        return (False, tensor(arr)) if arr.ndim == 0 else (True, tensor(arr.reshape(C, nq)))
    if kind == "vector":
        return (False, tensor(arr)) if arr.ndim == 1 else (True, tensor(arr.reshape(C, nq, N)))
    if kind == "matrix":
        return (False, tensor(arr)) if arr.ndim == 2 else (True, tensor(arr.reshape(C, nq, N, N)))
    raise ValueError(kind)


def local_matrices(term_kind, coeff, varying, phi, grad, w, invJ, measure, coords_t=None):
    """Local (C, nb, nb) matrices for one operator term.

    coords_t: the (6, C) vertex coordinates (rows x1, y1, x2, y2, x3, y3)
    of a 2D P1 space; given, the Laplacian term comes from K6 (a
    (C, 3, 3) view of its (9, C) output) instead of the einsum."""
    if term_kind == "laplacian" and coords_t is not None:
        C = coords_t.shape[1]
        return (-p1_stiffness_2d(coords_t)).T.reshape(C, 3, 3)
    # physical gradients: pg[c,q,i,n] = sum_m invJ[c,m,n] * grad[q,i,m]
    if term_kind in ("laplacian", "diffusion", "advection"):
        pg = torch.einsum("cmn,qim->cqin", invJ, grad)
    if term_kind == "laplacian":
        out = -torch.einsum("cqin,cqjn,q->cij", pg, pg, w)
    elif term_kind == "diffusion":
        if varying:
            out = -torch.einsum("cqin,cqnk,cqjk,q->cij", pg, coeff, pg, w)
        else:
            out = -torch.einsum("cqin,nk,cqjk,q->cij", pg, coeff, pg, w)
    elif term_kind == "advection":
        if varying:
            out = torch.einsum("qi,cqjn,cqn,q->cij", phi, pg, coeff, w)
        else:
            out = torch.einsum("qi,cqjn,n,q->cij", phi, pg, coeff, w)
    elif term_kind == "reaction":
        if varying:
            out = torch.einsum("cq,qi,qj,q->cij", coeff, phi, phi, w)
        else:
            out = (coeff * torch.einsum("qi,qj,q->ij", phi, phi, w))[None, :, :]
    else:
        raise ValueError(term_kind)
    return out * measure[:, None, None]


_KIND = {
    Laplacian: ("laplacian", None),
    Diffusion: ("diffusion", "matrix"),
    Advection: ("advection", "vector"),
    Reaction: ("reaction", "scalar"),
}


def _mesh_tensors(space, dtype, device):
    """(nodes, cells, phi, grad, w) of the space on the device."""
    def f(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    cells = torch.as_tensor(space.mesh.cells, device=device).long()
    return f(space.mesh.nodes), cells, f(space.phi_tab), f(space.grad_tab), f(space.quad.weights)


def _p1_2d_coords(space, nodes, cells):
    """(6, C) vertex coordinates for K6, or None when the space is not 2D P1."""
    mesh = space.mesh
    if space.order != 1 or mesh.local_dim != 2 or mesh.embed_dim != 2:
        return None
    return nodes.T[:, cells.T].transpose(0, 1).reshape(6, -1)


def assemble_matrix(space, op, layout: str = "aos", dtype=torch.float64,
                    device="cuda") -> SparseMatrix:
    """Discretize a DifferentialOp over a FEMSpace -> sparse n_dofs^2 matrix
    on ``device`` (counterpart of Assembler::discretize_operator,
    fem_assembler.h:52-120).

    ``layout="soa"`` is the same assembly: JAX routes it through a
    cell-axis-last path (ops/soa_assembly.py) because (C, nq, nb, N)
    intermediates tile-pad ~50x in TPU memory beyond ~1M cells, a limit of
    the TPU's tiled layout that this port does not have.
    """
    if layout not in ("aos", "soa"):
        raise ValueError(f"layout must be 'aos' or 'soa', got {layout!r}")
    with span("assembly.upload"):
        terms = []
        for scale, leaf in op.spatial_terms:
            if isinstance(leaf, BiLaplacian):
                raise ValueError("bilaplacian requires the SPLINE discretization (splines/)")
            kind, ckind = _KIND[type(leaf)]
            if isinstance(leaf, Laplacian):
                varying, coeff = False, None
            else:
                cval = leaf.K if kind == "diffusion" else leaf.b if kind == "advection" else leaf.c
                varying, coeff = prepare_coefficient(space, cval, ckind, dtype, device)
            terms.append((scale, kind, varying, coeff))
        nodes, cells, phi, grad, w = _mesh_tensors(space, dtype, device)

    with span("assembly.local"):
        coords_t = _p1_2d_coords(space, nodes, cells)
        if any(kind != "laplacian" or coords_t is None for _, kind, _, _ in terms):
            _, invJ, measure = affine_maps(nodes, cells)
        else:
            invJ = measure = None  # K6 needs neither
        nb = space.n_basis_per_cell
        local = torch.zeros((nb, nb, space.mesh.n_cells), dtype=dtype, device=device)
        for scale, kind, varying, coeff in terms:
            term = local_matrices(kind, coeff, varying, phi, grad, w, invJ, measure, coords_t)
            local = local + scale * term.permute(1, 2, 0)

    with span("assembly.scatter"):
        rows, cols, _ = space.scatter
        vals = space.segment_sum("matrix", device)(local.reshape(-1))
        return SparseMatrix(torch.as_tensor(rows, device=device),
                            torch.as_tensor(cols, device=device), vals,
                            (space.n_dofs, space.n_dofs))


def assemble_dia(space, op, dtype=torch.float64, device="cuda"):
    """Discretize into DIA (offset-diagonal) storage on ``device``: the
    sparse assembly (K6 for the 2D P1 Laplacian), then one fixed-order sum
    into the diagonals of ``unique_offsets(space.dofs)``. Products run on
    the K7 kernel (``linear_algebra/dia.py``). Efficient when the dof
    numbering gives a small offset set (structured or banded meshes: check
    ``len(unique_offsets(space.dofs))`` first)."""
    from ..linear_algebra.dia import dia_from_coo, unique_offsets

    A = assemble_matrix(space, op, dtype=dtype, device=device)
    rows, cols, _ = space.scatter  # A's pattern on the host: no copy back
    return dia_from_coo(rows, cols, A.vals, space.n_dofs, unique_offsets(space.dofs))


def assemble_forcing(space, f, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Discretize a forcing term: F[i] = int f * psi_i (counterpart of
    Assembler::discretize_forcing, fem_assembler.h:122-136).

    ``f`` may be a callable, or values at the physical quadrature nodes with
    rows ``nq * cell + q`` (one column, or one per time instant: then the
    result is (n_dofs, T)).
    """
    C, nq = space.mesh.n_cells, space.n_quad
    with span("assembly.upload"):
        if callable(f):
            from ..utils.callables import eval_at_points

            fv = np.asarray(eval_at_points(f, space.quadrature_nodes)).reshape(C, nq)
        else:
            fv = np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f, dtype=np.float64)
            if fv.ndim == 1 or fv.shape[1] == 1:
                fv = fv.reshape(C, nq)
            else:
                fv = fv.reshape(C, nq, -1)
        fv = torch.as_tensor(fv, device=device).to(dtype)
        nodes, cells, phi, _, w = _mesh_tensors(space, dtype, device)

    with span("assembly.local"):
        _, _, measure = affine_maps(nodes, cells)
        if fv.dim() == 3:
            loc = torch.einsum("cqt,qi,q->ict", fv, phi, w) * measure[None, :, None]
            flat = loc.reshape(C * space.n_basis_per_cell, -1)
        else:
            loc = torch.einsum("cq,qi,q->ic", fv, phi, w) * measure[None, :]
            flat = loc.reshape(-1)

    with span("assembly.scatter"):
        return space.segment_sum("forcing", device)(flat)
