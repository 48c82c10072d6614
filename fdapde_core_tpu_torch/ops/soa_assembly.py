"""Struct-of-arrays (cell axis last) assembly: affine maps, local matrices
and the assembled values, as (C,) tensors per entry.

Port of ``fdapde_core_tpu/ops/soa_assembly.py``. Every per-cell quantity
is a (C,) tensor and the small nq / nb / N axes are unrolled into scalar
weights, so ``affine_maps_soa`` and ``local_matrices_soa`` return nested
lists of (C,) tensors in JAX's C-last layout. ``assemble_soa_values`` sums
them into the sparse pattern of ``space.scatter`` with the space's
fixed-order ``SegmentSum`` (no atomics), the same sum
``fem/assembler.assemble_matrix`` takes. JAX needs this path because
(C, nq, nb, N) intermediates tile-pad in TPU memory; the port's
``assemble_matrix(layout="soa")`` keeps its one route, and this module
serves callers of the C-last functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["affine_maps_soa", "local_matrices_soa", "assemble_soa_values"]


def gather_coords_soa(nodes, cells_t):
    """coords[v][d]: (C,) vertex coordinates; cells_t (k, C)."""
    k = cells_t.shape[0]
    N = nodes.shape[1]
    return [[nodes[:, d][cells_t[v]] for d in range(N)] for v in range(k)]


def affine_maps_soa(nodes, cells_t):
    """C-last affine maps (J, invJ, measure): J[n][m] and invJ[m][n] (C,)
    tensors, measure (C,). M == N in {1, 2, 3}, and the manifold cases
    (2, 3), (1, 2), (1, 3) through the Gram pseudo-inverse
    (simplex.h:184-195)."""
    coords = gather_coords_soa(nodes, cells_t)
    k = len(coords)  # M + 1 vertices
    N = len(coords[0])
    M = k - 1
    J = [[coords[m + 1][n] - coords[0][n] for m in range(M)] for n in range(N)]
    if M != N:
        # Gram pseudo-inverse: invJ = (J^T J)^{-1} J^T  (simplex.h:190)
        G = [[sum(J[n][m1] * J[n][m2] for n in range(N)) for m2 in range(M)]
             for m1 in range(M)]
        if M == 1:
            detG = G[0][0]
            invG = [[1.0 / detG]]
            measure = torch.sqrt(detG)  # segment length (simplex.h:192)
        elif M == 2:
            detG = G[0][0] * G[1][1] - G[0][1] * G[1][0]
            invG = [[G[1][1] / detG, -G[0][1] / detG],
                    [-G[1][0] / detG, G[0][0] / detG]]
            measure = 0.5 * torch.sqrt(detG)  # 0.5 ||J0 x J1|| (simplex.h:191)
        else:
            raise NotImplementedError((M, N))
        inv = [[sum(invG[m][m2] * J[n][m2] for m2 in range(M)) for n in range(N)]
               for m in range(M)]
        return J, inv, measure
    if M == 1:
        det = J[0][0]
        inv = [[1.0 / det]]
    elif M == 2:
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        inv = [[J[1][1] / det, -J[0][1] / det],
               [-J[1][0] / det, J[0][0] / det]]
    elif M == 3:
        c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
        c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
        c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
        det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02
        c10 = J[0][2] * J[2][1] - J[0][1] * J[2][2]
        c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0]
        c12 = J[0][1] * J[2][0] - J[0][0] * J[2][1]
        c20 = J[0][1] * J[1][2] - J[0][2] * J[1][1]
        c21 = J[0][2] * J[1][0] - J[0][0] * J[1][2]
        c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        inv = [[c00 / det, c10 / det, c20 / det],
               [c01 / det, c11 / det, c21 / det],
               [c02 / det, c12 / det, c22 / det]]
    else:
        raise NotImplementedError(M)
    measure = torch.abs(det) / math.factorial(M)
    return J, inv, measure


def local_matrices_soa(kind, coeff, nodes, cells_t, phi_tab, grad_tab, w, coeff_q=None):
    """(nb, nb) grid of (C,) local-matrix entries for one operator term.

    kind: "laplacian", "diffusion", "advection" or "reaction"; coeff its
    constant coefficient (K (N, N), b (N,), c) or None. Space-varying
    coefficients come as ``coeff_q`` (then coeff is ignored): reaction
    coeff_q[q] (C,); advection coeff_q[q][n]; diffusion coeff_q[q][n1][n2].
    phi_tab (nq, nb), grad_tab (nq, nb, M), w (nq,): host constants.
    """
    phi_tab = np.asarray(phi_tab)
    grad_tab = np.asarray(grad_tab)
    w = np.asarray(w)
    nq, nb = phi_tab.shape
    M = grad_tab.shape[2]
    J, inv, measure = affine_maps_soa(nodes, cells_t)
    N = len(inv[0])

    if kind == "reaction":
        if coeff_q is not None:
            out = [[None] * nb for _ in range(nb)]
            for i in range(nb):
                for j in range(nb):
                    acc = None
                    for q in range(nq):
                        s = float(phi_tab[q, i] * phi_tab[q, j] * w[q])
                        if s == 0.0:
                            continue
                        term = coeff_q[q] * s
                        acc = term if acc is None else acc + term
                    out[i][j] = acc * measure
            return out
        c = 1.0 if coeff is None else float(coeff)
        gram = phi_tab.T @ (w[:, None] * phi_tab)  # (nb, nb) scalars
        return [[c * gram[i, j] * measure for j in range(nb)] for i in range(nb)]

    def pg(q, i, n):
        """Physical gradient sum_m invJ[m][n] grad_tab[q, i, m]."""
        acc = None
        for m in range(M):
            gqim = float(grad_tab[q, i, m])
            if gqim == 0.0:
                continue
            term = inv[m][n] * gqim
            acc = term if acc is None else acc + term
        return acc if acc is not None else 0.0

    out = [[None for _ in range(nb)] for _ in range(nb)]
    if kind in ("laplacian", "diffusion"):
        K = (None if (kind == "laplacian" or coeff_q is not None)
             else np.asarray(coeff, dtype=np.float64))
        for i in range(nb):
            for j in range(nb):
                acc = None
                for q in range(nq):
                    for n1 in range(N):
                        a = pg(q, i, n1)
                        if kind == "laplacian":
                            term = a * pg(q, j, n1) * float(w[q])
                        else:
                            term = None
                            for n2 in range(N):
                                kval = (coeff_q[q][n1][n2] if coeff_q is not None
                                        else float(K[n1, n2]))
                                if coeff_q is None and kval == 0.0:
                                    continue
                                t2 = pg(q, j, n2) * kval
                                term = t2 if term is None else term + t2
                            if term is None:
                                continue
                            term = a * term * float(w[q])
                        acc = term if acc is None else acc + term
                out[i][j] = -(acc) * measure  # leading minus (laplacian.h:37-44)
        return out
    if kind == "advection":
        b = None if coeff_q is not None else np.asarray(coeff, dtype=np.float64)
        for i in range(nb):
            for j in range(nb):
                acc = None
                for q in range(nq):
                    scal = float(phi_tab[q, i] * w[q])
                    if scal == 0.0:
                        continue
                    term = None
                    for n1 in range(N):
                        bval = coeff_q[q][n1] if coeff_q is not None else float(b[n1])
                        if coeff_q is None and bval == 0.0:
                            continue
                        t2 = pg(q, j, n1) * bval
                        term = t2 if term is None else term + t2
                    if term is None:
                        continue
                    term = term * scal
                    acc = term if acc is None else acc + term
                out[i][j] = acc * measure
        return out
    raise ValueError(kind)


def assemble_soa_values(space, op, nodes=None, cells_t=None, device="cuda"):
    """Sparse values of the operator through the SoA path, in the slot
    order of ``space.scatter``: (nnz,) values for SparseMatrix(rows, cols,
    vals) with space.scatter's rows and cols. nodes / cells_t default to
    the space's mesh on ``device`` (float64)."""
    from ..fem.assembler import prepare_coefficient
    from ..pde.operators import Advection, Diffusion, Laplacian, Reaction

    if nodes is None:
        nodes = torch.as_tensor(space.mesh.nodes, device=device)
    device = nodes.device
    if cells_t is None:
        cells_t = torch.as_tensor(space.mesh.cells.T, device=device).long()
    nb = space.n_basis_per_cell
    grid = None
    for scale, leaf in op.spatial_terms:
        if isinstance(leaf, Laplacian):
            kind, coeff, ckind = "laplacian", None, None
        elif isinstance(leaf, Diffusion):
            kind, coeff, ckind = "diffusion", leaf.K, "matrix"
        elif isinstance(leaf, Advection):
            kind, coeff, ckind = "advection", leaf.b, "vector"
        elif isinstance(leaf, Reaction):
            kind, coeff, ckind = "reaction", leaf.c, "scalar"
        else:
            raise ValueError(leaf)
        # space-varying coefficients: (C, nq, ...) -> per-quadrature-node
        # lists of (C,) tensors (cell axis last)
        coeff_q = None
        if coeff is not None and ckind is not None:
            varying, cval = prepare_coefficient(space, coeff, ckind, nodes.dtype, device)
            if varying:
                nq = space.n_quad
                if ckind == "scalar":
                    coeff_q = [cval[:, q] for q in range(nq)]
                elif ckind == "vector":
                    coeff_q = [[cval[:, q, n] for n in range(cval.shape[2])] for q in range(nq)]
                else:
                    coeff_q = [[[cval[:, q, n1, n2] for n2 in range(cval.shape[3])]
                                for n1 in range(cval.shape[2])] for q in range(nq)]
                coeff = None
            else:
                coeff = cval.cpu().numpy()
        term = local_matrices_soa(kind, coeff, nodes, cells_t, space.phi_tab, space.grad_tab,
                                  space.quad.weights, coeff_q=coeff_q)
        if grid is None:
            grid = [[scale * term[i][j] for j in range(nb)] for i in range(nb)]
        else:
            grid = [[grid[i][j] + scale * term[i][j] for j in range(nb)] for i in range(nb)]
    local = torch.stack([torch.stack(row) for row in grid])  # (nb, nb, C)
    return space.segment_sum("matrix", device)(local.reshape(-1))
