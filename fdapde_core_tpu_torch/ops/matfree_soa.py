"""SoA (cell axis last) general gather pipeline: 2D P1 and P2, 3D P1.

Port of ``fdapde_core_tpu/ops/matfree_soa.py``: per-cell closed-form local
stiffness from per-corner (C,) gathers, a (D, n) slot-major incidence
table, the matrix-free operator over it, and its conversion to an
assembled (K, n) row-ELL, ``ELLSoA`` (defined beside K2 in
``ops/gather_spmv.py``, re-exported here under JAX's module). The P2
operator (``MatrixFreeP2SoA``) stores the same three per-cell scalars
as P1 and rebuilds its 6 x 6 local matrix from universal tables
(``_p2_tables``) in every product. The tet operator (``MatrixFreeSoA3D``)
stores six off-diagonals per cell, the diagonal coming from the zero row
sums of its diffusion part.

Index types follow the JAX package: corner ids, incidence positions and ELL
columns are int32 (the largest intermediate, ``(slot*nb + j)*C + cell``,
is about 1.8e8 at 20.48M cells). ``torch.argsort``/``torch.sort`` return
int64 indices, which are cast to int32 or freed at once.
"""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

from .gather_spmv import ELLSoA, ell_warp_widths

__all__ = [
    "p1_offdiag_soa",
    "p1_general_soa",
    "p1_general_soa_3d",
    "p2_primitives_soa",
    "build_adjacency_soa",
    "MatrixFreeSoA",
    "MatrixFreeSoA3D",
    "MatrixFreeP2SoA",
    "ELLSoA",
    "ell_from_op_blocked",
]


def p1_offdiag_soa(x, y, c0, c1, c2, kappa=None):
    """Off-diagonal P1 stiffness entries (s01, s02, s12), each (C,).

    x, y: (N,) node coordinates; c0, c1, c2: (C,) corner ids. The local
    matrix is symmetric with zero row sums, a_ii = -(s_ij + s_ik).
    """
    x0, x1, x2 = x[c0], x[c1], x[c2]
    y0, y1, y2 = y[c0], y[c1], y[c2]
    e0x, e0y = x1 - x0, y1 - y0
    e1x, e1y = x2 - x0, y2 - y0
    det = e0x * e1y - e0y * e1x
    scale = 0.5 * torch.sign(det) / det  # area / det^2
    if kappa is not None:
        scale = scale * kappa
    # g1 = (e1y, -e1x)/det, g2 = (-e0y, e0x)/det, g0 = -(g1 + g2)
    g12 = -(e1y * e0y + e1x * e0x)  # det^2 * (g1 . g2)
    g11 = e1y * e1y + e1x * e1x
    g22 = e0y * e0y + e0x * e0x
    s12 = scale * g12
    s01 = scale * (-(g11 + g12))  # g0 . g1 = -(g1.g1 + g2.g1)
    s02 = scale * (-(g12 + g22))
    return s01, s02, s12


def p1_general_soa(x, y, c0, c1, c2, kxx=None, kxy=None, kyy=None,
                   bx=None, by=None, react=None):
    """Per-cell primitives of the P1 advection-diffusion-reaction local
    matrix

        A_ij = area (g_i . K g_j) + (area/3) (b . g_j) + c area/12 (1 + d_ij)

    with per-cell (C,) coefficients or None (kxx alone: isotropic).
    Returns (sd, w, r): sd (3, C) diffusion off-diagonals (s01, s02, s12),
    w (3, C) advection column weights or None, r (C,) reaction weight
    c*area/12 or None.
    """
    x0, x1, x2 = x[c0], x[c1], x[c2]
    y0, y1, y2 = y[c0], y[c1], y[c2]
    e0x, e0y = x1 - x0, y1 - y0
    e1x, e1y = x2 - x0, y2 - y0
    det = e0x * e1y - e0y * e1x
    sgn = torch.sign(det)
    scale = 0.5 * sgn / det  # area / det^2
    # det * gradients: G1 = (e1y, -e1x), G2 = (-e0y, e0x), G0 = -(G1 + G2)
    g1x, g1y = e1y, -e1x
    g2x, g2y = -e0y, e0x
    g0x, g0y = -(g1x + g2x), -(g1y + g2y)
    if kxx is None:
        kxx = 1.0
    if kyy is None:
        kyy = kxx  # isotropic when only kxx given
    if kxy is None:
        kxy = 0.0

    def KG(gx, gy):
        return kxx * gx + kxy * gy, kxy * gx + kyy * gy

    k1x, k1y = KG(g1x, g1y)
    k2x, k2y = KG(g2x, g2y)
    s01 = scale * (g0x * k1x + g0y * k1y)
    s02 = scale * (g0x * k2x + g0y * k2y)
    s12 = scale * (g1x * k2x + g1y * k2y)
    sd = torch.stack([s01, s02, s12])

    w = None
    if bx is not None or by is not None:
        bx = 0.0 if bx is None else bx
        by = 0.0 if by is None else by
        # (area/3)(b . g_j) = sgn/6 * (b . G_j)
        w = torch.stack([
            (sgn / 6.0) * (bx * g0x + by * g0y),
            (sgn / 6.0) * (bx * g1x + by * g1y),
            (sgn / 6.0) * (bx * g2x + by * g2y),
        ])

    r = None
    if react is not None:
        area = 0.5 * sgn * det
        r = react * area / 12.0
    return sd, w, r


def build_adjacency_soa(flat, n_dofs: int, max_degree: int):
    """(D, n) incidence table of a flat slot-major position array.

    flat: (P,) dof id of each element-local position (P = nb * C, position
    p = slot * C + cell). Returns adj (D, n) int32 positions into flat,
    mask (D, n) bool, and whether a dof has more than D incidences (a
    0-dim bool tensor).
    """
    order = torch.argsort(flat, stable=True).to(torch.int32)
    sorted_d = flat[order]
    ids = torch.arange(n_dofs, dtype=flat.dtype, device=flat.device)
    starts = torch.searchsorted(sorted_d, ids, out_int32=True)
    ends = torch.searchsorted(sorted_d, ids + 1, out_int32=True)
    del sorted_d
    counts = ends - starts
    k = torch.arange(max_degree, dtype=torch.int32, device=flat.device)[:, None]
    idx = starts[None, :] + k
    mask = k < counts[None, :]
    adj = order[torch.clamp(idx, 0, flat.shape[0] - 1)]
    return adj, mask, torch.any(counts > max_degree)


def _combine(per_slot, adj, adj_mask):
    """Sum slot-major per-cell values, one (C,) tensor a slot, over each
    dof's incidences."""
    flat = torch.cat(per_slot)
    return (flat[adj] * adj_mask.to(flat.dtype)).sum(dim=0)


class MatrixFreeSoA:
    """Matrix-free P1 operator in SoA layout.

    s: (3, C) off-diagonals (s01, s02, s12); c: (3, C) corner ids;
    adj/adj_mask: (D, n) slot-major incidence; w: (3, C) advection column
    weights or None; r: (C,) reaction weight or None. Operator protocol
    (@, diagonal) of fem/solvers.DirichletSystem.
    """

    def __init__(self, s, c, adj, adj_mask, n_dofs: int, w=None, r=None):
        self.s = s
        self.c = c
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs
        self.w = w
        self.r = r

    @classmethod
    def build(cls, x, y, c0, c1, c2, n_dofs: int, max_degree: int, kappa=None):
        """Pure-diffusion operator; returns (op, overflowed)."""
        s = torch.stack(p1_offdiag_soa(x, y, c0, c1, c2, kappa))
        c = torch.stack([c0, c1, c2])
        adj, mask, over = build_adjacency_soa(c.reshape(-1), n_dofs, max_degree)
        return cls(s, c, adj, mask, n_dofs), over

    @classmethod
    def build_general(cls, x, y, c0, c1, c2, n_dofs: int, max_degree: int,
                      kxx=None, kxy=None, kyy=None, bx=None, by=None,
                      react=None):
        """Advection-diffusion-reaction operator (non-symmetric when b is
        given); returns (op, overflowed)."""
        sd, w, r = p1_general_soa(x, y, c0, c1, c2, kxx, kxy, kyy, bx, by, react)
        c = torch.stack([c0, c1, c2])
        adj, mask, over = build_adjacency_soa(c.reshape(-1), n_dofs, max_degree)
        return cls(sd, c, adj, mask, n_dofs, w=w, r=r), over

    @property
    def is_symmetric(self):
        return self.w is None

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    def _entries(self):
        """The 9 local-matrix entries, (3, 3) of (C,) tensors."""
        s01, s02, s12 = self.s[0], self.s[1], self.s[2]
        a00 = -(s01 + s02)
        a11 = -(s01 + s12)
        a22 = -(s02 + s12)
        A = [[a00, s01, s02], [s01, a11, s12], [s02, s12, a22]]
        if self.w is not None:
            for i in range(3):
                for j in range(3):
                    A[i][j] = A[i][j] + self.w[j]
        if self.r is not None:
            for i in range(3):
                for j in range(3):
                    A[i][j] = A[i][j] + (2.0 if i == j else 1.0) * self.r
        return A

    def __matmul__(self, v):
        xe = [v[self.c[j]] for j in range(3)]  # three (C,) gathers
        s01, s02, s12 = self.s[0], self.s[1], self.s[2]
        ye = [
            -(s01 + s02) * xe[0] + s01 * xe[1] + s02 * xe[2],
            s01 * xe[0] - (s01 + s12) * xe[1] + s12 * xe[2],
            s02 * xe[0] + s12 * xe[1] - (s02 + s12) * xe[2],
        ]
        if self.w is not None:  # row-constant: one shared dot per cell
            adv = self.w[0] * xe[0] + self.w[1] * xe[1] + self.w[2] * xe[2]
            ye = [y + adv for y in ye]
        if self.r is not None:
            sx = xe[0] + xe[1] + xe[2]
            ye = [y + self.r * (sx + xe[i]) for i, y in enumerate(ye)]
        return _combine(ye, self.adj, self.adj_mask)

    def diagonal(self):
        s01, s02, s12 = self.s[0], self.s[1], self.s[2]
        d = [-(s01 + s02), -(s01 + s12), -(s02 + s12)]
        if self.w is not None:
            d = [d[i] + self.w[i] for i in range(3)]
        if self.r is not None:
            d = [di + 2.0 * self.r for di in d]
        return _combine(d, self.adj, self.adj_mask)

    def astype(self, dtype):
        return MatrixFreeSoA(
            self.s.to(dtype), self.c, self.adj, self.adj_mask, self.n_dofs,
            w=None if self.w is None else self.w.to(dtype),
            r=None if self.r is None else self.r.to(dtype),
        )

    def to_ell(self, max_cols: int):
        """Assembled (K, n) row-ELL; returns (ELLSoA, overflowed)."""
        return _ell_from_entries(self._entries(), self.c, self.adj,
                                 self.adj_mask, self.n_dofs, max_cols)


def _compact_sorted(cols_all, vals_all, row_ids, n_sentinel: int, max_cols: int):
    """Compact (M, B) column-duplicated candidates into (K, B) ELL rows.

    A stable sort of the columns along the candidate axis carries the values
    with it (the same order as JAX's multi-operand ``lax.sort``, so the
    duplicate-column sums below add in the same order); then K masked sums
    merge the duplicates. Padding carries col = n_sentinel; empty slots
    become (col = row_ids, val = 0). Returns (vals, cols int32, overflowed).
    """
    K = max_cols
    cols_s, order = torch.sort(cols_all, dim=0, stable=True)
    vals_s = torch.gather(vals_all, 0, order)
    del order
    first = torch.ones_like(cols_s, dtype=torch.bool)
    first[1:] = cols_s[1:] != cols_s[:-1]
    real = cols_s < n_sentinel
    uidx = torch.cumsum(first, dim=0, dtype=torch.int32) - 1
    del first
    overflowed = torch.any(real & (uidx >= K))
    vals_rows, cols_rows = [], []
    for k in range(K):
        mk = real & (uidx == k)
        vals_rows.append(torch.where(mk, vals_s, 0.0).sum(dim=0))
        ck = torch.where(mk, cols_s, -1).amax(dim=0)
        cols_rows.append(torch.where(ck < 0, row_ids, ck).to(torch.int32))
    return torch.stack(vals_rows), torch.stack(cols_rows), overflowed


def _ell_from_entries(A, dofs, adj, adj_mask, n_dofs: int, max_cols: int):
    """Assemble an ELLSoA from nb x nb local-entry arrays.

    A: nested list, A[i][j] the (C,) local entry (row slot i, col slot j);
    dofs: (nb, C) dof id per slot; adj/adj_mask: (D, n) slot-major
    incidence (positions p = slot * C + cell). Sorted merge per row over
    (nb*D, n) candidates. Returns (ELLSoA, overflowed).
    """
    nb = len(A)
    n = n_dofs
    C = dofs.shape[1]
    cell = adj % C  # (D, n)
    slot = adj // C
    aflat = torch.cat([A[i][j] for i in range(nb) for j in range(nb)])
    cols_b, vals_b = [], []
    for j in range(nb):
        cols_b.append(torch.where(adj_mask, dofs[j][cell], n))
        vals_b.append(torch.where(adj_mask, aflat[(slot * nb + j) * C + cell], 0.0))
    del aflat, cell, slot
    cols_all = torch.cat(cols_b, dim=0)  # (nb*D, n)
    del cols_b
    vals_all = torch.cat(vals_b, dim=0)
    del vals_b
    row_ids = torch.arange(n, dtype=torch.int32, device=adj.device)
    vals, cols, overflowed = _compact_sorted(cols_all, vals_all, row_ids, n, max_cols)
    return ELLSoA(vals, cols, (n, n), ell_warp_widths(cols)), overflowed


# P2: on an affine triangle every P2 weak-form integral is a per-cell scalar
# times a universal rational table. With S_pq = area (g_p . K g_q) (zero row
# sums, since sum_p g_p = 0), the 6 x 6 diffusion matrix is sum_e S_e T_e
# over the three off-diagonal directions e; advection is sum_q w_q E_q with
# w_q = area (b . g_q); mass is c area M. The tables come from the exact
# integral of barycentric monomials, int_T l0^a l1^b l2^c =
# 2 |T| a! b! c! / (a + b + c + 2)!. Local dof order: vertices 0, 1, 2, then
# the edges (0, 1), (0, 2), (1, 2), FEMSpace's order-2 cell dofs.


def _p2_tables():
    """(T (3, 6, 6), E (3, 6, 6), M (6, 6)) in float64 (host NumPy)."""
    basis = []
    for a in range(3):  # vertex a: l_a (2 l_a - 1)
        e1 = [0, 0, 0]
        e1[a] = 1
        e2 = [0, 0, 0]
        e2[a] = 2
        basis.append({tuple(e2): 2.0, tuple(e1): -1.0})
    for a, b in ((0, 1), (0, 2), (1, 2)):  # edge {a, b}: 4 l_a l_b
        e = [0, 0, 0]
        e[a] += 1
        e[b] += 1
        basis.append({tuple(e): 4.0})

    def dpoly(p, k):
        out = {}
        for m, c in p.items():
            if m[k]:
                m2 = list(m)
                m2[k] -= 1
                key = tuple(m2)
                out[key] = out.get(key, 0.0) + c * m[k]
        return out

    def pmul(p, q):
        out = {}
        for m1, c1 in p.items():
            for m2, c2 in q.items():
                m = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
                out[m] = out.get(m, 0.0) + c1 * c2
        return out

    def pint(p):  # integral over the cell / area
        return sum(
            c * 2.0 * factorial(m[0]) * factorial(m[1]) * factorial(m[2])
            / factorial(m[0] + m[1] + m[2] + 2)
            for m, c in p.items()
        )

    D = np.zeros((3, 3, 6, 6))
    grads = [[dpoly(basis[a], p) for p in range(3)] for a in range(6)]
    for p in range(3):
        for q in range(3):
            for a in range(6):
                for b in range(6):
                    D[p, q, a, b] = pint(pmul(grads[a][p], grads[b][q]))
    T = np.stack([D[p, q] + D[q, p] - D[p, p] - D[q, q] for p, q in ((0, 1), (0, 2), (1, 2))])
    E = np.zeros((3, 6, 6))
    for q in range(3):
        for a in range(6):
            for b in range(6):
                E[q, a, b] = pint(pmul(basis[a], grads[b][q]))
    M = np.zeros((6, 6))
    for a in range(6):
        for b in range(6):
            M[a, b] = pint(pmul(basis[a], basis[b]))
    return T, E, M


_P2_T, _P2_E, _P2_M = _p2_tables()


def p2_primitives_soa(x, y, c0, c1, c2, kxx=None, kxy=None, kyy=None,
                      bx=None, by=None, react=None):
    """Per-cell P2 primitives (s (3, C), wq (3, C) or None, r (C,) or None):
    s_e = area (g_p . K g_q) for e = (0, 1), (0, 2), (1, 2), the P1
    off-diagonals; wq_q = area (b . g_q); r = c area."""
    sd, _, _ = p1_general_soa(x, y, c0, c1, c2, kxx, kxy, kyy)
    x0, x1, x2 = x[c0], x[c1], x[c2]
    y0, y1, y2 = y[c0], y[c1], y[c2]
    e0x, e0y = x1 - x0, y1 - y0
    e1x, e1y = x2 - x0, y2 - y0
    det = e0x * e1y - e0y * e1x
    sgn = torch.sign(det)
    wq = None
    if bx is not None or by is not None:
        bx = 0.0 if bx is None else bx
        by = 0.0 if by is None else by
        g1x, g1y = e1y, -e1x
        g2x, g2y = -e0y, e0x
        g0x, g0y = -(g1x + g2x), -(g1y + g2y)
        # area (b . g_q) = sgn / 2 (b . G_q)
        wq = torch.stack([
            (sgn / 2.0) * (bx * g0x + by * g0y),
            (sgn / 2.0) * (bx * g1x + by * g1y),
            (sgn / 2.0) * (bx * g2x + by * g2y),
        ])
    r = None
    if react is not None:
        r = react * (0.5 * sgn * det)
    return sd, wq, r


class MatrixFreeP2SoA:
    """Matrix-free P2 advection-diffusion-reaction operator in SoA layout.

    s: (3, C) diffusion primitives; dofs: (6, C) int32 dof ids (vertices,
    then the lex edges: FEMSpace's order-2 ``dofs`` transposed); adj/adj_mask:
    (D, n) slot-major incidence over the (6C,) positions; wq: (3, C)
    advection primitives or None; r: (C,) reaction primitive or None. The
    6 x 6 local matrix is rebuilt from ``_p2_tables`` in each product.
    Operator protocol (@, diagonal, astype, to_ell) of MatrixFreeSoA.
    """

    def __init__(self, s, dofs, adj, adj_mask, n_dofs: int, wq=None, r=None):
        self.s = s
        self.dofs = dofs
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs
        self.wq = wq
        self.r = r

    @classmethod
    def build(cls, x, y, dofs, n_dofs: int, max_degree: int,
              kxx=None, kxy=None, kyy=None, bx=None, by=None, react=None):
        """dofs: (6, C) int32; the coordinates are read at rows 0-2 (a vertex
        dof id is its node id). Returns (op, overflowed)."""
        sd, wq, r = p2_primitives_soa(x, y, dofs[0], dofs[1], dofs[2],
                                      kxx, kxy, kyy, bx, by, react)
        adj, mask, over = build_adjacency_soa(dofs.reshape(-1), n_dofs, max_degree)
        return cls(sd, dofs, adj, mask, n_dofs, wq=wq, r=r), over

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    @property
    def is_symmetric(self):
        return self.wq is None

    def _entry(self, a, b):
        """Local entry (a, b) as a (C,) tensor: the diffusion terms, then
        advection, then reaction, skipping zero table coefficients (JAX's
        order, so the entries agree to rounding)."""
        ent = None
        for e in range(3):
            cf = float(_P2_T[e, a, b])
            if abs(cf) > 1e-14:
                t = cf * self.s[e]
                ent = t if ent is None else ent + t
        if self.wq is not None:
            for q in range(3):
                cf = float(_P2_E[q, a, b])
                if abs(cf) > 1e-14:
                    ent = (ent if ent is not None else 0.0) + cf * self.wq[q]
        if self.r is not None:
            cf = float(_P2_M[a, b])
            if abs(cf) > 1e-14:
                ent = (ent if ent is not None else 0.0) + cf * self.r
        if ent is None:
            ent = torch.zeros_like(self.s[0])
        return ent

    def _entries(self):
        return [[self._entry(a, b) for b in range(6)] for a in range(6)]

    def __matmul__(self, v):
        xe = [v[self.dofs[b]] for b in range(6)]  # six (C,) gathers
        A = self._entries()
        ye = []
        for a in range(6):
            acc = A[a][0] * xe[0]
            for b in range(1, 6):
                acc = acc + A[a][b] * xe[b]
            ye.append(acc)
        return _combine(ye, self.adj, self.adj_mask)

    def diagonal(self):
        return _combine([self._entry(a, a) for a in range(6)], self.adj, self.adj_mask)

    def astype(self, dtype):
        return MatrixFreeP2SoA(
            self.s.to(dtype), self.dofs, self.adj, self.adj_mask, self.n_dofs,
            wq=None if self.wq is None else self.wq.to(dtype),
            r=None if self.r is None else self.r.to(dtype),
        )

    def to_ell(self, max_cols: int):
        """Assembled (K, n) row-ELL; returns (ELLSoA, overflowed)."""
        return _ell_from_entries(self._entries(), self.dofs, self.adj,
                                 self.adj_mask, self.n_dofs, max_cols)


def ell_from_op_blocked(op, max_cols: int, blocks: int = 8):
    """``op.to_ell(max_cols)`` for a MatrixFreeSoA, MatrixFreeSoA3D or
    MatrixFreeP2SoA. The
    JAX package splits the conversion into ``blocks`` row blocks to bound
    each TPU program's run time; one pass gives the identical result here,
    so ``blocks`` is ignored. Returns (ELLSoA, overflowed)."""
    return op.to_ell(max_cols)


# 3D: the tet path in cell-axis-last layouts. Six off-diagonal arrays per
# cell (diagonals from the zero row sums of the diffusion part), the shared
# (D, n) slot-major incidence table, assembled (K, n) ELL.


def p1_general_soa_3d(x, y, z, c0, c1, c2, c3, kxx=None, kxy=None, kxz=None,
                      kyy=None, kyz=None, kzz=None, bx=None, by=None,
                      bz=None, react=None):
    """Per-cell primitives of the P1 tet advection-diffusion-reaction local
    matrix

        A_ij = vol (g_i . K g_j) + (vol/4) (b . g_j) + c vol/20 (1 + d_ij)

    with per-cell (C,) coefficients or None (kxx alone: isotropic). With
    edge vectors e_k = p_k - p_0 and det = e1 . (e2 x e3), the scaled
    gradients are G1 = e2 x e3, G2 = e3 x e1, G3 = e1 x e2,
    G0 = -(G1 + G2 + G3), g_i = G_i / det.

    Returns (sd, w, r): sd (6, C) diffusion off-diagonals in pair order
    (01, 02, 03, 12, 13, 23); w (4, C) advection column weights
    (vol/4)(b . g_j) or None; r (C,) reaction weight c vol/20 or None.
    """
    x0, x1, x2, x3 = x[c0], x[c1], x[c2], x[c3]
    y0, y1, y2, y3 = y[c0], y[c1], y[c2], y[c3]
    z0, z1, z2, z3 = z[c0], z[c1], z[c2], z[c3]
    e1 = (x1 - x0, y1 - y0, z1 - z0)
    e2 = (x2 - x0, y2 - y0, z2 - z0)
    e3 = (x3 - x0, y3 - y0, z3 - z0)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    G1 = cross(e2, e3)
    G2 = cross(e3, e1)
    G3 = cross(e1, e2)
    det = dot(e1, G1)  # 6 * signed volume
    sgn = torch.sign(det)
    scale = sgn / (6.0 * det)  # vol / det^2

    if kxx is None:
        kxx = 1.0
    if kyy is None:
        kyy = kxx  # isotropic when only kxx given
    if kzz is None:
        kzz = kxx
    if kxy is None:
        kxy = 0.0
    if kxz is None:
        kxz = 0.0
    if kyz is None:
        kyz = 0.0

    def KG(g):
        return (kxx * g[0] + kxy * g[1] + kxz * g[2],
                kxy * g[0] + kyy * g[1] + kyz * g[2],
                kxz * g[0] + kyz * g[1] + kzz * g[2])

    K1, K2, K3 = KG(G1), KG(G2), KG(G3)
    G0 = tuple(-(a + b + c) for a, b, c in zip(G1, G2, G3))
    sd = torch.stack([
        scale * dot(G0, K1), scale * dot(G0, K2), scale * dot(G0, K3),
        scale * dot(G1, K2), scale * dot(G1, K3), scale * dot(G2, K3),
    ])

    w = None
    if bx is not None or by is not None or bz is not None:
        bvec = tuple(0.0 if v is None else v for v in (bx, by, bz))
        # (vol/4)(b . g_j) = sgn/24 * (b . G_j)
        w = torch.stack([(sgn / 24.0) * dot(bvec, G) for G in (G0, G1, G2, G3)])

    r = None
    if react is not None:
        vol = sgn * det / 6.0
        r = react * vol / 20.0
    return sd, w, r


# pair order of the six off-diagonals
_TET_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


class MatrixFreeSoA3D:
    """Matrix-free P1 tet operator in SoA layout.

    s: (6, C) off-diagonals in _TET_PAIRS order; c: (4, C) corner ids;
    adj/adj_mask: (D, n) slot-major incidence; w: (4, C) advection column
    weights or None; r: (C,) reaction weight or None. Operator protocol
    (@, diagonal, astype, to_ell) of MatrixFreeSoA.
    """

    def __init__(self, s, c, adj, adj_mask, n_dofs: int, w=None, r=None):
        self.s = s
        self.c = c
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs
        self.w = w
        self.r = r

    @classmethod
    def build(cls, x, y, z, c0, c1, c2, c3, n_dofs: int, max_degree: int, kappa=None):
        """Pure-diffusion operator; returns (op, overflowed)."""
        sd, _, _ = p1_general_soa_3d(x, y, z, c0, c1, c2, c3, kxx=kappa)
        c = torch.stack([c0, c1, c2, c3])
        adj, mask, over = build_adjacency_soa(c.reshape(-1), n_dofs, max_degree)
        return cls(sd, c, adj, mask, n_dofs), over

    @classmethod
    def build_general(cls, x, y, z, c0, c1, c2, c3, n_dofs: int, max_degree: int,
                      kxx=None, kxy=None, kxz=None, kyy=None, kyz=None, kzz=None,
                      bx=None, by=None, bz=None, react=None):
        """Advection-diffusion-reaction tet operator (non-symmetric when b
        is given); returns (op, overflowed)."""
        sd, w, r = p1_general_soa_3d(x, y, z, c0, c1, c2, c3, kxx, kxy, kxz, kyy, kyz, kzz,
                                     bx, by, bz, react)
        c = torch.stack([c0, c1, c2, c3])
        adj, mask, over = build_adjacency_soa(c.reshape(-1), n_dofs, max_degree)
        return cls(sd, c, adj, mask, n_dofs, w=w, r=r), over

    @property
    def is_symmetric(self):
        return self.w is None

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    def _offdiag(self, i, j):
        return self.s[_TET_PAIRS.index((min(i, j), max(i, j)))]

    def _entries(self):
        """The 16 local-matrix entries, (4, 4) of (C,) tensors."""
        A = [[None] * 4 for _ in range(4)]
        for i in range(4):
            for j in range(4):
                if i != j:
                    A[i][j] = self._offdiag(i, j)
        for i in range(4):
            A[i][i] = -sum(A[i][j] for j in range(4) if j != i)
        if self.w is not None:
            for i in range(4):
                for j in range(4):
                    A[i][j] = A[i][j] + self.w[j]
        if self.r is not None:
            for i in range(4):
                for j in range(4):
                    A[i][j] = A[i][j] + (2.0 if i == j else 1.0) * self.r
        return A

    def __matmul__(self, v):
        xe = [v[self.c[j]] for j in range(4)]  # four (C,) gathers
        ye = []
        for i in range(4):
            off = [self._offdiag(i, j) for j in range(4) if j != i]
            xs = [xe[j] for j in range(4) if j != i]
            acc = -(off[0] + off[1] + off[2]) * xe[i]
            for sij, xj in zip(off, xs):
                acc = acc + sij * xj
            ye.append(acc)
        if self.w is not None:  # row-constant: one shared dot per cell
            adv = self.w[0] * xe[0] + self.w[1] * xe[1] + self.w[2] * xe[2] + self.w[3] * xe[3]
            ye = [yi + adv for yi in ye]
        if self.r is not None:
            sx = xe[0] + xe[1] + xe[2] + xe[3]
            ye = [yi + self.r * (sx + xe[i]) for i, yi in enumerate(ye)]
        return _combine(ye, self.adj, self.adj_mask)

    def diagonal(self):
        d = []
        for i in range(4):
            off = [self._offdiag(i, j) for j in range(4) if j != i]
            di = -(off[0] + off[1] + off[2])
            if self.w is not None:
                di = di + self.w[i]
            if self.r is not None:
                di = di + 2.0 * self.r
            d.append(di)
        return _combine(d, self.adj, self.adj_mask)

    def astype(self, dtype):
        return MatrixFreeSoA3D(
            self.s.to(dtype), self.c, self.adj, self.adj_mask, self.n_dofs,
            w=None if self.w is None else self.w.to(dtype),
            r=None if self.r is None else self.r.to(dtype),
        )

    def to_ell(self, max_cols: int):
        """Assembled (K, n) row-ELL (sorted merge over (4 D, n)
        candidates); returns (ELLSoA, overflowed)."""
        return _ell_from_entries(self._entries(), self.c, self.adj,
                                 self.adj_mask, self.n_dofs, max_cols)
