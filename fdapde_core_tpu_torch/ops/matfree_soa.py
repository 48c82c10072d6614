"""SoA (cell axis last) general gather pipeline, 2D P1.

Port of the 2D P1 part of ``fdapde_core_tpu/ops/matfree_soa.py``: per-cell
closed-form local stiffness from per-corner (C,) gathers, a (D, n)
slot-major incidence table, the matrix-free operator over it, and its
conversion to an assembled (K, n) row-ELL whose SpMV is the K2 kernel
(``ops/gather_spmv.ell_spmv``).

Index types follow the JAX package: corner ids, incidence positions and ELL
columns are int32 (the largest intermediate, ``(slot*nb + j)*C + cell``,
is about 1.8e8 at 20.48M cells). ``torch.argsort``/``torch.sort`` return
int64 indices, which are cast to int32 or freed at once.
"""

from __future__ import annotations

import torch

from .gather_spmv import accumulation_dtype, ell_spmv

__all__ = [
    "p1_offdiag_soa",
    "p1_general_soa",
    "build_adjacency_soa",
    "MatrixFreeSoA",
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

    def _combine(self, per_slot):
        """Sum the slot-major (3C,) local values over each dof's incidences."""
        flat = torch.cat(per_slot)
        return (flat[self.adj] * self.adj_mask.to(flat.dtype)).sum(dim=0)

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
        return self._combine(ye)

    def diagonal(self):
        s01, s02, s12 = self.s[0], self.s[1], self.s[2]
        d = [-(s01 + s02), -(s01 + s12), -(s02 + s12)]
        if self.w is not None:
            d = [d[i] + self.w[i] for i in range(3)]
        if self.r is not None:
            d = [di + 2.0 * self.r for di in d]
        return self._combine(d)

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
    return ELLSoA(vals, cols, (n, n)), overflowed


class ELLSoA:
    """Assembled row-ELL in SoA layout: vals/cols (K, n); padded entries
    carry col = row id and val = 0 (no mask in the SpMV). The SpMV is the
    K2 kernel (``ops/gather_spmv.ell_spmv``)."""

    def __init__(self, vals, cols, shape):
        self.vals = vals
        self.cols = cols
        self.shape = tuple(shape)

    def __matmul__(self, v):
        if v.shape != (self.shape[1],):
            raise ValueError(f"operand must be ({self.shape[1]},), got {tuple(v.shape)}")
        acc = accumulation_dtype(self.vals.dtype, v.dtype)
        vals = self.vals
        if accumulation_dtype(vals.dtype) != acc:  # e.g. float32 values, float64 v
            vals = vals.to(acc)
        return ell_spmv(vals.contiguous(), self.cols.contiguous(), v.to(acc).contiguous())

    def diagonal(self):
        rows = torch.arange(self.shape[0], dtype=self.cols.dtype, device=self.cols.device)
        return torch.where(self.cols == rows[None, :], self.vals, 0.0).sum(dim=0)

    def astype(self, dtype):
        return ELLSoA(self.vals.to(dtype), self.cols, self.shape)

    def with_added_diagonal(self, d):
        """A + diag(d): only the first (row == col) slot of each row changes
        (padding also carries col = row, with val 0, after the real
        entries; the diagonal is always structurally present in FEM
        operators)."""
        rows = torch.arange(self.shape[0], dtype=self.cols.dtype, device=self.cols.device)
        isdiag = self.cols == rows[None, :]
        first = isdiag & (torch.cumsum(isdiag, dim=0) == 1)
        d = torch.as_tensor(d, device=self.vals.device)
        vals = self.vals + torch.where(first, d[None, :], 0.0)
        return ELLSoA(vals, self.cols, self.shape)


def ell_from_op_blocked(op, max_cols: int, blocks: int = 8):
    """``op.to_ell(max_cols)``. The JAX package splits the conversion into
    ``blocks`` row blocks to bound each TPU program's run time; one pass
    gives the identical result here, so ``blocks`` is ignored. Returns
    (ELLSoA, overflowed)."""
    return op.to_ell(max_cols)
