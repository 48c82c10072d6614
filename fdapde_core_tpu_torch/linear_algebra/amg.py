"""Smoothed-aggregation algebraic multigrid for unstructured SPD systems.

Port of ``fdapde_core_tpu/linear_algebra/amg.py`` (Vanek, Mandel & Brezina
1996): an SPD V-cycle preconditioner built from the assembled matrix
alone, giving h-independent preconditioned-CG iteration counts on any
simplicial mesh.

- The set-up runs on the host in NumPy/scipy and is a copy of the JAX
  module's: strength graph, Luby-style maximal-independent-set
  aggregation (the same ``default_rng(seed)``, so the same aggregates),
  the Jacobi-smoothed tentative prolongator, the Galerkin product
  R A P and the dense inverse of the coarsest level.
- The apply runs on the device: every level's A, P and R = P^T is a
  sorted-COO ``SparseMatrix``, so each product is K2's sliced form (built
  once per level at the first product, sums in a fixed order); the
  Chebyshev (or damped Jacobi) smoother is applied symmetrically before
  and after the coarse correction, so the V-cycle is SPD; the coarsest
  level is one ``torch.matmul`` with the dense inverse.

``utils.checkpoint.save_amg`` / ``load_amg`` persist a hierarchy in the
JAX package's ``.npz`` layout (either package's file loads in the other).
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse import SparseMatrix

__all__ = ["AMG", "amg_preconditioned_cg", "aggregate", "strength_graph"]


def strength_graph(A_sp, theta: float = 0.25):
    """Symmetric strength-of-connection filter on a scipy CSR matrix.

    Edge (i, j), i != j, is strong iff |a_ij| >= theta * sqrt(a_ii * a_jj).
    Returns (rows, cols) of the strong off-diagonal edges.
    """
    coo = A_sp.tocoo()
    r, c, v = coo.row, coo.col, coo.data
    off = r != c
    d = np.abs(A_sp.diagonal())
    d = np.where(d > 0, d, 1.0)
    strong = off & (np.abs(v) >= theta * np.sqrt(d[r] * d[c]))
    return r[strong], c[strong]


def aggregate(n: int, rows: np.ndarray, cols: np.ndarray, seed: int = 0,
              rows2=None, cols2=None):
    """Root-based aggregation via a Luby-style maximal independent set.

    A candidate becomes a root when its random priority beats every
    remaining candidate neighbour; roots claim themselves and their strong
    neighbours; stragglers attach to an adjacent aggregate (Vanek pass 2);
    only isolated nodes become singletons, and strength-isolated rows are
    grouped in eights. With (rows2, cols2), the distance-2 strength edges,
    root selection competes over them (roots >= 3 apart) while claiming
    stays distance-1. Returns agg (n,) int aggregate ids.
    """
    rng = np.random.default_rng(seed)
    prio = rng.permutation(n).astype(np.int64)  # distinct priorities
    state = np.zeros(n, dtype=np.int8)  # 0 candidate, 1 root, 2 claimed, 3 blocked
    agg = np.full(n, -1, dtype=np.int64)

    def _claim_last_per_row(rr, cc, key):
        """For each row in rr, the cc with the largest key (sort, then the
        last entry per row)."""
        order = np.lexsort((key, rr))
        rr, cc = rr[order], cc[order]
        uniq, first, counts = np.unique(rr, return_index=True, return_counts=True)
        return uniq, cc[first + counts - 1]

    if rows2 is None:
        rows2, cols2 = rows, cols
    has_edge = np.zeros(n, dtype=bool)
    has_edge[rows2] = True
    has_edge[rows] = True

    # phase 1: Luby MIS on the root-competition graph
    while True:
        cand = state == 0
        live = cand[rows2] & cand[cols2]
        if not live.any():
            break
        has_live = np.zeros(n, dtype=bool)
        has_live[rows2[live]] = True
        rr = rows2[live]
        pp = prio[cols2[live]]
        order = np.lexsort((pp, rr))
        rr_s, pp_s = rr[order], pp[order]
        uniq, first, counts = np.unique(rr_s, return_index=True, return_counts=True)
        nb_max = np.full(n, -1, dtype=np.int64)
        nb_max[uniq] = pp_s[first + counts - 1]
        # edge-less candidates do not win here: they are grouped below
        winners = cand & has_live & (prio > nb_max)
        if not winners.any():
            break
        state[winners] = 1
        blocked = winners[cols2] & (state[rows2] == 0)
        state[rows2[blocked]] = 3
    # the remaining candidates are pairwise non-adjacent: all become roots,
    # except strength-isolated rows (e.g. Dirichlet identity rows), grouped
    # in eights so they coarsen away geometrically
    cand_left = state == 0
    iso_ids = np.nonzero(cand_left & ~has_edge)[0]
    state[cand_left & has_edge] = 1
    if iso_ids.size:
        reps = iso_ids[(np.arange(iso_ids.size) // 8) * 8]
        agg[iso_ids] = reps
        state[iso_ids] = 2

    # phase 2: blocked nodes with a strong distance-1 root join it
    # (highest-priority root on ties)
    is_root = state == 1
    agg[is_root] = np.nonzero(is_root)[0]
    e = (state[rows] == 3) & is_root[cols]
    if e.any():
        rr, cc = _claim_last_per_row(rows[e], cols[e], prio[cols[e]])
        state[rr] = 2
        agg[rr] = cc

    # phase 3 (Vanek pass 2): stragglers attach to an adjacent aggregate
    for _ in range(4):
        todo = state == 3
        if not todo.any():
            break
        e = todo[rows] & (state[cols] == 2) | todo[rows] & is_root[cols]
        e &= agg[cols] >= 0
        if not e.any():
            break
        rr, cc = _claim_last_per_row(rows[e], cols[e], prio[cols[e]])
        state[rr] = 2
        agg[rr] = agg[cc]

    # leftovers without a strong path to an aggregate: singleton roots
    left = state == 3
    agg[left] = np.nonzero(left)[0]

    out = np.unique(agg, return_inverse=True)[1]  # consecutive aggregate ids
    assert (agg >= 0).all()
    return out.reshape(-1)


def _spectral_radius(DinvA, n):
    """rho(D^{-1} A) by 15 power iterations (host)."""
    x = np.random.default_rng(1).standard_normal(n)
    x /= np.linalg.norm(x)
    rho = 1.0
    for _ in range(15):
        y = DinvA @ x
        ny = np.linalg.norm(y)
        if ny == 0:
            break
        rho = ny
        x = y / ny
    return rho


def _smoothed_prolongator(A_sp, agg, rho, omega_scale: float = 4.0 / 3.0):
    """P = (I - omega D^{-1} A) T, T the normalized tentative prolongator,
    omega = omega_scale / rho(D^{-1} A)."""
    import scipy.sparse as sp

    n = A_sp.shape[0]
    nc = int(agg.max()) + 1
    sizes = np.bincount(agg, minlength=nc).astype(np.float64)
    T = sp.csr_matrix((1.0 / np.sqrt(sizes[agg]), (np.arange(n), agg)), shape=(n, nc))
    d = A_sp.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    DinvA = sp.diags(dinv) @ A_sp
    omega = omega_scale / rho
    P = T - omega * (DinvA @ T)
    return P.tocsr()


def _to_device(M_sp, dtype, device) -> SparseMatrix:
    """A scipy matrix as a (row, col)-sorted SparseMatrix on ``device``."""
    coo = M_sp.tocoo()
    order = np.lexsort((coo.col, coo.row))
    return SparseMatrix(
        torch.as_tensor(coo.row[order].astype(np.int32), device=device),
        torch.as_tensor(coo.col[order].astype(np.int32), device=device),
        torch.as_tensor(np.asarray(coo.data[order], dtype=np.float64), device=device).to(dtype),
        M_sp.shape,
    )


class AMG:
    """Smoothed-aggregation V-cycle hierarchy (an SPD preconditioner).

        mg = AMG.build(A)            # A: SparseMatrix (or scipy), SPD
        z = mg.v_cycle(r)            # ~ A^{-1} r
        x, info = cg(A, b, M_inv=mg.v_cycle)
    """

    def __init__(self, As, Ps, Rs, dinvs, coarse_inv, omega, nu,
                 rhos=None, smoother="chebyshev", cheby_lower=0.125):
        self.As = As          # SparseMatrix per level (fine .. coarse-1)
        self.Ps = Ps          # prolongators level l+1 -> l
        self.Rs = Rs          # restrictions P^T, row-sorted
        self.dinvs = dinvs    # inverse diagonals per level
        self.coarse_inv = coarse_inv  # dense (nc, nc) inverse of the coarsest A
        self.omega = omega    # Jacobi damping
        self.nu = nu          # smoothing sweeps / Chebyshev degree
        self.rhos = rhos or [2.0] * len(As)  # lambda_max(D^{-1} A) per level
        self.smoother = smoother
        self.cheby_lower = cheby_lower  # smooth [lower * rho, rho]

    @classmethod
    def build(cls, A, theta: float = 0.08, coarse_max: int = 300,
              max_levels: int = 25, omega: float = 2.0 / 3.0, nu: int = 3,
              seed: int = 0, smoother: str = "chebyshev",
              cheby_lower: float = 0.125, device=None):
        """Host set-up. A: SparseMatrix (its dtype and device are the
        hierarchy's) or a scipy sparse matrix (then ``device``, default
        "cuda", and float64). theta halves per level, so Galerkin-coarsened
        operators keep coarsening instead of dissolving into singletons."""
        import scipy.sparse as sp

        if isinstance(A, SparseMatrix):
            A_sp = A.to_scipy().tocsr()
            dtype, device = A.vals.dtype, A.vals.device
        else:
            A_sp = sp.csr_matrix(A)
            dtype = torch.float64
            device = "cuda" if device is None else device

        As, Ps, Rs, dinvs, rhos = [], [], [], [], []
        lvl = A_sp
        for level in range(max_levels):
            n = lvl.shape[0]
            if n <= coarse_max:
                break
            r, c = strength_graph(lvl, theta * 0.5 ** level)
            # distance-2 root competition graph (roots >= 3 apart)
            S = sp.csr_matrix((np.ones(r.size, dtype=np.int8), (r, c)), shape=(n, n))
            S2 = ((S @ S + S) > 0).tocoo()
            offd = S2.row != S2.col  # self-loops would block every winner
            agg = aggregate(n, r, c, seed=seed, rows2=S2.row[offd], cols2=S2.col[offd])
            nc = int(agg.max()) + 1
            if nc > 0.9 * n:  # coarsening stalled
                break
            d = lvl.diagonal()
            dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
            rho = _spectral_radius(sp.diags(dinv) @ lvl, n)
            P = _smoothed_prolongator(lvl, agg, rho)
            Ac = (P.T @ lvl @ P).tocsr()
            Ac.sum_duplicates()
            Ac.eliminate_zeros()
            As.append(_to_device(lvl, dtype, device))
            dinvs.append(torch.as_tensor(dinv, device=device).to(dtype))
            rhos.append(float(rho))
            Ps.append(_to_device(P, dtype, device))
            Rs.append(_to_device(P.T.tocsr(), dtype, device))
            lvl = Ac

        coarse_inv = torch.as_tensor(np.linalg.inv(lvl.toarray()), device=device).to(dtype)
        return cls(As, Ps, Rs, dinvs, coarse_inv, omega, nu, rhos, smoother, cheby_lower)

    @property
    def n_levels(self):
        return len(self.As) + 1

    def level_sizes(self):
        return [A.shape[0] for A in self.As] + [int(self.coarse_inv.shape[0])]

    def operator_complexity(self):
        """sum(nnz per level) / nnz(finest), the standard AMG cost metric."""
        nnz = [A.nnz for A in self.As] + [int(self.coarse_inv.shape[0]) ** 2]
        return sum(nnz) / nnz[0]

    def _smooth(self, lvl, x, b):
        """nu sweeps of damped Jacobi, or a degree-nu Chebyshev polynomial in
        D^{-1} A targeting [cheby_lower * rho, 1.05 rho] (the smooth lower
        spectrum is the coarse grid's job). A fixed polynomial applied the
        same way before and after keeps the V-cycle SPD."""
        A, dinv = self.As[lvl], self.dinvs[lvl]
        if self.smoother != "chebyshev":
            for _ in range(self.nu):
                x = x + self.omega * dinv * (b - A @ x)
            return x
        rho = self.rhos[lvl]
        a, bnd = self.cheby_lower * rho, 1.05 * rho
        theta, delta = (bnd + a) / 2.0, (bnd - a) / 2.0
        sigma = theta / delta
        rho_c = 1.0 / sigma
        r = dinv * (b - A @ x)
        d = r / theta
        for _ in range(self.nu):
            x = x + d
            r = r - dinv * (A @ d)
            rho_new = 1.0 / (2.0 * sigma - rho_c)
            d = rho_new * rho_c * d + (2.0 * rho_new / delta) * r
            rho_c = rho_new
        return x

    def _v(self, lvl, b):
        if lvl == len(self.As):
            return self.coarse_inv @ b
        x = self._smooth(lvl, torch.zeros_like(b), b)
        r = b - self.As[lvl] @ x
        e = self._v(lvl + 1, self.Rs[lvl] @ r)
        x = x + self.Ps[lvl] @ e
        return self._smooth(lvl, x, b)

    def v_cycle(self, r):
        """One V-cycle ~ A^{-1} r (SPD). A tensor r keeps its device; host
        input goes to the hierarchy's."""
        if not isinstance(r, torch.Tensor):
            r = torch.as_tensor(np.asarray(r), device=self.coarse_inv.device)
        return self._v(0, r)


def amg_preconditioned_cg(A, b, mg: AMG | None = None, rtol: float = 1e-10,
                          maxiter: int = 200, **build_kwargs):
    """CG with an SA-AMG V-cycle preconditioner; returns (x, SolveInfo)."""
    from .solvers import cg

    if mg is None:
        mg = AMG.build(A, **build_kwargs)
    return cg(A, torch.as_tensor(b, device=mg.coarse_inv.device), M_inv=mg.v_cycle,
              rtol=rtol, maxiter=maxiter)
