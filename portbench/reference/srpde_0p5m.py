"""Plain-PyTorch reference of ``srpde_0p5m`` and the check that decides
``correct``.

From the benchmark's own mesh, locations, observations and probe seeds the
reference works out again:

- point location: scipy's ``Delaunay.find_simplex`` on the triangulation
  the mesh was made by, then the barycentric weights from the nodes;
- Psi (the P1 basis at the locations, three weights a row) and the
  penalty P (the P1 stiffness, cell by cell, closed form);
- the normal equations (Psi^T Psi + lam P) c = Psi^T y, solved by Jacobi
  CG to the configured tolerance;
- for GCV, the score n ||y - Psi c||^2 / (n - tr S)^2 with tr S by the
  same Rademacher probes, which ``SmoothingRegression.gcv`` draws from its
  seed as ``numpy.random.default_rng(seed).choice([-1, 1], size=(k, n))``.

It judges the program's coefficients by their relative residual in these
normal equations (``normal_residual``) and its GCV score by its relative
gap to the reference's (``gcv_gap``). The control (``control``) is this
reference in the program's place in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def locate(tri, nodes, cells, locs):
    """(cell corners (k, 3) int64, barycentric weights (k, 3)) of each
    location, host float64. scipy walks from the last point's simplex, so
    the points are visited in a serpentine order of bins about a cell wide
    (in random order each walk would cross the mesh)."""
    lo, hi = nodes.min(0), nodes.max(0)
    nb = max(1, int(np.sqrt(cells.shape[0] / 2)))
    ij = np.clip(((locs - lo) / (hi - lo) * nb).astype(np.int64), 0, nb - 1)
    key = ij[:, 1] * nb + np.where(ij[:, 1] % 2 == 0, ij[:, 0], nb - 1 - ij[:, 0])
    order = np.argsort(key, kind="stable")
    simplex = np.empty(locs.shape[0], dtype=np.int64)
    simplex[order] = tri.find_simplex(locs[order])
    if (simplex < 0).any():
        raise ValueError(f"{int((simplex < 0).sum())} locations lie outside the mesh")
    corners = cells[simplex].astype(np.int64)
    p0, p1, p2 = (nodes[corners[:, j]] for j in range(3))
    d1, d2, q = p1 - p0, p2 - p0, locs - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    l1 = (q[:, 0] * d2[:, 1] - q[:, 1] * d2[:, 0]) / det
    l2 = (d1[:, 0] * q[:, 1] - d1[:, 1] * q[:, 0]) / det
    return corners, np.stack([1.0 - l1 - l2, l1, l2], axis=1)


class Normal:
    """A(lam) = Psi^T Psi + lam P and Psi on one dataset, in one precision."""

    def __init__(self, data, lam, device, dtype=torch.float64):
        nodes, cells = data["nodes"], data["cells"]
        corners, w = locate(data["delaunay"], nodes, cells, data["locs"])
        self.n_dofs = nodes.shape[0]
        self.lam, self.dtype = lam, dtype
        self.rows = torch.as_tensor(corners, device=device)
        self.w = torch.as_tensor(w, dtype=dtype, device=device)
        c = torch.as_tensor(cells, device=device).long()
        p = [torch.as_tensor(nodes, dtype=dtype, device=device)[c[:, i]] for i in range(3)]
        e = [p[2] - p[1], p[0] - p[2], p[1] - p[0]]
        area = 0.5 * torch.abs(e[1][:, 0] * e[2][:, 1] - e[1][:, 1] * e[2][:, 0])
        self.cells = c
        self.K = [[(e[i] * e[j]).sum(1) * (0.25 / area) for j in range(3)] for i in range(3)]

    def psi(self, c):
        return (self.w * c[self.rows]).sum(1)

    def psi_t(self, v):
        out = torch.zeros(self.n_dofs, dtype=self.dtype, device=v.device)
        out.index_add_(0, self.rows.reshape(-1), (self.w * v[:, None]).reshape(-1))
        return out

    def penalty(self, c):
        xs = [c[self.cells[:, j]] for j in range(3)]
        out = torch.zeros_like(c)
        for i in range(3):
            out.index_add_(0, self.cells[:, i], sum(self.K[i][j] * xs[j] for j in range(3)))
        return out

    def __call__(self, c):
        return self.psi_t(self.psi(c)) + self.lam * self.penalty(c)

    def diagonal(self):
        d = torch.zeros(self.n_dofs, dtype=self.dtype, device=self.w.device)
        d.index_add_(0, self.rows.reshape(-1), (self.w * self.w).reshape(-1))
        for i in range(3):
            d.index_add_(0, self.cells[:, i], self.lam * self.K[i][i])
        return d

    def cg(self, b, rtol, maxiter):
        """Jacobi CG from 0, stopped when ||r|| <= rtol ||b||."""
        dinv = 1.0 / self.diagonal()
        x = torch.zeros_like(b)
        r = b.clone()
        z = dinv * r
        p = z.clone()
        rz = torch.dot(r, z)
        tol = rtol * float(torch.linalg.norm(b))
        its = 0
        while its < maxiter and float(torch.linalg.norm(r)) > tol:
            Ap = self(p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = dinv * r
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            its += 1
        return x

    def normal_residual(self, c, y):
        rhs = self.psi_t(y)
        return float(torch.linalg.norm(self(c.to(self.dtype)) - rhs) / torch.linalg.norm(rhs))

    def gcv(self, y, probe_seed, n_probes, rtol, maxiter):
        """(score, coefficients) as the reference computes them."""
        y = y.to(self.dtype)
        n = y.shape[0]
        c = self.cg(self.psi_t(y), rtol, maxiter)
        rss = float(torch.sum((y - self.psi(c)) ** 2))
        V = np.random.default_rng(probe_seed).choice([-1.0, 1.0], size=(n_probes, n))
        est = []
        for v in torch.as_tensor(V, dtype=self.dtype, device=y.device):
            u = self.psi_t(v)
            est.append(float(torch.dot(u, self.cg(u, rtol, maxiter))))
        tr = float(np.mean(est))
        return n * rss / max(n - tr, 1e-12) ** 2, c


def check(data, pairs, cfg, traffic, device):
    """(name, value, limit) of every number compared, for each kept job:
    the coefficients' relative residual in the reference's normal
    equations and, for GCV, the score's relative gap to the reference's."""
    A = Normal(data, cfg["lam"], device)
    lim = cfg["limits"]
    out = []
    for job, inp, res in pairs:
        out.append((f"normal_residual.job{job}", A.normal_residual(res["c"], inp["y"]),
                    lim["normal_residual"]))
        if traffic["job"] == "gcv":
            score, _ = A.gcv(inp["y"], inp["probe_seed"], cfg["n_probes"], cfg["rtol"],
                             cfg["maxiter"])
            out.append((f"gcv_gap.job{job}", abs(res["score"] - score) / abs(score),
                        lim["gcv_gap"]))
    return out


def control(data, inp, cfg, traffic, device, dtype=torch.float32):
    """The reference in the program's place in a lower precision: the
    outputs a job would give, computed in ``dtype``."""
    A = Normal(data, cfg["lam"], device, dtype)
    y = inp["y"].to(dtype)
    if traffic["job"] == "gcv":
        score, c = A.gcv(y, inp["probe_seed"], cfg["n_probes"], cfg["rtol"], cfg["maxiter"])
        return {"score": score, "c": c}
    return {"score": None, "c": A.cg(A.psi_t(y), cfg["rtol"], cfg["maxiter"])}
