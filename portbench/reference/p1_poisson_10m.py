"""Plain-PyTorch reference of ``p1_poisson_10m`` and the check that
decides ``correct``.

From the benchmark's own mesh and each job's forcing and Dirichlet data,
the reference works out again the P1 stiffness (cell by cell, closed form,
float64), the load vector (|T| / 3 f at the centroid to each corner) and
the Dirichlet system, and judges the program's solution by its true
relative residual there:

    r = b - A x on the free nodes, g - x on the boundary,
    ||r|| / ||b_mod||,  b_mod = b - A g_lift on the free nodes, g on the boundary.

So the operator the program built, its Dirichlet lift, its preconditioned
solve and every SpMV under it are judged at once. The control
(``control``) is this reference put in the program's place in float32:
Jacobi CG on the same system, its answer judged the same way.
"""

from __future__ import annotations

import torch


def local_stiffness(nodes, cells, dtype=torch.float64):
    """Per-cell P1 stiffness K_ij = e_i . e_j / (4 |T|), e_i the edge
    opposite corner i: (K00, K11, K22, K01, K02, K12), each (C,)."""
    c = cells.long()
    p = [nodes[c[:, i]].to(dtype) for i in range(3)]
    e = [p[2] - p[1], p[0] - p[2], p[1] - p[0]]
    area = 0.5 * torch.abs(e[2][:, 0] * (-e[1][:, 1]) - e[2][:, 1] * (-e[1][:, 0]))
    q = 0.25 / area

    def dot(i, j):
        return (e[i] * e[j]).sum(1) * q

    return (dot(0, 0), dot(1, 1), dot(2, 2), dot(0, 1), dot(0, 2), dot(1, 2)), area


def apply_stiffness(K, cells, x):
    """A x, summed over the cells."""
    k00, k11, k22, k01, k02, k12 = K
    c = cells.long()
    x0, x1, x2 = x[c[:, 0]], x[c[:, 1]], x[c[:, 2]]
    y = torch.zeros_like(x)
    y.index_add_(0, c[:, 0], k00 * x0 + k01 * x1 + k02 * x2)
    y.index_add_(0, c[:, 1], k01 * x0 + k11 * x1 + k12 * x2)
    y.index_add_(0, c[:, 2], k02 * x0 + k12 * x1 + k22 * x2)
    return y


def load_vector(cells, area, f_cells, n):
    c = cells.long()
    b = torch.zeros(n, dtype=f_cells.dtype, device=f_cells.device)
    share = area.to(f_cells.dtype) * f_cells / 3.0
    for j in range(3):
        b.index_add_(0, c[:, j], share)
    return b


class System:
    """The Dirichlet system of one mesh in one precision."""

    def __init__(self, nodes, cells, boundary, dtype=torch.float64):
        self.cells, self.bnd = cells, boundary
        self.K, self.area = local_stiffness(nodes, cells, dtype)
        self.n = nodes.shape[0]
        self.dtype = dtype

    def A(self, x):
        return apply_stiffness(self.K, self.cells, x)

    def rhs(self, f_cells, g):
        """(b, b_mod) of the job's forcing and Dirichlet data."""
        b = load_vector(self.cells, self.area, f_cells.to(self.dtype), self.n)
        g = g.to(self.dtype)
        lift = torch.where(self.bnd, g, 0.0)
        b_mod = torch.where(self.bnd, g, b - self.A(lift))
        return b, b_mod

    def true_residual(self, x, f_cells, g):
        b, b_mod = self.rhs(f_cells, g)
        x = x.to(self.dtype)
        r = torch.where(self.bnd, g.to(self.dtype) - x, b - self.A(x))
        return float(torch.linalg.norm(r) / torch.linalg.norm(b_mod))

    def diagonal(self):
        k00, k11, k22 = self.K[:3]
        c = self.cells.long()
        d = torch.zeros(self.n, dtype=self.dtype, device=k00.device)
        for j, kjj in enumerate((k00, k11, k22)):
            d.index_add_(0, c[:, j], kjj)
        return d


def check(data, pairs, cfg, traffic, device):
    """(name, value, limit) of every number compared: the true relative
    residual of each kept job's solution."""
    system = System(data["nodes"], data["cells"], data["boundary"])
    limit = cfg["limits"]["true_residual"]
    return [(f"true_residual.job{job}", system.true_residual(out["x"], inp["f"], inp["g"]), limit)
            for job, inp, out in pairs]


def control(data, inp, cfg, traffic, device, dtype=torch.float32, maxiter=4000):
    """The reference in the program's place in a lower precision: Jacobi
    CG on the Dirichlet system in ``dtype`` from x0 = g on the boundary,
    to the configured tolerance or ``maxiter``. Returns the outputs the
    check reads."""
    system = System(data["nodes"], data["cells"], data["boundary"], dtype)
    bnd = system.bnd
    _, b_mod = system.rhs(inp["f"], inp["g"])
    free = ~bnd
    dinv = torch.where(bnd, 1.0, 1.0 / system.diagonal())

    def op(v):
        return torch.where(bnd, v, system.A(torch.where(bnd, 0.0, v)))

    x = torch.where(bnd, b_mod, 0.0)
    r = b_mod - op(x)
    r = torch.where(free, r, 0.0)
    z = dinv * r
    p = z.clone()
    rz = torch.dot(r, z)
    tol = cfg["rtol"] * float(torch.linalg.norm(b_mod))
    its = 0
    while its < maxiter and float(torch.linalg.norm(r)) > tol:
        Ap = op(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        its += 1
    return {"x": x, "iterations": its}
