"""Plain-PyTorch reference of ``pde_0p5m`` and the check that decides
``correct``.

The problem is fdaPDE-core's advection-diffusion test
(``test/src/fem_pde_test.cpp:113-166``): on the unit square,

    -Lap u + beta . grad u = gamma sin(pi y),  u = 0 on the boundary,
    beta = (-alpha, 0), gamma = pi,

whose solution is known in closed form (``exact``). From the benchmark's
own mesh and each kept job's alpha the reference works out again, in
float64 and cell by cell in closed form:

- the P1 stiffness K_ij = |T| grad phi_i . grad phi_j;
- the advection matrix B_ij = int_T phi_i beta . grad phi_j
  = |T| / 3 beta . grad phi_j (the P1 gradients are constant on a cell);
- the load vector F_i = |T| sum_q w_q f(x_q) phi_i(x_q), by the program's
  quadrature rule for 2D P1, copied below as constants;
- the Dirichlet system: r = F - (K + B) x on the free nodes, -x on the
  boundary, against b_mod = F on the free nodes, 0 on the boundary.

It judges the program's solution by (a) ``true_residual``, its true
relative residual ||r|| / ||b_mod|| in that system, and (b) ``l2_error``,
the mass-weighted squared L2 error to the closed-form solution at the
nodes, the functional of the reference's tests (``PDE.l2_error``):
(M (e * e)).sum() = sum_T |T| / 3 sum_corners e^2. The control
(``control``) is this reference in the program's place in float32:
Jacobi-preconditioned BiCGStab on the same system.
"""

from __future__ import annotations

import math

import torch

GAMMA = math.pi
# utils/quadrature.standard_fem_quadrature(2, 1): the 3-point rule on the
# unit reference triangle, nodes (xi, eta), weights summing to 1
QUAD_NODES = ((1.0 / 6.0, 1.0 / 6.0), (2.0 / 3.0, 1.0 / 6.0), (1.0 / 6.0, 2.0 / 3.0))
QUAD_WEIGHTS = (1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0)


def exact(x, y, alpha, gamma=GAMMA):
    """The closed-form solution of fem_pde_test.cpp:113-166 at (x, y)."""
    pi = math.pi
    lam1 = -alpha / 2 - math.sqrt((alpha / 2) ** 2 + pi * pi)
    lam2 = -alpha / 2 + math.sqrt((alpha / 2) ** 2 + pi * pi)
    p = (1 - math.exp(lam2)) / (math.exp(lam1) - math.exp(lam2))
    return (-gamma / (pi * pi) * (p * torch.exp(lam1 * x) + (1 - p) * torch.exp(lam2 * x) - 1.0)
            * torch.sin(pi * y))


def forcing(x, y, gamma=GAMMA):
    return gamma * torch.sin(math.pi * y)


class System:
    """The Dirichlet system of one mesh and one alpha in one precision."""

    def __init__(self, nodes, cells, boundary, alpha, device, dtype=torch.float64):
        self.dtype = dtype
        self.n = nodes.shape[0]
        self.cells = torch.as_tensor(cells, device=device).long()
        self.bnd = torch.as_tensor(boundary, device=device)
        pts = torch.as_tensor(nodes, dtype=torch.float64, device=device)
        p = [pts[self.cells[:, i]] for i in range(3)]
        self.x = pts[:, 0].to(dtype)
        self.y = pts[:, 1].to(dtype)
        # twice the signed area, and each corner's gradient (rotated opposite edge)
        det = ((p[1][:, 0] - p[0][:, 0]) * (p[2][:, 1] - p[0][:, 1])
               - (p[2][:, 0] - p[0][:, 0]) * (p[1][:, 1] - p[0][:, 1]))
        grads = [torch.stack([p[(i + 1) % 3][:, 1] - p[(i + 2) % 3][:, 1],
                              p[(i + 2) % 3][:, 0] - p[(i + 1) % 3][:, 0]], 1) / det[:, None]
                 for i in range(3)]
        area = 0.5 * det.abs()
        beta = torch.tensor([-alpha, 0.0], dtype=torch.float64, device=device)
        # local (C, 3, 3): rows the test function i, columns the trial function j
        K = torch.stack([torch.stack([(grads[i] * grads[j]).sum(1) for j in range(3)], 1)
                         for i in range(3)], 1) * area[:, None, None]
        adv = torch.stack([grads[j] @ beta for j in range(3)], 1) * (area / 3.0)[:, None]
        self.local = (K + adv[:, None, :]).to(dtype)
        # the load vector by the program's quadrature rule
        F = torch.zeros(self.n, dtype=torch.float64, device=device)
        for (xi, eta), w in zip(QUAD_NODES, QUAD_WEIGHTS):
            q = p[0] + xi * (p[1] - p[0]) + eta * (p[2] - p[0])
            fw = w * area * forcing(q[:, 0], q[:, 1])
            for i, phi in enumerate((1.0 - xi - eta, xi, eta)):
                F.index_add_(0, self.cells[:, i], fw * phi)
        self.F = F.to(dtype)
        self.area = area.to(dtype)
        self.alpha = alpha

    def A(self, v):
        """(K + B) v, summed over the cells."""
        vc = v[self.cells]  # (C, 3)
        out = torch.zeros(self.n, dtype=v.dtype, device=v.device)
        for i in range(3):
            out.index_add_(0, self.cells[:, i], (self.local[:, i, :] * vc).sum(1))
        return out

    def op(self, v):
        """The Dirichlet operator: the free rows and columns of K + B, the
        identity on the boundary."""
        return torch.where(self.bnd, v, self.A(torch.where(self.bnd, 0.0, v)))

    def b_mod(self):
        return torch.where(self.bnd, 0.0, self.F)

    def diagonal(self):
        d = torch.zeros(self.n, dtype=self.dtype, device=self.local.device)
        for i in range(3):
            d.index_add_(0, self.cells[:, i], self.local[:, i, i])
        return torch.where(self.bnd, 1.0, d)

    def true_residual(self, x):
        x = x.to(self.dtype)
        r = torch.where(self.bnd, -x, self.F - self.A(x))
        return float(torch.linalg.norm(r) / torch.linalg.norm(self.b_mod()))

    def l2_error(self, x):
        e = exact(self.x, self.y, self.alpha).to(self.dtype) - x.to(self.dtype)
        return float((self.area / 3.0 * (e * e)[self.cells].sum(1)).sum())


def check(data, pairs, cfg, traffic, device):
    """(name, value, limit) of every number compared, for each kept job:
    the true relative residual of its solution in the reference's
    Dirichlet system and its squared L2 error to the closed form."""
    lim = cfg["limits"]
    out = []
    for job, inp, res in pairs:
        system = System(data["nodes"], data["cells"], data["boundary"], inp["alpha"], device)
        out.append((f"true_residual.job{job}", system.true_residual(res["x"]),
                    lim["true_residual"]))
        out.append((f"l2_error.job{job}", system.l2_error(res["x"]), lim["l2_error"]))
    return out


def bicgstab(op, b, dinv, rtol, maxiter):
    """Jacobi-preconditioned BiCGStab from 0, stopped when ||r|| <= rtol
    ||b||, after ``maxiter`` iterations or at a breakdown (a zero divisor
    or a residual that is not finite). Returns the iterate of the smallest residual seen, and
    the iterations run: BiCGStab's residual is erratic in a low
    precision."""
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = 1.0
    tol = rtol * float(torch.linalg.norm(b))
    best, best_norm = x, float(torch.linalg.norm(r))
    its = 0
    while its < maxiter and best_norm > tol and rho != 0 and omega != 0:
        rho_new = float(torch.dot(rhat, r))
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
        phat = dinv * p
        v = op(phat)
        rv = float(torch.dot(rhat, v))
        if rv == 0:
            break
        alpha = rho_new / rv
        s = r - alpha * v
        shat = dinv * s
        t = op(shat)
        tt = float(torch.dot(t, t))
        omega = float(torch.dot(t, s)) / tt if tt > 0 else 0.0
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        its += 1
        rn = float(torch.linalg.norm(r))
        if not math.isfinite(rn):
            break
        if rn < best_norm:
            best, best_norm = x, rn
    return best, its


def control(data, inp, cfg, traffic, device, dtype=torch.float32):
    """The reference in the program's place in a lower precision:
    Jacobi BiCGStab on the Dirichlet system in ``dtype``, to the
    configured tolerance or iteration cap. Returns the outputs the check
    reads."""
    system = System(data["nodes"], data["cells"], data["boundary"], inp["alpha"], device, dtype)
    x, its = bicgstab(system.op, system.b_mod(), 1.0 / system.diagonal(), cfg["solver_rtol"],
                      cfg["solver_maxiter"])
    return {"x": x, "iterations": its}
