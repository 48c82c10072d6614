"""Plain reference of ``heat_0p5m`` and the check that decides ``correct``.

The problem is fdaPDE-core's heat-equation test
(``test/src/fem_pde_test.cpp:222-285``): on the unit square,

    u_t - mu Lap u = f,  u = 0 on the boundary,  u(0) = sin(2 pi x) sin(2 pi y),
    f = (8 pi^2 mu - 1) sin(2 pi x) sin(2 pi y) e^-t,

whose solution is u = sin(2 pi x) sin(2 pi y) e^-t (``mode`` times e^-t), stepped by
implicit Euler over the configuration's instants. From the benchmark's own
mesh and each kept job's mu the reference works out again, cell by cell in
closed form on the host (NumPy and SciPy, float64):

- the P1 stiffness A_ij = |T| grad phi_i . grad phi_j and the consistent
  mass M_ij = |T| (1 + delta_ij) / 12;
- the load F_k_i = |T| sum_q w_q f(x_q, t_k) phi_i(x_q) of each instant, by
  the program's quadrature rule for 2D P1, copied below as constants (f is
  (8 pi^2 mu - 1) e^-t_k times a function of space, so F_k is that factor
  times one load vector);
- the step's Dirichlet system K u_k = b_k with K = M / dt + mu A on the free
  rows and columns, the identity on the boundary, and b_k = M u_{k-1} / dt
  + F_k on the free rows, 0 on the boundary;
- its own trajectory by the upstream solver's method
  (``fem_linear_parabolic_solver.h:37-72``): K factorised once
  (``scipy.sparse.linalg.splu``), then one back-substitution a step.

It judges the program's trajectory x (n, instants) by (a)
``true_residual``, the largest over the steps of ||b_k - K x_k|| / ||b_k||
with b_k built from the program's own x_{k-1} (on the boundary rows the
residual is -x_k); (b) ``trajectory_gap`` (of the first kept job alone,
see ``check``), the largest over the instants of the mass-weighted
relative gap to the reference's trajectory, sqrt(sum w e^2 / sum w
u_ref^2); (c) ``l2_error``, the largest over the
instants of the mass-weighted squared L2 error to the closed-form solution
at the nodes, the functional of the upstream test (``PDE.l2_error``):
sum w e^2 with w = M's row sums, |T| / 3 a corner. The control
(``control``) is this reference in the program's place in float32: K
factorised and every step solved in float32.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

# utils/quadrature.standard_fem_quadrature(2, 1): the 3-point rule on the
# unit reference triangle, nodes (xi, eta), weights summing to 1
QUAD_NODES = ((1.0 / 6.0, 1.0 / 6.0), (2.0 / 3.0, 1.0 / 6.0), (1.0 / 6.0, 2.0 / 3.0))
QUAD_WEIGHTS = (1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0)


def mode(x, y):
    return np.sin(2 * math.pi * x) * np.sin(2 * math.pi * y)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Mesh:
    """What the steps of one mesh and time grid share whatever mu is: A, M,
    the load of sin(2 pi x) sin(2 pi y) and M's row sums, float64."""

    def __init__(self, nodes, cells, boundary, times):
        pts = np.asarray(nodes, dtype=np.float64)
        cells = np.asarray(cells, dtype=np.int64)
        self.bnd = np.asarray(boundary, dtype=bool)
        self.times = np.asarray(times, dtype=np.float64)
        self.dt = float(self.times[1] - self.times[0])
        n = pts.shape[0]
        self.x, self.y = pts[:, 0], pts[:, 1]
        p = [pts[cells[:, i]] for i in range(3)]
        # twice the signed area, and each corner's gradient (rotated opposite edge)
        det = ((p[1][:, 0] - p[0][:, 0]) * (p[2][:, 1] - p[0][:, 1])
               - (p[2][:, 0] - p[0][:, 0]) * (p[1][:, 1] - p[0][:, 1]))
        grads = [np.stack([p[(i + 1) % 3][:, 1] - p[(i + 2) % 3][:, 1],
                           p[(i + 2) % 3][:, 0] - p[(i + 1) % 3][:, 0]], 1) / det[:, None]
                 for i in range(3)]
        area = 0.5 * np.abs(det)
        rows = np.repeat(cells, 3, axis=1).reshape(-1)
        cols = np.tile(cells, (1, 3)).reshape(-1)
        stiff = np.stack([np.stack([(grads[i] * grads[j]).sum(1) for j in range(3)], 1)
                          for i in range(3)], 1) * area[:, None, None]
        mass = (np.ones((3, 3)) + np.eye(3))[None] / 12.0 * area[:, None, None]
        self.A = sp.csr_matrix((stiff.reshape(-1), (rows, cols)), shape=(n, n))
        self.M = sp.csr_matrix((mass.reshape(-1), (rows, cols)), shape=(n, n))
        # the load of sin(2 pi x) sin(2 pi y) by the program's quadrature rule
        load = np.zeros(n)
        for (xi, eta), w in zip(QUAD_NODES, QUAD_WEIGHTS):
            q = p[0] + xi * (p[1] - p[0]) + eta * (p[2] - p[0])
            fw = w * area * mode(q[:, 0], q[:, 1])
            for i, phi in enumerate((1.0 - xi - eta, xi, eta)):
                load += np.bincount(cells[:, i], fw * phi, minlength=n)
        self.load = load
        # M's row sums: |T| / 3 a corner
        self.weights = np.bincount(cells.reshape(-1), np.repeat(area / 3.0, 3), minlength=n)
        self.u0 = mode(self.x, self.y)

    def system(self, mu):
        return System(self, mu)


class System:
    """The implicit-Euler steps of one mesh, time grid and mu, float64."""

    def __init__(self, mesh, mu):
        for key in ("bnd", "times", "dt", "x", "y", "A", "M", "load", "weights", "u0"):
            setattr(self, key, getattr(mesh, key))
        self.mu = mu
        free = sp.diags((~self.bnd).astype(np.float64))
        K = self.M / self.dt + mu * self.A
        self.K = (free @ K @ free + sp.diags(self.bnd.astype(np.float64))).tocsc()

    def forcing(self, k):
        """F_k: the load at instant k."""
        return (8 * math.pi ** 2 * self.mu - 1) * math.exp(-self.times[k]) * self.load

    def trajectory(self, dtype=np.float64):
        """The reference's (n, instants) trajectory: K factorised once in
        ``dtype``, one back-substitution a step, every step's vectors in
        ``dtype``."""
        lu = spla.splu(self.K.astype(dtype), permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0,
                       options={"SymmetricMode": True})
        M = self.M.astype(dtype)
        dt = dtype(self.dt)
        out = np.empty((self.K.shape[0], self.times.size), dtype=dtype)
        out[:, 0] = self.u0
        for k in range(1, self.times.size):
            b = M @ out[:, k - 1] / dt + self.forcing(k).astype(dtype)
            out[:, k] = lu.solve(np.where(self.bnd, dtype(0), b).astype(dtype))
        return out

    def true_residual(self, x):
        """The largest relative residual of the steps of x, each step's
        right-hand side b_k from x's previous instant."""
        scale = (8 * math.pi ** 2 * self.mu - 1) * np.exp(-self.times[1:])
        b = self.M @ x[:, :-1] / self.dt + self.load[:, None] * scale[None, :]
        b[self.bnd] = 0.0
        r = b - self.K @ x[:, 1:]
        r[self.bnd] = -x[self.bnd, 1:]
        return float((np.linalg.norm(r, axis=0) / np.linalg.norm(b, axis=0)).max())

    def trajectory_gap(self, x, ref):
        """The largest mass-weighted relative gap of x to ``ref`` over the
        instants after the first (both start from u0)."""
        e = ((x[:, 1:] - ref[:, 1:]) ** 2 * self.weights[:, None]).sum(0)
        return float(np.sqrt(e / (ref[:, 1:] ** 2 * self.weights[:, None]).sum(0)).max())

    def l2_error(self, x):
        """The largest mass-weighted squared L2 error to the closed form
        over the instants."""
        u = mode(self.x, self.y)[:, None] * np.exp(-self.times)[None, :]
        return float((((u - x) ** 2) * self.weights[:, None]).sum(0).max())


def mesh(data):
    return Mesh(data["nodes"], data["cells"], data["boundary"], data["times"])


def check(data, pairs, cfg, traffic, device):
    """(name, value, limit) of every number compared: for each kept job the
    largest true relative residual of its steps and the largest squared L2
    error to the closed form, and for the first kept job the largest
    mass-weighted relative gap of its trajectory to the reference's.

    The gap costs a factorisation and a back-substitution a step, most of
    a check's time at the configuration's size (the residual costs
    products alone), so one job pays it: the residual, which takes each
    step's right-hand side from the program's own previous instant, holds
    every kept step to the reference's system, and the gap bounds how far
    one whole trajectory drifted from the reference's own."""
    lim = cfg["limits"]
    shared = mesh(data)
    out = []
    for i, (job, inp, res) in enumerate(pairs):
        s = shared.system(inp["mu"])
        x = host(res["x"]).astype(np.float64)
        out.append((f"true_residual.job{job}", s.true_residual(x), lim["true_residual"]))
        if i == 0:
            out.append((f"trajectory_gap.job{job}", s.trajectory_gap(x, s.trajectory()),
                        lim["trajectory_gap"]))
        out.append((f"l2_error.job{job}", s.l2_error(x), lim["l2_error"]))
    return out


def control(data, inp, cfg, traffic, device, dtype=np.float32):
    """The reference in the program's place in a lower precision: K
    factorised and the trajectory stepped in ``dtype``. Returns the outputs
    the check reads."""
    return {"x": mesh(data).system(inp["mu"]).trajectory(dtype), "iterations": 0}
