"""Optimizers as Python loops on device tensors.

Port of ``fdapde_core_tpu/optimization/optimizers.py``: JAX's
``lax.while_loop`` iterations become host loops (one scalar read an
iteration), and its ``jax.grad`` / ``jax.hessian`` become eager autograd:
the gradient is ``torch.autograd.grad`` of the objective at a leaf copy of
x, the Hessian one more ``torch.autograd.grad`` per entry of that gradient
(taken with ``create_graph=True``). Eager autograd, not ``torch.func``,
because an objective may reach a CUDA kernel through ctypes (every
``SparseMatrix`` product runs K2), which reads raw pointers and cannot take
``torch.func``'s wrapped tensors; K2's products carry their own backward
(``linear_algebra.sparse.SparseProduct``). ``grid_search`` evaluates the
grid point by point for the same reason, where JAX vmaps it. Semantics
mirror the reference:

- `grid_search`: exhaustive minimization over an explicit grid (grid.h:28-71),
- `gradient_descent`: steepest descent, update = -step * grad, stop when
  ||grad|| < tol or max_iter (gradient_descent.h:27-75),
- `newton`: direction = -H^{-1} grad via dense solve (newton.h:28-101),
- `bfgs`: rank-2 inverse-hessian update, identity init, stationary-point
  early exit (bfgs.h:28-125),
- line searches: `backtracking` (Armijo, alpha *= beta while insufficient
  decrease; backtracking_line_search.h:26-49) and `wolfe` (weak-Wolfe
  bisection; wolfe_line_search.h:27-62), or a callable
  (f, grad_f, x, p, step0) -> step.

Each returns an `OptimizeResult(x, value, n_iter)`; x and value are
tensors on x0's device (the card when x0 is not a tensor), n_iter an int.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["OptimizeResult", "grid_search", "gradient_descent", "newton", "bfgs"]


class OptimizeResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    n_iter: int


def _as_fn(obj) -> Callable:
    return obj if callable(obj) else obj.__call__


def _point(x0) -> torch.Tensor:
    """x0 as a float tensor (float64 unless it already is floating), on
    x0's device when it is a tensor and on the card otherwise."""
    x = x0 if isinstance(x0, torch.Tensor) else torch.as_tensor(np.asarray(x0), device="cuda")
    return x.clone() if x.is_floating_point() else x.to(torch.float64)


def _value(f):
    """f(x) with no graph, as a tensor."""
    def value(x):
        with torch.no_grad():
            return torch.as_tensor(f(x), dtype=x.dtype, device=x.device)

    return value


def _grad(f):
    """x -> grad f(x), by eager autograd at a leaf copy of x."""
    def grad_f(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(f(xr), xr, allow_unused=True)
        return torch.zeros_like(x) if g is None else g

    return grad_f


def _hessian(f):
    """x -> the (n, n) Hessian of f, one autograd pass per row."""
    def hess_f(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(f(xr), xr, create_graph=True)
            rows = []
            for i in range(x.shape[0]):
                (h,) = torch.autograd.grad(g[i], xr, retain_graph=True, allow_unused=True)
                rows.append(torch.zeros_like(x) if h is None else h)
        return torch.stack(rows)

    return hess_f


def grid_search(objective, grid) -> OptimizeResult:
    """Minimize over explicit candidate points (grid.h:46-66)."""
    f = _value(_as_fn(objective))
    grid = torch.atleast_2d(_point(grid))
    vals = torch.stack([f(p) for p in grid])
    i = int(torch.argmin(vals))
    return OptimizeResult(grid[i], vals[i], grid.shape[0])


# -- line searches ------------------------------------------------------------
def _fixed_step(f, grad_f, x, p, step0):
    return step0


def _backtracking(f, grad_f, x, p, step0, alpha=2.0, beta=0.5, gamma=0.5, max_iter=40):
    """Armijo backtracking (backtracking_line_search.h:37-48): shrink alpha
    until f(x) - f(x + alpha p) >= -gamma * alpha * grad.p."""
    fx = float(f(x))
    gTp = float(torch.dot(grad_f(x), p))
    a, k = alpha, 0
    while float(f(x + a * p)) > fx + gamma * a * gTp and k < max_iter:
        a, k = a * beta, k + 1
    return a


def _wolfe(f, grad_f, x, p, step0, c1=1e-4, c2=0.9, max_iter=40):
    """Weak-Wolfe bisection (wolfe_line_search.h:27-62)."""
    fx = float(f(x))
    gTp = float(torch.dot(grad_f(x), p))
    a, lo, hi, k = float(step0), 0.0, math.inf, 0
    while k < max_iter:
        xa = x + a * p
        armijo = float(f(xa)) <= fx + c1 * a * gTp
        if armijo and float(torch.dot(grad_f(xa), p)) >= c2 * gTp:
            break
        # if Armijo fails: shrink (hi = a); else curvature failed: grow (lo = a)
        if armijo:
            lo = a
        else:
            hi = a
        a = 2 * lo if math.isinf(hi) else 0.5 * (lo + hi)
        k += 1
    return a


def _get_ls(line_search):
    """Resolve a line-search spec: None, a named policy, or a custom callable
    with signature (f, grad_f, x, p, step0) -> step (the callback protocol of
    optimization/callbacks/callbacks.h:26-61, reduced to its one hook)."""
    if callable(line_search):
        return line_search
    return {None: _fixed_step, "backtracking": _backtracking, "wolfe": _wolfe}[line_search]


# -- iterative optimizers -----------------------------------------------------
def _bfgs_update(H, s, y):
    """BFGS inverse-hessian update (bfgs.h:76-104); H kept when s.y ~ 0.

    V H V^T + rho s s^T with V = I - rho s y^T, expanded to rank-one terms
    in O(n^2) (JAX forms V and multiplies, O(n^3)): with Hy = H y,
    H - rho (s (Hy)^T + Hy s^T) + (rho^2 y^T Hy + rho) s s^T, H symmetric."""
    sy = float(torch.dot(s, y))
    if not abs(sy) > 1e-30:
        return H
    rho = 1.0 / sy
    Hy = H @ y
    c = rho * rho * float(torch.dot(y, Hy)) + rho
    return H - rho * (torch.outer(s, Hy) + torch.outer(Hy, s)) + c * torch.outer(s, s)


def _descent_loop(f, grad_f, direction, x0, step, tol, max_iter, line_search, H0=None):
    ls = _get_ls(line_search)
    x = _point(x0)
    g = grad_f(x)
    H = H0
    k = 0
    while float(torch.linalg.norm(g)) > tol and k < max_iter:
        p = direction(x, g, H)
        a = ls(f, grad_f, x, p, step)
        x_new = x + a * p
        g_new = grad_f(x_new)
        if H is not None:
            H = _bfgs_update(H, x_new - x, g_new - g)
        x, g, k = x_new, g_new, k + 1
    return OptimizeResult(x, f(x), k)


def gradient_descent(objective, x0, step=1e-2, tol=1e-6, max_iter=500,
                     line_search=None) -> OptimizeResult:
    obj = _as_fn(objective)
    return _descent_loop(_value(obj), _grad(obj), lambda x, g, H: -g, x0, step, tol,
                         max_iter, line_search)


def newton(objective, x0, step=1.0, tol=1e-6, max_iter=100, line_search=None) -> OptimizeResult:
    from ..linear_algebra.solvers import dense_solve

    obj = _as_fn(objective)
    hess_f = _hessian(obj)

    def direction(x, g, H):
        return -dense_solve(hess_f(x), g)  # newton.h:70-77

    return _descent_loop(_value(obj), _grad(obj), direction, x0, step, tol, max_iter,
                         line_search)


def bfgs(objective, x0, step=1.0, tol=1e-6, max_iter=200, line_search=None) -> OptimizeResult:
    obj = _as_fn(objective)
    x = _point(x0)
    H0 = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)  # bfgs.h:52
    return _descent_loop(_value(obj), _grad(obj), lambda x, g, H: -(H @ g), x, step, tol,
                         max_iter, line_search, H0=H0)
