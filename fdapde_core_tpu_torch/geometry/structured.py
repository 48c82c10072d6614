"""Triangulations of [0, 1]^2: the uniform host mesh and irregular device
meshes.

Port of ``fdapde_core_tpu/geometry/structured.py``. ``unit_square_mesh``
is a NumPy copy (a host ``Triangulation``, the node and cell numbering of
the JAX function). In ``irregular_mesh_device`` and
``irregular_mesh_device_soa`` the same deterministic sin-hash picks
each quad's diagonal and jitters the interior nodes, so the same ``n`` and
``amp`` give the same mesh as the JAX package.

The hash is reproducible across libraries only in float64: ``sin`` of
arguments around 3e5 is rounded differently by different float32
implementations, which moves coordinates and can even flip a diagonal.
Both functions therefore default to float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .triangulation import Triangulation

__all__ = ["irregular_mesh_device", "irregular_mesh_device_soa", "unit_square_mesh"]


def unit_square_mesh(n: int) -> Triangulation:
    """Uniform triangulation of [0,1]^2 with (n+1)^2 nodes, 2*n^2 cells."""
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).reshape(-1)  # lower-left node of each quad
    b = a + (n + 1)  # lower-right (next row in x)
    lower = np.stack([a, b, a + 1], axis=1)
    upper = np.stack([b, b + 1, a + 1], axis=1)
    cells = np.concatenate([lower, upper], axis=0).astype(np.int32)
    boundary = (
        (nodes[:, 0] == 0.0)
        | (nodes[:, 0] == 1.0)
        | (nodes[:, 1] == 0.0)
        | (nodes[:, 1] == 1.0)
    )
    return Triangulation(nodes, cells, boundary)


def _frac_hash(a, b, ka, kb, scale):
    h = torch.sin(a * ka + b * kb) * scale
    return h - torch.floor(h)


def _jittered_planes(n, amp, dtype, device):
    """Node coordinate planes X, Y (m, m): node (i, j) at row i, column j."""
    m = n + 1
    gi = torch.arange(m, dtype=dtype, device=device)[:, None]
    gj = torch.arange(m, dtype=dtype, device=device)[None, :]
    interior = ((gi > 0) & (gi < n) & (gj > 0) & (gj < n)).to(dtype)
    hx = _frac_hash(gi, gj, 12.9898, 78.233, 43758.5453)
    hy = _frac_hash(gi, gj, 39.4250, 11.1350, 27183.1415)
    X = (gi + (hx - 0.5) * amp * interior) / n
    Y = (gj + (hy - 0.5) * amp * interior) / n + 0.0 * X
    return X, Y


def _quad_corners(n, dtype, device):
    """Per-quad diagonal choice and corners a = node (i, j), b = (i+1, j)."""
    m = n + 1
    qi = torch.arange(n, dtype=dtype, device=device)[:, None]
    qj = torch.arange(n, dtype=dtype, device=device)[None, :]
    flip = _frac_hash(qi, qj, 7.1312, 3.7177, 15731.7431) < 0.5
    ar = torch.arange(n, dtype=torch.int32, device=device)
    a = ar[:, None] * m + ar[None, :]
    return flip, a, a + m


def irregular_mesh_device_soa(n: int, amp=0.2, dtype=torch.float64,
                              device="cuda"):
    """Irregular triangulation in SoA layout: (x, y, c0, c1, c2, boundary).

    x, y: (m^2,) node coordinates, node (i, j) at id i*m + j (m = n+1);
    c0, c1, c2: (2 n^2,) int32 corner ids, quad-major cell order
    t = 2*(i*n + j) + {0, 1}; boundary: (m^2,) bool. Each quad's diagonal
    is chosen by a hash (interior node degrees vary 4..8) and interior
    nodes move by up to amp/2 cells per coordinate (amp <= 0.2 keeps every
    triangle positively oriented).
    """
    X, Y = _jittered_planes(n, amp, dtype, device)
    x, y = X.reshape(-1), Y.reshape(-1)
    on_bnd = (x == 0.0) | (x == 1.0) | (y == 0.0) | (y == 1.0)
    flip, a, b = _quad_corners(n, dtype, device)
    # standard diagonal a..b+1: (a, b, a+1), (b, b+1, a+1);
    # flipped diagonal b..a+1:  (a, b, b+1), (a, b+1, a+1)
    t0 = (a, b, torch.where(flip, b + 1, a + 1))
    t1 = (torch.where(flip, a, b), b + 1, a + 1)
    c0, c1, c2 = (torch.stack([u, v], dim=2).reshape(-1) for u, v in zip(t0, t1))
    return x, y, c0, c1, c2, on_bnd


def irregular_mesh_device(n: int, amp=0.2, dtype=torch.float64, device="cuda"):
    """The same mesh as ``irregular_mesh_device_soa`` in stacked layout:
    (nodes (m^2, 2), cells (2 n^2, 3) int32, boundary (m^2,) bool)."""
    x, y, c0, c1, c2, on_bnd = irregular_mesh_device_soa(n, amp, dtype, device)
    return torch.stack([x, y], dim=1), torch.stack([c0, c1, c2], dim=1), on_bnd
