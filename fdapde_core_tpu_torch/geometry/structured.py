"""Triangulations of [0, 1]^2 and tetrahedralizations of [0, 1]^3: the
uniform host meshes and irregular device meshes.

Port of ``fdapde_core_tpu/geometry/structured.py``. ``unit_square_mesh``
and ``unit_cube_mesh`` are NumPy copies (host ``Triangulation``s, the node
and cell numbering of the JAX functions). In ``irregular_mesh_device`` and
``irregular_mesh_device_soa`` the same deterministic sin-hash picks
each quad's diagonal and jitters the interior nodes, so the same ``n`` and
``amp`` give the same mesh as the JAX package; ``cube_mesh_device`` and
``cube_mesh_device_soa`` jitter the interior nodes of the Freudenthal
(Kuhn) tetrahedralization with the JAX package's 3D hash.

The hash is reproducible across libraries only in float64: ``sin`` of
arguments around 3e5 is rounded differently by different float32
implementations, which moves coordinates and can even flip a diagonal.
Both functions therefore default to float64.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .triangulation import Triangulation

__all__ = ["cube_mesh_device", "cube_mesh_device_soa", "irregular_mesh_device",
           "irregular_mesh_device_soa", "unit_cube_mesh", "unit_square_mesh"]


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


def _kuhn_tets(base, step):
    """The 6 Kuhn tets of the cubes whose corner (0, 0, 0) has node id
    ``base``: one per permutation of the axis order (itertools order), the
    monotone lattice path v0 -> v3; odd permutations store (v0, v2, v1, v3),
    so every tet is positively oriented. Returns 6 (v0, v1, v2, v3) tuples."""
    evens = ((0, 1, 2), (1, 2, 0), (2, 0, 1))
    out = []
    for perm in itertools.permutations(range(3)):
        v0 = base
        v1 = v0 + step[perm[0]]
        v2 = v1 + step[perm[1]]
        v3 = v2 + step[perm[2]]
        out.append((v0, v1, v2, v3) if perm in evens else (v0, v2, v1, v3))
    return out


def unit_cube_mesh(n: int) -> Triangulation:
    """Freudenthal (Kuhn) triangulation of [0,1]^3: (n+1)^3 nodes, 6 n^3 tets.

    Node id of lattice point (i, j, k) is i m^2 + j m + k, m = n + 1. Cells
    are grouped by permutation type (all n^3 type-0 cubes first, ...), the
    order the structured 3D stencil (ops/grid3d.p1_cube_stencil) reads.
    """
    m = n + 1
    xs = np.linspace(0.0, 1.0, m)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    base = (i * m * m + j * m + k).reshape(-1)  # corner (0,0,0) of each cube
    blocks = [np.stack(t, axis=1) for t in _kuhn_tets(base, np.array([m * m, m, 1]))]
    cells = np.concatenate(blocks, axis=0).astype(np.int32)
    on_bnd = ((nodes == 0.0) | (nodes == 1.0)).any(axis=1)
    return Triangulation(nodes, cells, on_bnd)


def _jittered_cube(n, amp, dtype, device):
    """Node coordinates x, y, z (m^3,) of the jittered lattice, node
    (i, j, k) at id i m^2 + j m + k."""
    m = n + 1
    gi = torch.arange(m, dtype=dtype, device=device)[:, None, None]
    gj = torch.arange(m, dtype=dtype, device=device)[None, :, None]
    gk = torch.arange(m, dtype=dtype, device=device)[None, None, :]
    interior = ((gi > 0) & (gi < n) & (gj > 0) & (gj < n) & (gk > 0) & (gk < n)).to(dtype)

    def frac(ka, kb, kc, scale):
        h = torch.sin(gi * ka + gj * kb + gk * kc) * scale
        return h - torch.floor(h) - 0.5

    X = (gi + frac(12.9898, 78.2330, 37.7190, 43758.5453) * amp * interior) / n
    Y = (gj + frac(39.4250, 11.1350, 83.1550, 27183.1415) * amp * interior) / n + 0.0 * X
    Z = (gk + frac(21.9898, 57.2330, 13.3730, 31415.9265) * amp * interior) / n + 0.0 * X
    return X.reshape(-1), Y.reshape(-1), Z.reshape(-1)


def cube_mesh_device_soa(n: int, amp=0.2, dtype=torch.float64, device="cuda"):
    """Jittered Freudenthal tetrahedralization of [0,1]^3 in SoA layout:
    (x, y, z, c0, c1, c2, c3, boundary).

    x, y, z: (m^3,) node coordinates (m = n + 1), node (i, j, k) at id
    i m^2 + j m + k; c0..c3: (6 n^3,) int32 corner ids, cube-major cell
    order (cell = cube * 6 + permutation type); boundary: (m^3,) bool.
    The topology is unit_cube_mesh's (per-cube diagonal choices would break
    face conformity in 3D); interior nodes move by up to amp/2 cells per
    coordinate. Node-tet incidence <= 24, neighbours <= 14.
    """
    m = n + 1
    x, y, z = _jittered_cube(n, amp, dtype, device)
    on_bnd = (x == 0.0) | (x == 1.0) | (y == 0.0) | (y == 1.0) | (z == 0.0) | (z == 1.0)
    ci = torch.arange(n, dtype=torch.int32, device=device)
    base = (ci[:, None, None] * (m * m) + ci[None, :, None] * m + ci[None, None, :]).reshape(-1)
    tets = _kuhn_tets(base, (m * m, m, 1))
    # cube-major interleave: cell index = cube * 6 + permutation
    c0, c1, c2, c3 = (torch.stack([t[j] for t in tets], dim=1).reshape(-1) for j in range(4))
    return x, y, z, c0, c1, c2, c3, on_bnd


def cube_mesh_device(n: int, amp=0.2, dtype=torch.float64, device="cuda"):
    """The same mesh as ``cube_mesh_device_soa`` in stacked layout:
    (nodes (m^3, 3), cells (6 n^3, 4) int32, boundary (m^3,) bool)."""
    x, y, z, c0, c1, c2, c3, on_bnd = cube_mesh_device_soa(n, amp, dtype, device)
    return torch.stack([x, y, z], dim=1), torch.stack([c0, c1, c2, c3], dim=1), on_bnd
