"""The benchmark's meshes, made from fixed parameters and never by the
program under test.

Frozen copies, so that a change to the program cannot change what is
measured:

- ``criss_cross_mesh``: the jittered criss-cross lattice, copied from
  ``fdapde_core_tpu_torch/geometry/structured.py`` (``_frac_hash``,
  ``_jittered_planes``, ``_quad_corners``, ``irregular_mesh_device_soa``
  and ``irregular_mesh_device``), the mesh of ``bench.py``'s ``gen10m`` and
  ``genscat`` groups;
- ``scramble_perm`` and ``scrambled``: the block-local relabelling of
  ``chip_smoke.py``'s ``scramble_perm`` and ``scrambled_mesh``;
- ``jittered_lattice`` and ``delaunay_mesh``: ``chip_smoke.py``'s copies
  of ``bench.py``'s ``general`` mesh (bench.py:695-705).
"""

from __future__ import annotations

import numpy as np
import torch


def _frac_hash(a, b, ka, kb, scale):
    h = torch.sin(a * ka + b * kb) * scale
    return h - torch.floor(h)


def criss_cross_mesh(n: int, amp: float = 0.2, dtype=torch.float64, device="cuda"):
    """The irregular n x n criss-cross triangulation of [0, 1]^2:
    (nodes (m^2, 2), cells (2 n^2, 3) int32, boundary (m^2,) bool), m = n + 1,
    node (i, j) at id i m + j. A sin hash picks each quad's diagonal and
    moves every interior node by up to amp / 2 cells a coordinate."""
    m = n + 1
    gi = torch.arange(m, dtype=dtype, device=device)[:, None]
    gj = torch.arange(m, dtype=dtype, device=device)[None, :]
    interior = ((gi > 0) & (gi < n) & (gj > 0) & (gj < n)).to(dtype)
    hx = _frac_hash(gi, gj, 12.9898, 78.233, 43758.5453)
    hy = _frac_hash(gi, gj, 39.4250, 11.1350, 27183.1415)
    X = (gi + (hx - 0.5) * amp * interior) / n
    Y = (gj + (hy - 0.5) * amp * interior) / n + 0.0 * X
    x, y = X.reshape(-1), Y.reshape(-1)
    on_bnd = (x == 0.0) | (x == 1.0) | (y == 0.0) | (y == 1.0)

    qi = torch.arange(n, dtype=dtype, device=device)[:, None]
    qj = torch.arange(n, dtype=dtype, device=device)[None, :]
    flip = _frac_hash(qi, qj, 7.1312, 3.7177, 15731.7431) < 0.5
    ar = torch.arange(n, dtype=torch.int32, device=device)
    a = ar[:, None] * m + ar[None, :]
    b = a + m
    # standard diagonal a..b+1: (a, b, a+1), (b, b+1, a+1);
    # flipped diagonal b..a+1:  (a, b, b+1), (a, b+1, a+1)
    t0 = (a, b, torch.where(flip, b + 1, a + 1))
    t1 = (torch.where(flip, a, b), b + 1, a + 1)
    c0, c1, c2 = (torch.stack([u, v], dim=2).reshape(-1) for u, v in zip(t0, t1))
    return torch.stack([x, y], dim=1), torch.stack([c0, c1, c2], dim=1), on_bnd


def scramble_perm(nd: int, S: int, G: int, device="cuda"):
    """(p, pinv) of the block-local relabelling i -> (i // S) S + (G (i % S)) % S
    (G coprime with S; a trailing partial block keeps its ids): node i
    becomes node p[i]; relabelled node k is node pinv[k]."""
    nfull = (nd // S) * S
    i = torch.arange(nd, device=device)
    p = torch.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
    pinv = torch.where(i < nfull, (i // S) * S + (pow(G, -1, S) * (i % S)) % S, i)
    return p, pinv


def scrambled(nodes, cells, boundary, S: int, G: int):
    """The same mesh with its nodes relabelled by ``scramble_perm``."""
    p, pinv = scramble_perm(nodes.shape[0], S, G, device=nodes.device)
    return nodes[pinv], p[cells.long()].to(torch.int32), boundary[pinv]


def jittered_lattice(nx: int, seed: int = 7, amp: float = 0.35):
    """The (nx+1)^2 lattice of [0, 1]^2 with interior nodes jittered by
    +-amp h: (nodes (N, 2), boundary (N,) bool), node (i, j) at i (nx+1) + j."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    return pts, ~interior


def delaunay_mesh(nx: int, seed: int = 7, amp: float = 0.35):
    """``bench.py``'s ``general`` mesh: the jittered lattice triangulated by
    scipy's Delaunay. Host NumPy: (nodes (N, 2), cells (C, 3) int32,
    boundary (N,) bool, the scipy ``Delaunay`` object)."""
    from scipy.spatial import Delaunay

    pts, bnd = jittered_lattice(nx, seed, amp)
    tri = Delaunay(pts)
    return pts, tri.simplices.astype(np.int32), bnd, tri
