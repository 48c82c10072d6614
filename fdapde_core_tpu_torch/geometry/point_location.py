"""Point location: which cell contains each query point.

Port of ``fdapde_core_tpu/geometry/point_location.py``. ``contains`` and
``CellLocator`` are host NumPy copies: a uniform-grid candidate filter plus
the exact barycentric test of the reference (simplex.h:115-127, including
the manifold supporting-plane distance check), in place of its ADT tree
search (tree_search.h) and walk (walk_search.h).

``DeviceCellLocator`` runs the same search in torch on a device: the host
locator's bin table padded to (n_bins, K) (``padded_bin_table``, the
candidates of each bin in the order of its stable argsort), the K
candidates' invJ and first vertex gathered per point, the exact test with
``MACHINE_EPSILON``, and the first candidate that passes. The candidate
order and the test are the host's, so both give the same cell, also for a
point on an edge two cells share. Points are taken in batches of
``_BATCH`` (2^20) so that the (batch, K, M, N) gathers stay bounded.
"""

from __future__ import annotations

import numpy as np
import torch

MACHINE_EPSILON = 10 * np.finfo(np.float64).eps  # utils/symbols.h:164
_BATCH = 1 << 20  # query points per device batch

__all__ = ["CellLocator", "DeviceCellLocator", "MACHINE_EPSILON", "contains"]


def contains(mesh, cell_ids: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Exact containment test of points[i] in cell cell_ids[i] (vectorized).

    Mirrors Simplex::contains (simplex.h:115-127): barycentric coordinates
    must all be >= -machine_epsilon; on manifolds the point must additionally
    lie on the supporting plane (distance <= machine_epsilon).
    """
    from .affine import affine_maps_np

    J, invJ, _ = affine_maps_np(mesh.nodes, mesh.cells)
    p0 = mesh.nodes[mesh.cells[cell_ids, 0]]  # (k, N)
    d = points - p0
    z = np.einsum("kmn,kn->km", invJ[cell_ids], d)  # (k, M)
    z0 = 1.0 - z.sum(axis=1)
    inside = (z >= -MACHINE_EPSILON).all(axis=1) & (z0 >= -MACHINE_EPSILON)
    if mesh.is_manifold:
        # distance from supporting plane: || p - (p0 + J z) ||
        proj = p0 + np.einsum("knm,km->kn", J[cell_ids], z)
        dist = np.linalg.norm(points - proj, axis=1)
        inside &= dist <= MACHINE_EPSILON
    return inside


class CellLocator:
    """Uniform-grid spatial index over cell bounding boxes."""

    def __init__(self, mesh, resolution: int | None = None):
        self.mesh = mesh
        coords = mesh.cell_coords  # (C, M+1, N)
        self.lo = coords.min(axis=1)  # (C, N)
        self.hi = coords.max(axis=1)
        self.gmin = mesh.range[0]
        self.gmax = mesh.range[1]
        N = mesh.embed_dim
        if resolution is None:
            resolution = max(1, int(np.ceil(mesh.n_cells ** (1.0 / N))))
        self.res = resolution
        span = np.where(self.gmax > self.gmin, self.gmax - self.gmin, 1.0)
        self.scale = self.res / span
        # bin ranges per cell; register each cell in all bins its bbox
        # overlaps — fully vectorized (ragged expansion over the span grid)
        lo_bin = self._bin(self.lo)  # (C, N)
        hi_bin = self._bin(self.hi)
        spans = hi_bin - lo_bin + 1
        counts = spans.prod(axis=1)
        total = int(counts.sum())
        cell_ids = np.repeat(np.arange(mesh.n_cells, dtype=np.int32), counts)
        resets = np.repeat(np.cumsum(counts) - counts, counts)
        local = np.arange(total, dtype=np.int64) - resets  # rank within cell
        spans_rep = spans[cell_ids]
        lo_rep = lo_bin[cell_ids]
        # decode row-major local rank into per-axis offsets
        bin_ids = np.zeros(total, dtype=np.int64)
        divisor = np.ones(total, dtype=np.int64)
        for d in range(N - 1, -1, -1):
            off = (local // divisor) % spans_rep[:, d]
            bin_ids += (lo_rep[:, d] + off) * self.res ** (N - 1 - d)
            divisor *= spans_rep[:, d]
        order = np.argsort(bin_ids, kind="stable")
        self.bin_cells = cell_ids[order]
        counts = np.bincount(bin_ids, minlength=self.res**N)
        self.bin_offsets = np.zeros(self.res**N + 1, dtype=np.int64)
        np.cumsum(counts, out=self.bin_offsets[1:])

    def _bin(self, pts):
        b = np.floor((pts - self.gmin) * self.scale).astype(np.int64)
        return np.clip(b, 0, self.res - 1)

    def padded_bin_table(self):
        """(n_bins, K) candidate table, -1 padded, K = max bin occupancy.

        The static-shape form of (bin_offsets, bin_cells) consumed by
        DeviceCellLocator."""
        counts = np.diff(self.bin_offsets)
        K = max(1, int(counts.max()))
        n_bins = counts.size
        table = np.full((n_bins, K), -1, dtype=np.int32)
        # ragged fill without a Python loop
        bins = np.repeat(np.arange(n_bins), counts)
        slot = np.arange(self.bin_cells.size) - np.repeat(
            self.bin_offsets[:-1], counts
        )
        table[bins, slot] = self.bin_cells
        return table

    def locate(self, points: np.ndarray) -> np.ndarray:
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = points.shape[0]
        out = np.full(n, -1, dtype=np.int32)
        inside_box = np.logical_and(
            (points >= self.gmin - MACHINE_EPSILON).all(axis=1),
            (points <= self.gmax + MACHINE_EPSILON).all(axis=1),
        )
        bins = np.ravel_multi_index(
            self._bin(points).T, (self.res,) * self.mesh.embed_dim
        )
        # expand (point, candidate cell) pairs, then one vectorized contains()
        starts = self.bin_offsets[bins]
        ends = self.bin_offsets[bins + 1]
        counts = (ends - starts) * inside_box
        pt_idx = np.repeat(np.arange(n), counts)
        if pt_idx.size:
            # ragged arange: flat candidate positions without a Python loop
            total = int(counts.sum())
            resets = np.repeat(np.cumsum(counts) - counts, counts)
            pos = np.arange(total) - resets + np.repeat(starts, counts)
            cand = self.bin_cells[pos]
            hit = contains(self.mesh, cand, points[pt_idx])
            # keep first hit per point
            hp, hc = pt_idx[hit], cand[hit]
            # reverse so earlier candidates win after assignment
            out[hp[::-1]] = hc[::-1]
        return out


class DeviceCellLocator:
    """Point location on a device: the host locator's bins as a dense
    (n_bins, K) candidate table and the exact containment test over all K
    candidates of each point at once, in torch.

    The device-scale replacement of the reference's per-point ADT search
    (tree_search.h:28-84) for the millions of observation points that feed
    the Psi matrix (lagrangian_basis.h:203-235): O(K) work per point, no
    host pointer chasing. Same cells as ``CellLocator``, float64 throughout.
    """

    def __init__(self, mesh, resolution: int | None = None, device="cuda"):
        from .affine import affine_maps_np

        host = CellLocator(mesh, resolution)
        self.mesh = mesh
        self.res = host.res
        self.device = torch.device(device)
        table = host.padded_bin_table()
        self.capacity = table.shape[1]

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=self.device)

        J, invJ, _ = affine_maps_np(mesh.nodes, mesh.cells)
        self.table = torch.as_tensor(table, device=self.device)  # (res^N, K) int32
        self.invJ = f64(invJ)  # (C, M, N)
        self.J = f64(J) if mesh.is_manifold else None
        self.p0 = f64(mesh.nodes[mesh.cells[:, 0]])  # (C, N)
        self.gmin = f64(host.gmin)
        self.gmax = f64(host.gmax)
        self.scale = f64(host.scale)
        self.is_manifold = mesh.is_manifold

    def locate(self, points):
        """points (n, N) -> (n,) int32 cell ids (-1 outside), on the
        locator's device."""
        points = torch.as_tensor(points, dtype=torch.float64, device=self.device)
        if points.dim() == 1:
            points = points[None, :]
        parts = [self._locate(points[i:i + _BATCH]) for i in range(0, points.shape[0], _BATCH)]
        if not parts:
            return torch.zeros(0, dtype=torch.int32, device=self.device)
        return torch.cat(parts)

    def _locate(self, points):
        n, N = points.shape
        b = torch.floor((points - self.gmin) * self.scale).to(torch.int64)
        b = b.clamp(0, self.res - 1)
        # row-major flat bin id (CellLocator's encoding)
        flat = b[:, 0]
        for d in range(1, N):
            flat = flat * self.res + b[:, d]
        cand = self.table[flat].long()  # (n, K)
        safe = cand.clamp_min(0)
        d = points[:, None, :] - self.p0[safe]  # (n, K, N)
        z = torch.einsum("nkmj,nkj->nkm", self.invJ[safe], d)  # (n, K, M)
        z0 = 1.0 - z.sum(dim=-1)
        eps = MACHINE_EPSILON
        inside = (z >= -eps).all(dim=-1) & (z0 >= -eps) & (cand >= 0)
        if self.is_manifold:
            proj = self.p0[safe] + torch.einsum("nkjm,nkm->nkj", self.J[safe], z)
            dist = torch.linalg.norm(points[:, None, :] - proj, dim=-1)
            inside &= dist <= eps
        in_box = ((points >= self.gmin - eps) & (points <= self.gmax + eps)).all(dim=1)
        inside &= in_box[:, None]
        first = torch.argmax(inside.to(torch.uint8), dim=1)  # first True (0 if none)
        found = inside.any(dim=1)
        hit = torch.gather(cand, 1, first[:, None])[:, 0]
        return torch.where(found, hit, -1).to(torch.int32)
