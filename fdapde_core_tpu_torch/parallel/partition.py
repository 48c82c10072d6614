"""Element partitioning for multi-device meshes.

Port of ``fdapde_core_tpu/parallel/partition.py`` (a host copy).
Space-filling-curve ordering: interleave the bits of quantized cell
barycenters (Morton/Z-order) so that contiguous index blocks are spatially
compact; contiguous blocks then go one per shard, which localizes the dof
footprint of each shard.
"""

from __future__ import annotations

import numpy as np

__all__ = ["morton_order", "partition_elements"]


def _interleave_bits(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Morton code from integer coordinates (k, d) -> (k,) uint64."""
    k, d = coords.shape
    out = np.zeros(k, dtype=np.uint64)
    for b in range(bits):
        for axis in range(d):
            out |= ((coords[:, axis].astype(np.uint64) >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d + axis)
    return out


def morton_order(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points along a Z-order curve."""
    points = np.asarray(points, dtype=np.float64)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = ((points - lo) / span * (2**bits - 1)).astype(np.uint64)
    return np.argsort(_interleave_bits(q, bits), kind="stable")


def partition_elements(mesh, n_parts: int, order: np.ndarray | None = None):
    """Partition cells into n_parts equal contiguous blocks along the SFC.

    Returns (perm, mask, block_size): ``perm`` is a padded permutation of
    cell ids of length n_parts * block_size (padding repeats the last cell;
    ``mask`` is False on the padded copies, which get weight 0 at assembly),
    laid out so that perm.reshape(n_parts, block_size)[p] are shard p's
    cells.
    """
    if order is None:
        order = morton_order(mesh.cell_barycenters)
    C = mesh.n_cells
    block = -(-C // n_parts)  # ceil
    padded = np.concatenate(
        [order, np.full(n_parts * block - C, order[-1], dtype=order.dtype)]
    )
    mask = np.concatenate(
        [np.ones(C, dtype=bool), np.zeros(n_parts * block - C, dtype=bool)]
    )
    return padded.astype(np.int32), mask, block
