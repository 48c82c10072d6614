"""Block-sparse matrices: an R x C grid of sparse blocks viewed as one operator.

Port of ``fdapde_core_tpu/linear_algebra/block.py``, the counterpart of
fdaPDE-core's fdaPDE/linear_algebra/sparse_block_matrix.h: the reference
plugs a compile-time grid of Eigen sparse blocks into the Eigen expression
system; here the grid is a list-of-lists of `SparseMatrix` (or None for
empty blocks) with offset-shifted COO concatenation. ``@`` is one K2
product per block, on the blocks' device.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse import SparseMatrix

__all__ = ["SparseBlockMatrix"]


class SparseBlockMatrix:
    """Grid of sparse blocks; supports matvec and flattening to SparseMatrix."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.n_block_rows = len(blocks)
        self.n_block_cols = len(blocks[0])
        row_sizes = [None] * self.n_block_rows
        col_sizes = [None] * self.n_block_cols
        for i, row in enumerate(blocks):
            assert len(row) == self.n_block_cols, "ragged block grid"
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                if row_sizes[i] is None:
                    row_sizes[i] = blk.shape[0]
                if col_sizes[j] is None:
                    col_sizes[j] = blk.shape[1]
                assert blk.shape == (row_sizes[i], col_sizes[j]), "inconsistent block shapes"
        assert all(s is not None for s in row_sizes + col_sizes), "a full empty block row/col is ambiguous"
        self.row_offsets = np.concatenate([[0], np.cumsum(row_sizes)])
        self.col_offsets = np.concatenate([[0], np.cumsum(col_sizes)])
        self.shape = (int(self.row_offsets[-1]), int(self.col_offsets[-1]))

    def block(self, i: int, j: int):
        return self.blocks[i][j]

    def to_sparse(self) -> SparseMatrix:
        rows, cols, vals = [], [], []
        for i, row in enumerate(self.blocks):
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                rows.append(blk.rows.cpu().numpy().astype(np.int64) + self.row_offsets[i])
                cols.append(blk.cols.cpu().numpy().astype(np.int64) + self.col_offsets[j])
                vals.append(blk.vals)
        return SparseMatrix.from_coo(
            np.concatenate(rows),
            np.concatenate(cols),
            torch.cat(vals),
            self.shape,
        )

    def __matmul__(self, x):
        dev = next(b for row in self.blocks for b in row if b is not None).vals.device
        x = torch.as_tensor(x, device=dev)
        outs = []
        for i, row in enumerate(self.blocks):
            acc = None
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                seg = x[self.col_offsets[j] : self.col_offsets[j + 1]]
                y = blk @ seg
                acc = y if acc is None else acc + y
            if acc is None:
                acc = x.new_zeros(int(self.row_offsets[i + 1] - self.row_offsets[i]))
            outs.append(acc)
        return torch.cat(outs)
