"""BlockFrame: a typed, named-column data frame over NumPy arrays.

Host-only copy of ``fdapde_core_tpu/utils/block_frame.py`` (counterpart of
fdaPDE-core's fdaPDE/utils/data_structures/block_frame.h:39, named matrix
blocks with row views and dirty bits, and block_vector.h:24, strided
m-block views over a vector). The C++ type-list machinery is
unnecessary: columns are arrays keyed by name; views are cheap slices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BlockFrame", "BlockView", "BlockVector"]


class BlockFrame:
    """Named 2D blocks with a common number of rows (block_frame.h:39-202)."""

    def __init__(self, n_rows: int | None = None):
        self._blocks: dict[str, np.ndarray] = {}
        self._dirty: set[str] = set()
        self.n_rows = n_rows

    def insert(self, name: str, data) -> "BlockFrame":
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if self.n_rows is None:
            self.n_rows = data.shape[0]
        if data.shape[0] != self.n_rows:
            raise ValueError(
                f"block '{name}' has {data.shape[0]} rows, frame has {self.n_rows}"
            )
        self._blocks[name] = data
        self._dirty.add(name)
        return self

    def get(self, name: str) -> np.ndarray:
        return self._blocks[name]

    __getitem__ = get

    def __setitem__(self, name, data):
        self.insert(name, data)

    def has_block(self, name: str) -> bool:
        return name in self._blocks

    def columns(self):
        return list(self._blocks)

    def is_dirty(self, name: str) -> bool:
        return name in self._dirty

    def clear_dirty(self, name: str | None = None):
        if name is None:
            self._dirty.clear()
        else:
            self._dirty.discard(name)

    def row(self, i: int) -> "BlockView":
        """Single-row VIEW across all blocks (block_frame.h:202 BlockView
        with row access pattern) — reads through to the live frame, writes
        propagate back and mark the touched block dirty."""
        return BlockView(self, i)

    def range(self, begin: int, end: int) -> "BlockView":
        """Contiguous row-range view [begin, end) (range access pattern)."""
        return BlockView(self, slice(begin, end))

    def sparse_view(self, idxs) -> "BlockView":
        """Arbitrary row-subset view (sparse access pattern)."""
        return BlockView(self, np.asarray(idxs, dtype=np.int64))

    def rows(self, sl) -> "BlockFrame":
        """Materialized row-subset COPY (use row/range/sparse_view for
        write-through views)."""
        out = BlockFrame()
        for k, v in self._blocks.items():
            out.insert(k, v[sl])
        return out


class BlockView:
    """Write-through row view over a BlockFrame (block_frame.h:202).

    Covers the reference's three access patterns — single row, contiguous
    range, sparse index set — with one selector. `get` reads the CURRENT
    frame contents (no snapshot); `set`/`__setitem__` writes back into the
    parent and propagates the dirty bit (block_frame.h dirty-bit semantics:
    mutating through a view marks the underlying block modified)."""

    def __init__(self, frame: "BlockFrame", sel):
        self._frame = frame
        # a single row keeps its leading axis (consistent shapes across the
        # three access patterns)
        self._sel = slice(sel, sel + 1) if isinstance(sel, int) else sel

    @property
    def n_rows(self) -> int:
        if isinstance(self._sel, slice):
            start, stop, step = self._sel.indices(self._frame.n_rows)
            return max(0, (stop - start + (step - 1)) // step)
        if isinstance(self._sel, np.ndarray):
            return int(self._sel.size)
        return 1

    def columns(self):
        return self._frame.columns()

    def get(self, name: str) -> np.ndarray:
        return self._frame.get(name)[self._sel]

    __getitem__ = get

    def set(self, name: str, value) -> None:
        block = self._frame.get(name)
        block[self._sel] = value
        self._frame._dirty.add(name)

    __setitem__ = set

    def as_dict(self) -> dict:
        return {k: self.get(k) for k in self._frame.columns()}

    def materialize(self) -> "BlockFrame":
        """Copy the viewed rows into a standalone frame."""
        out = BlockFrame()
        for k in self._frame.columns():
            out.insert(k, np.array(self.get(k)))
        return out


class BlockVector:
    """View of a vector in contiguous m-sized blocks (block_vector.h:24)."""

    def __init__(self, data, block_size: int):
        self.data = np.asarray(data).reshape(-1)
        assert self.data.size % block_size == 0, "size must divide into blocks"
        self.m = block_size
        self.n_blocks = self.data.size // block_size

    def block(self, i: int) -> np.ndarray:
        return self.data[i * self.m : (i + 1) * self.m]

    __getitem__ = block

    def __setitem__(self, i, value):
        self.data[i * self.m : (i + 1) * self.m] = value

    def blocks(self, start: int, count: int) -> np.ndarray:
        return self.data[start * self.m : (start + count) * self.m]
