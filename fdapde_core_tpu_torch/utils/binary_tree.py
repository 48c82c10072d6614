"""Binary trees and binary search trees (host-side infrastructure).

Host-only copy of ``fdapde_core_tpu/utils/binary_tree.py`` (counterpart of
fdaPDE-core's fdaPDE/utils/data_structures/binary_tree.h:27-372, a
pointer-based BinaryTree with dfs/bfs/leaf iterators and a BST on top).
Stored as flat arrays (value, left, right, parent) — the layout the
KD-tree (geometry/kd_tree.py) also uses.
"""

from __future__ import annotations

from collections import deque

__all__ = ["BinaryTree", "BST"]


class BinaryTree:
    """Array-backed binary tree of Python values."""

    def __init__(self):
        self.values = []
        self.left = []
        self.right = []
        self.parent = []
        self.root = -1

    def __len__(self):
        return len(self.values)

    def _new_node(self, value, parent):
        self.values.append(value)
        self.left.append(-1)
        self.right.append(-1)
        self.parent.append(parent)
        return len(self.values) - 1

    def set_root(self, value) -> int:
        assert self.root == -1, "root already set"
        self.root = self._new_node(value, -1)
        return self.root

    def push_left(self, node: int, value) -> int:
        assert self.left[node] == -1
        idx = self._new_node(value, node)
        self.left[node] = idx
        return idx

    def push_right(self, node: int, value) -> int:
        assert self.right[node] == -1
        idx = self._new_node(value, node)
        self.right[node] = idx
        return idx

    # -- iterators (binary_tree.h dfs/bfs/leaf) --------------------------------
    def dfs(self):
        """Pre-order depth-first values."""
        stack = [self.root] if self.root >= 0 else []
        while stack:
            n = stack.pop()
            yield self.values[n]
            if self.right[n] >= 0:
                stack.append(self.right[n])
            if self.left[n] >= 0:
                stack.append(self.left[n])

    def bfs(self):
        q = deque([self.root] if self.root >= 0 else [])
        while q:
            n = q.popleft()
            yield self.values[n]
            if self.left[n] >= 0:
                q.append(self.left[n])
            if self.right[n] >= 0:
                q.append(self.right[n])

    def leaves(self):
        for n in range(len(self.values)):
            if self.left[n] == -1 and self.right[n] == -1:
                yield self.values[n]


class BST(BinaryTree):
    """Binary search tree (binary_tree.h:293)."""

    def insert(self, value) -> int:
        if self.root == -1:
            return self.set_root(value)
        n = self.root
        while True:
            if value < self.values[n]:
                if self.left[n] == -1:
                    return self.push_left(n, value)
                n = self.left[n]
            else:
                if self.right[n] == -1:
                    return self.push_right(n, value)
                n = self.right[n]

    def sorted(self):
        """In-order traversal."""
        out, stack, n = [], [], self.root
        while stack or n >= 0:
            while n >= 0:
                stack.append(n)
                n = self.left[n]
            n = stack.pop()
            out.append(self.values[n])
            n = self.right[n]
        return out

    def contains(self, value) -> bool:
        n = self.root
        while n >= 0:
            if self.values[n] == value:
                return True
            n = self.left[n] if value < self.values[n] else self.right[n]
        return False
