"""Bandwidth-reducing dof reorderings (host-side, one-time preprocessing).

Port of ``fdapde_core_tpu/parallel/reorder.py`` (a host copy). The
reference-parity dof numbering (P2 edge dofs at n_nodes + edge_id) is
golden for assembly parity but hostile to banded solver formats: a vertex
dof couples to edge dofs numbered ~n_nodes away, so the DIA offset set
spans the whole matrix. The halo solvers therefore apply a
locality-restoring permutation first:

- ``rcm_permutation``: reverse Cuthill-McKee on the dof coupling graph,
  the classic bandwidth minimizer, for any mesh and order; the native C++
  BFS (``native/rcm.cpp``, the same tie-breaking) when a g++ is on PATH,
  else the NumPy BFS below;
- structured meshes can instead use the Morton ordering of
  ``parallel/partition.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["rcm_permutation", "permute_system"]


def _adjacency_csr(rows, cols, n: int):
    """Symmetrized dedup'd adjacency in CSR (no self loops)."""
    r = np.asarray(rows, dtype=np.int64)
    c = np.asarray(cols, dtype=np.int64)
    keep = r != c
    r, c = r[keep], c[keep]
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    key = np.unique(rr * n + cc)
    rr, cc = key // n, key % n
    indptr = np.searchsorted(rr, np.arange(n + 1))
    return indptr, cc.astype(np.int64)


def _rcm_native(indptr, adj, n: int):
    """Native C++ RCM (None without a g++ on PATH; a failed build raises)."""
    from ..native.build import get_lib, native_available

    if not native_available():
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    adj = np.ascontiguousarray(adj, dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    got = get_lib().rcm_order(
        indptr.ctypes.data_as(ctypes.c_void_p),
        adj.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        perm.ctypes.data_as(ctypes.c_void_p),
    )
    if got != n:
        raise RuntimeError(f"native rcm_order ordered {got} of {n} nodes")
    return perm


def rcm_permutation(rows, cols, n: int):
    """Reverse Cuthill-McKee ordering of the graph with edges (rows, cols).

    Returns (perm, inv): perm[new] = old (gather order), inv[old] = new.
    BFS from a minimum-degree node per component, neighbors visited in
    increasing-degree order, final order reversed.
    """
    indptr, adj = _adjacency_csr(rows, cols, n)
    perm = _rcm_native(indptr, adj, n)
    if perm is None:
        degree = np.diff(indptr)
        visited = np.zeros(n, dtype=bool)
        order = np.empty(n, dtype=np.int64)
        pos = 0
        # component seeds in min-degree order
        for seed in np.argsort(degree, kind="stable"):
            if visited[seed]:
                continue
            visited[seed] = True
            order[pos] = seed
            head, pos = pos, pos + 1
            while head < pos:
                u = order[head]
                head += 1
                nbrs = adj[indptr[u]:indptr[u + 1]]
                nbrs = nbrs[~visited[nbrs]]
                if nbrs.size:
                    nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                    visited[nbrs] = True
                    order[pos:pos + nbrs.size] = nbrs
                    pos += nbrs.size
        perm = order[::-1].copy()  # reverse CM
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return perm, inv


def permute_system(perm, inv, rows, cols, vals=None):
    """COO entries of P A P^T: A'[inv[i], inv[j]] = A[i, j].

    Solve A' x' = b[perm], then x = x'[inv].
    """
    inv = np.asarray(inv)
    r = inv[np.asarray(rows)]
    c = inv[np.asarray(cols)]
    return (r, c) if vals is None else (r, c, vals)
