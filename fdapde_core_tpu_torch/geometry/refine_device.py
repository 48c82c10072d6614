"""Uniform mesh refinement and strip renumbering on the device.

Port of ``fdapde_core_tpu/geometry/refine_device.py``; every function runs
on its inputs' device. A small host Delaunay base mesh is grown on the
device by red refinement: each triangle splits into four at its edge
midpoints, so the base nodes keep their degrees and every new interior node
has degree 6, and the refined mesh keeps the base's ragged degree
histogram. For a simply connected planar triangulation Euler gives
n_edges = n_nodes + n_cells - 1, so each level's sizes are known before it
runs; the distinct edge count found is checked against it.

``strip_order`` and ``strip_order_binned`` renumber the nodes strip by
strip (y strips, sorted by x within each), which bounds the operator's
bandwidth by a few strip populations. Sorts are stable, so ties fall in
index order as in JAX's ``lax.sort``.

Two faults of JAX's ``strip_order_binned`` are not copied: its int32 key
``strip * 16384 + x14`` overflows once there are 2^17 strips or more (here
that raises ValueError), and its ``1e-300`` guards underflow to 0 in
float32, which gives NaN keys on constant coordinates (here the guard is
the dtype's smallest normal number).
"""

from __future__ import annotations

import torch

__all__ = ["device_edges", "refine_once", "uniform_refine_device",
           "strip_order", "strip_order_binned"]

_X_BINS = 16384  # strip_order_binned's x quantization (14 bits)


def device_edges(c0, c1, c2, n_nodes: int, n_edges: int):
    """Edge numbering of a triangulation: edges are numbered in the order
    of their sorted (min, max) node pairs.

    Returns (e01, e02, e12, edge_boundary, n_edges_actual): per-cell int32
    edge ids of the three lexicographic edges (the P2 and refinement slot
    order), a bool per edge id marking boundary edges (in one cell only),
    and the distinct pair count (a 0-dim tensor), the witness for the
    expected ``n_edges`` (ids past it are clipped to n_edges - 1).
    """
    C = c0.shape[0]
    pa = torch.cat([torch.minimum(c0, c1), torch.minimum(c0, c2), torch.minimum(c1, c2)])
    pb = torch.cat([torch.maximum(c0, c1), torch.maximum(c0, c2), torch.maximum(c1, c2)])
    key = pa.long() * n_nodes + pb.long()
    skey, spos = torch.sort(key, stable=True)
    newg = torch.ones_like(skey, dtype=torch.bool)
    newg[1:] = skey[1:] != skey[:-1]
    gid = torch.cumsum(newg, 0, dtype=torch.int32) - 1
    n_actual = gid[-1] + 1
    gid = torch.clamp(gid, max=n_edges - 1)
    eid = torch.empty(3 * C, dtype=torch.int32, device=c0.device).index_put_((spos,), gid)
    last = torch.ones_like(newg)
    last[:-1] = newg[1:]
    count1 = newg & last  # a group of one: a boundary edge
    # one write per group (its first position), so the ids are distinct
    edge_bnd = torch.zeros(n_edges, dtype=torch.bool, device=c0.device)
    edge_bnd[gid[newg].long()] = count1[newg]
    return eid[:C], eid[C:2 * C], eid[2 * C:], edge_bnd, n_actual


def _refine_tables(x, y, c0, c1, c2, bnd, e01, e02, e12, edge_bnd):
    n = x.shape[0]
    m01, m02, m12 = n + e01, n + e02, n + e12
    n_edges = edge_bnd.shape[0]
    xm = torch.zeros(n_edges, dtype=x.dtype, device=x.device)
    ym = torch.zeros(n_edges, dtype=y.dtype, device=y.device)
    # an edge shared by two cells is written twice with the same value (its
    # endpoints' sum is the same in either order)
    for ea, ca, cb in ((e01, c0, c1), (e02, c0, c2), (e12, c1, c2)):
        xm[ea.long()] = 0.5 * (x[ca] + x[cb])
        ym[ea.long()] = 0.5 * (y[ca] + y[cb])
    x2 = torch.cat([x, xm])
    y2 = torch.cat([y, ym])
    bnd2 = torch.cat([bnd, edge_bnd])
    # four orientation-preserving children per parent
    c0_2 = torch.cat([c0, m01, m02, m01])
    c1_2 = torch.cat([m01, c1, m12, m12])
    c2_2 = torch.cat([m02, m12, c2, m02])
    return x2, y2, c0_2, c1_2, c2_2, bnd2


def refine_once(x, y, c0, c1, c2, bnd):
    """One red-refinement level. Returns (x, y, c0, c1, c2, bnd, witness),
    ``witness`` the distinct edge count found (a 0-dim tensor; it equals
    n + C - 1 on a simply connected mesh)."""
    n, C = x.shape[0], c0.shape[0]
    e01, e02, e12, edge_bnd, n_act = device_edges(c0, c1, c2, n, n + C - 1)
    return (*_refine_tables(x, y, c0, c1, c2, bnd, e01, e02, e12, edge_bnd), n_act)


def uniform_refine_device(x, y, c0, c1, c2, bnd, levels: int):
    """``levels`` red refinements; raises ValueError when a level's edge
    count differs from Euler's n + C - 1 (a mesh that is not simply
    connected)."""
    wits = []
    for _ in range(levels):
        n, C = x.shape[0], c0.shape[0]
        x, y, c0, c1, c2, bnd, n_act = refine_once(x, y, c0, c1, c2, bnd)
        wits.append(n_act - (n + C - 1))
    if levels and int(torch.stack(wits).abs().max()) != 0:
        raise ValueError(
            "mesh is not simply connected: device edge counts deviate "
            f"from Euler's V+C-1 by {[int(w) for w in wits]} per level"
        )
    return x, y, c0, c1, c2, bnd


def _rank_of(order):
    """The inverse permutation: rank[order[j]] = j (int32)."""
    iota = torch.arange(order.shape[0], dtype=torch.int32, device=order.device)
    return torch.empty_like(iota).index_put_((order,), iota)


def strip_order(x, y, pop: int):
    """Equal-population strip renumbering: nodes sorted by (y-rank strip of
    ``pop`` nodes, x). Returns (order, rank), int32: new id j holds old node
    order[j]; old node i becomes rank[i]."""
    strip = _rank_of(torch.sort(y, stable=True).indices) // pop
    by_x = torch.sort(x, stable=True).indices
    order = by_x[torch.sort(strip[by_x], stable=True).indices]
    return order.to(torch.int32), _rank_of(order)


def _strip_keys(x, y, pop: int):
    """strip_order_binned's int32 sort keys, strip * 16384 + x quantized to
    14 bits, over S = max(1, n // pop) uniform y strips."""
    n = x.shape[0]
    S = max(1, n // pop)
    if S >= 2 ** 31 // _X_BINS:
        raise ValueError(f"{S} strips overflow the int32 key strip * {_X_BINS} + x; "
                         f"take pop >= n / {2 ** 31 // _X_BINS}")
    tiny = torch.finfo(x.dtype).tiny
    ylo, yhi = y.min(), y.max()
    xlo, xhi = x.min(), x.max()
    yn = (y - ylo) / torch.clamp(yhi - ylo, min=tiny)
    strip = torch.clamp((yn * S).to(torch.int32), 0, S - 1)
    xn = (x - xlo) / torch.clamp(xhi - xlo, min=tiny)
    # x = xhi goes to the last bin of its strip (JAX clamps xn to 1 - 1e-12
    # instead, which is 1 in float32)
    x14 = torch.clamp((xn * float(_X_BINS)).to(torch.int32), max=_X_BINS - 1)
    return strip * _X_BINS + x14


def strip_order_binned(x, y, pop: int):
    """Uniform-bin strip renumbering with one single-key sort: uniform y
    strips of expected population ``pop`` (exactly equal only for uniform
    node densities, as in refined meshes), x quantized to 14 bits within a
    strip (ties in index order). Returns (order, rank) as strip_order does.
    Raises ValueError for 2^17 strips or more."""
    order = torch.sort(_strip_keys(x, y, pop), stable=True).indices
    return order.to(torch.int32), _rank_of(order)
