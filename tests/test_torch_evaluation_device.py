"""The pointwise Psi build on the device (``fem.evaluation.eval_basis_pointwise``)
against the JAX package's host build: the same rows and columns, values
within 1e-14, on every mesh kind (2D P1 and P2, also with cells that do not
list their dofs in order, 3D, a 2.5D surface, a 1.5D network, the 1D
interval), for points inside, outside, on vertices shared
by several cells and on edges, with the host and the device locator, with
the build's chunks of ``point_location._BATCH`` points made small, with no
point inside and with a single point.

CPU only, at small sizes.
"""

import numpy as np
import pytest
import torch

import fdapde_core_tpu as fdm
import fdapde_core_tpu_torch as fdt
from fdapde_core_tpu.fem.evaluation import eval_basis_pointwise as j_pointwise
from fdapde_core_tpu.geometry import structured as jstruct
from fdapde_core_tpu_torch.fem.evaluation import eval_basis_pointwise
from fdapde_core_tpu_torch.geometry import point_location, structured as tstruct

CPU = "cpu"


def _network(pkg):
    """A 3 x 3 lattice of nodes joined by its 12 horizontal and vertical
    segments."""
    g = np.linspace(0.0, 1.0, 3)
    nodes = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    idx = np.arange(9).reshape(3, 3)
    cells = np.concatenate([np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1),
                            np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)]).astype(np.int32)
    return pkg.LinearNetwork(nodes, cells)


def _shuffled(pkg, st):
    """unit_square_mesh(6) with its nodes renumbered at random and each
    cell's vertices rotated, so no cell lists its dofs in column order."""
    sq = st.unit_square_mesh(6)
    perm = np.random.default_rng(3).permutation(sq.n_nodes)
    new_id = np.argsort(perm)
    cells = np.roll(new_id[sq.cells], 1, axis=1).astype(np.int32)
    return pkg.Triangulation(sq.nodes[perm], cells, sq.boundary_nodes[perm])


MESHES = {
    "square": lambda pkg, st: st.unit_square_mesh(6),
    "shuffled": _shuffled,
    "cube": lambda pkg, st: st.unit_cube_mesh(3),
    "surface": lambda pkg, st: st.unit_cube_mesh(3).surface(),
    "network": lambda pkg, st: _network(pkg),
    "interval": lambda pkg, st: pkg.Interval(0.0, 1.0, 8),
}
CASES = [("square", 1), ("square", 2), ("shuffled", 1), ("shuffled", 2), ("cube", 1), ("surface", 1), ("network", 1),
         ("interval", 1)]


def _pair(kind):
    return (MESHES[kind](fdm.geometry, jstruct), MESHES[kind](fdt.geometry, tstruct))


def _points(mesh, rng):
    """Points in the cells, on their vertices and edge midpoints, and in a
    box around the mesh (most of them outside a manifold)."""
    coords = mesh.nodes[mesh.cells]  # (C, M+1, N)
    w = rng.dirichlet(np.ones(coords.shape[1]), size=coords.shape[0])
    inner = np.einsum("cv,cvn->cn", w, coords)
    edges = 0.5 * (coords[:, 0] + coords[:, -1])
    lo, hi = mesh.nodes.min(0) - 0.1, mesh.nodes.max(0) + 0.1
    box = rng.uniform(lo, hi, size=(60, mesh.nodes.shape[1]))
    pts = np.concatenate([inner, mesh.nodes, edges, box])
    return pts[rng.permutation(pts.shape[0])]


def _assert_equal(Pt, Pj):
    assert Pt.shape == tuple(Pj.shape)
    assert Pt.rows.dtype == Pt.cols.dtype == torch.int32 and Pt.rows.device.type == CPU
    assert np.array_equal(Pt.rows.numpy(), np.asarray(Pj.rows))
    assert np.array_equal(Pt.cols.numpy(), np.asarray(Pj.cols))
    assert Pt.vals.shape[0] == Pt.rows.shape[0]
    assert np.abs(Pt.toarray() - np.asarray(Pj.toarray())).max(initial=0.0) <= 1e-14


def _build(mj, mt, order, locs, device_locate):
    Pj, Dj = j_pointwise(fdm.fem.FEMSpace(mj, order), locs, device_locate=device_locate)
    Pt, Dt = eval_basis_pointwise(fdt.FEMSpace(mt, order), locs, device_locate=device_locate,
                                  device=CPU)
    assert np.array_equal(Dt, np.asarray(Dj))
    _assert_equal(Pt, Pj)
    return Pt


@pytest.mark.parametrize("batch", [None, 7], ids=["one-chunk", "chunks-of-7"])
@pytest.mark.parametrize("device_locate", [False, True], ids=["host-locate", "device-locate"])
@pytest.mark.parametrize("kind, order", CASES, ids=[f"{k}-P{o}" for k, o in CASES])
def test_pointwise_matches_jax(kind, order, device_locate, batch, monkeypatch):
    if batch is not None:
        monkeypatch.setattr(point_location, "_BATCH", batch)
    mj, mt = _pair(kind)
    locs = _points(mt, np.random.default_rng(len(kind) + order))
    Pt = _build(mj, mt, order, locs, device_locate)
    located = np.unique(Pt.rows.numpy())
    assert 0 < located.size < locs.shape[0]  # points inside and outside
    if batch is not None:
        assert located.size > 3 * batch  # several chunks


@pytest.mark.parametrize("device_locate", [False, True], ids=["host-locate", "device-locate"])
@pytest.mark.parametrize("where", ["all-outside", "single-point", "single-outside"])
def test_pointwise_edge_sizes(where, device_locate):
    """No point inside (an empty Psi of the points' rows) and one point."""
    mj, mt = _pair("square")
    locs = {"all-outside": np.array([[1.5, 0.5], [-0.2, 0.3], [0.4, 2.0]]),
            "single-point": np.array([0.37, 0.61]),
            "single-outside": np.array([[1.2, 1.2]])}[where]
    Pt = _build(mj, mt, 2, locs, device_locate)
    assert Pt.shape[0] == np.atleast_2d(locs).shape[0]
    assert Pt.nnz == (6 if where == "single-point" else 0)
