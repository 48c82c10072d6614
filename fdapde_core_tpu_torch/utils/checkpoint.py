"""Checkpointing of preprocessed mesh/discretization artifacts.

Port of ``fdapde_core_tpu/utils/checkpoint.py``. fdaPDE-core rebuilds all
state per run; at millions of dofs the host-side preprocessing (topology
extraction, dof tables, scatter maps, the SA-AMG set-up) is expensive
enough to persist. The files are the JAX package's ``.npz`` layout, key
for key, so a checkpoint written by either package loads in the other:
tensors are saved from the host (``.cpu().numpy()``, as JAX saves
``np.asarray`` of its device arrays), and ``load_amg`` puts the hierarchy
on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linear_algebra.sparse import _host

__all__ = ["save_space", "load_space", "save_arrays", "load_arrays", "save_amg", "load_amg"]


def save_arrays(path: str, **arrays) -> None:
    """Arrays or tensors (saved from the host) into one compressed .npz."""
    np.savez_compressed(path, **{k: _host(v) for k, v in arrays.items()})


def load_arrays(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def save_space(path: str, space) -> None:
    """Persist a FEMSpace (mesh + dof tables + scatter structure)."""
    rows, cols, inv = space.scatter
    save_arrays(
        path,
        nodes=space.mesh.nodes,
        cells=space.mesh.cells,
        boundary=space.mesh.boundary_node_markers(),
        order=np.asarray(space.order),
        dofs=space.dofs,
        boundary_dofs=space.boundary_dofs,
        scatter_rows=rows,
        scatter_cols=cols,
        scatter_inv=inv,
    )


def load_space(path: str):
    """Rebuild a FEMSpace from a checkpoint, reusing the stored scatter maps
    (the device ``segment_sum`` tables are built from them at first use)."""
    from ..fem.space import FEMSpace
    from ..geometry.triangulation import Triangulation

    data = load_arrays(path)
    mesh = Triangulation(data["nodes"], data["cells"], data["boundary"])
    space = FEMSpace(mesh, int(data["order"]))
    # seed the cached property with the persisted artifacts
    space.__dict__["scatter"] = (data["scatter_rows"], data["scatter_cols"], data["scatter_inv"])
    if not np.array_equal(space.dofs, data["dofs"]):
        raise ValueError(f"checkpoint {path} does not match the rebuilt dof table")
    return space


def save_amg(path: str, mg) -> None:
    """Persist an SA-AMG hierarchy (linear_algebra/amg.py): every level's
    sorted-COO A, P and R = P^T with their values in stored order, the
    inverse diagonals, the coarsest inverse and the smoother's scalars."""
    arrays = {
        "meta": np.asarray([mg.omega, float(mg.nu), mg.cheby_lower,
                            1.0 if mg.smoother == "chebyshev" else 0.0]),
        "rhos": np.asarray(mg.rhos),
        "coarse_inv": mg.coarse_inv,
        "n_levels": np.asarray(len(mg.As)),
    }
    for i, (A, P, R, d) in enumerate(zip(mg.As, mg.Ps, mg.Rs, mg.dinvs)):
        for name, M in (("A", A), ("P", P), ("R", R)):
            arrays[f"{name}{i}_rows"] = M.rows
            arrays[f"{name}{i}_cols"] = M.cols
            arrays[f"{name}{i}_vals"] = M.vals
            arrays[f"{name}{i}_shape"] = np.asarray(M.shape)
        arrays[f"dinv{i}"] = d
    save_arrays(path, **arrays)


def load_amg(path: str, device="cuda"):
    """Rebuild an AMG hierarchy saved by either package's save_amg on
    ``device``, each array in its stored order and dtype. K2's sliced
    layouts are built at each level's first product, as after
    ``AMG.build``."""
    from ..linear_algebra.amg import AMG
    from ..linear_algebra.sparse import SparseMatrix

    data = load_arrays(path)
    n_levels = int(data["n_levels"])

    def dev(a):
        return torch.as_tensor(a, device=device)

    def sp(name, i):
        return SparseMatrix(dev(data[f"{name}{i}_rows"]), dev(data[f"{name}{i}_cols"]),
                            dev(data[f"{name}{i}_vals"]),
                            tuple(int(v) for v in data[f"{name}{i}_shape"]))

    As = [sp("A", i) for i in range(n_levels)]
    Ps = [sp("P", i) for i in range(n_levels)]
    Rs = [sp("R", i) for i in range(n_levels)]
    dinvs = [dev(data[f"dinv{i}"]) for i in range(n_levels)]
    omega, nu, cheby_lower, is_cheby = data["meta"]
    return AMG(As, Ps, Rs, dinvs, dev(data["coarse_inv"]), float(omega), int(nu),
               [float(r) for r in data["rhos"]], "chebyshev" if is_cheby == 1.0 else "jacobi",
               float(cheby_lower))
