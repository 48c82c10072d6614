"""The 1-vs-N dry run of every sharded path, and the gloo CPU launcher.

``dryrun_multichip(device_mesh)`` is the counterpart of JAX's
``__graft_entry__.dryrun_multichip``: the same twelve paths at the same
sizes, each solved on the given mesh and rebuilt on a world of one, the two
solutions held to agree. JAX holds every path to one flat 2e-5; here each
path's tolerance comes from its solve's rtol (``_agree``): N shards run the
iteration one shard runs, up to the order of the psum'd sums, so the
solutions agree to within the solver's own tolerance.

``spawn_gloo(specs, n_ranks, workdir)`` runs a list of solve specs on
``n_ranks`` gloo CPU ranks (spawned processes, a ``FileStore`` under
``workdir``), each spec on the world and, on rank 0, on a world of one;
``run_spec`` turns one spec (NumPy arrays and numbers: the operator, the
data, the solver's options) into the port's solver and its result. The
function each rank runs lives here, so a spawned rank imports this package
only.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch

from .comm import ShardMesh, close_world, init_world, make_device_mesh

__all__ = ["dryrun_multichip", "run_spec", "spawn_gloo"]


def _agree(name, xN, x1, rtol, n_shards):
    """Both solutions finite and max|xN - x1| <= rtol max(1, max|x1|)."""
    xN = xN.detach().double().cpu().reshape(-1)
    x1 = x1.detach().double().cpu().reshape(-1)
    if not bool(torch.isfinite(xN).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = float((xN - x1).abs().max())
    tol = rtol * max(1.0, float(x1.abs().max()))
    if d > tol:
        raise AssertionError(f"{name}: {n_shards}-shard vs 1-shard max|diff| = {d:.3e} > "
                             f"{tol:.3e} (rtol {rtol:g})")
    return d


def dryrun_multichip(device_mesh: ShardMesh | None = None) -> dict:
    """Run the twelve sharded paths of JAX's dry run on ``device_mesh`` and
    on a world of one; raise if a pair disagrees. Returns {path: (max|diff|,
    tolerance's rtol)} for the paths run (the banded two need the split
    plan to accept the 81-node mesh, as in JAX)."""
    import fdapde_core_tpu_torch as fdt
    from ..fem import FEMSpace
    from ..fem.assembler import assemble_matrix
    from ..fem.solvers import masked_matrix
    from ..geometry import irregular_mesh_device_soa, unit_square_mesh
    from ..linear_algebra.dia import dia_from_coo, unique_offsets
    from ..models.space_time import solve_space_time_fdm
    from ..ops.dia_split import build_banded_split, plan_split_width
    from ..ops.grid_dia import GridDIAMatrix
    from ..ops.matfree_soa import ELLSoA, MatrixFreeSoA
    from . import (HaloDIAParabolic, HaloDIASolver, HaloELLSolver, HaloGridDIASolver,
                   HaloLaneSolver, ShardedPoisson, ShardedSpaceTime)
    from .banded import ShardedBandedMGSolver
    from .mg import ShardedGridMG

    dm = device_mesh or make_device_mesh()
    m1 = make_device_mesh(1, device=dm.device)
    dev, n_dev = dm.device, dm.size
    done = {}

    def agree(name, xN, x1, rtol):
        done[name] = (_agree(name, xN, x1, rtol, n_dev), rtol)

    mesh = unit_square_mesh(8)  # 81 nodes, 128 cells
    sp = ShardedPoisson(mesh, order=1, device_mesh=dm)
    b = torch.ones(sp.n_dofs, dtype=sp.dtype, device=dev)
    g = torch.zeros(sp.n_dofs, dtype=sp.dtype, device=dev)
    x, _, _ = sp.solve(b, g, rtol=1e-8, maxiter=200)
    x_1dev, _, _ = ShardedPoisson(mesh, order=1, device_mesh=m1).solve(b, g, rtol=1e-8, maxiter=200)
    agree("sharded psum CG", x, x_1dev, 1e-8)
    x, _, _ = ShardedPoisson(mesh, order=1, device_mesh=dm, spmv="ell").solve(b, g, rtol=1e-8,
                                                                            maxiter=200)
    agree("sharded ELL CG", x, x_1dev, 1e-8)

    # halo-exchange DIA path
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdt.laplacian(), device=dev)
    rows, cols, _ = space.scatter
    D = dia_from_coo(rows, cols, A.vals, space.n_dofs, unique_offsets(space.dofs))
    free = torch.as_tensor(~space.boundary_dofs, device=dev).to(D.data.dtype)
    x, _, _ = HaloDIASolver(D, dm).solve(b * free, free, rtol=1e-8, maxiter=200)
    x1, _, _ = HaloDIASolver(D, m1).solve(b * free, free, rtol=1e-8, maxiter=200)
    agree("halo DIA CG", x, x1, 1e-8)

    # row-sharded 2D-grid stencil path
    G = GridDIAMatrix.from_dia(D, (9, 9))
    x, _, _ = HaloGridDIASolver(G, free, dm).solve(b * free, rtol=1e-8, maxiter=200)
    x1, _, _ = HaloGridDIASolver(G, free, m1).solve(b * free, rtol=1e-8, maxiter=200)
    agree("grid-halo CG", x, x1, 1e-8)

    # distributed multigrid (row-sharded V-cycle + replicated coarse tail)
    Gm = G.with_dirichlet_identity(free)
    x, _, _ = ShardedGridMG(Gm, dm, repl_rows=4, coarse_n=2).solve(b * free, rtol=1e-8, maxiter=30)
    x1, _, _ = ShardedGridMG(Gm, m1, repl_rows=4, coarse_n=2).solve(b * free, rtol=1e-8,
                                                                    maxiter=30)
    agree("sharded grid MG", x, x1, 1e-8)

    # distributed implicit Euler over DIA operators
    M = assemble_matrix(space, fdt.reaction(1.0), device=dev)
    Md = dia_from_coo(rows, cols, M.vals, space.n_dofs, unique_offsets(space.dofs))
    Fz = torch.zeros((space.n_dofs, 4), dtype=torch.float64, device=dev)
    us = HaloDIAParabolic(D, Md, 0.05, dm).solve(Fz, Fz, b * free, free, rtol=1e-8)
    us1 = HaloDIAParabolic(D, Md, 0.05, m1).solve(Fz, Fz, b * free, free, rtol=1e-8)
    agree("parabolic halo steps", us, us1, 1e-8)

    # the general gather path: halo CG over an assembled ELL
    xg, yg, c0, c1, c2, bndg = irregular_mesh_device_soa(8, 0.2, dtype=torch.float64, device=dev)
    soa, _ = MatrixFreeSoA.build(xg, yg, c0, c1, c2, 81, 8)
    E_g, _ = soa.to_ell(9)
    free_g = (~bndg).to(torch.float64)
    bg = torch.where(bndg, 0.0, 1.0).to(torch.float64)
    x, _, _ = HaloELLSolver(E_g, dm).solve(bg, free_g, rtol=1e-8, maxiter=400)
    x1, _, _ = HaloELLSolver(E_g, m1).solve(bg, free_g, rtol=1e-8, maxiter=400)
    agree("halo ELL CG", x, x1, 1e-8)

    # the banded split of the same operator: a (R, W) grid stencil
    Wb, amaxb = plan_split_width(E_g)
    if Wb is not None:
        Sb, _ = build_banded_split(E_g, Wb, amax=amaxb)
        Rb, Wd = Sb.G.shape2d
        free_pad = torch.nn.functional.pad(free_g, (0, Rb * Wd - 81))
        bb = torch.nn.functional.pad(bg, (0, Rb * Wd - 81))
        x, _, _ = HaloGridDIASolver(Sb.G, free_pad, dm).solve(bb, rtol=1e-8, maxiter=400)
        x1, _, _ = HaloGridDIASolver(Sb.G, free_pad, m1).solve(bb, rtol=1e-8, maxiter=400)
        agree("sharded banded-split CG", x, x1, 1e-8)
        Fb = Sb.fold_dirichlet(bndg)
        if int((Fb.rem.vals != 0.0).sum()) == 0:
            Fb = Fb.drop_empty_remainder()
            x, _, k = ShardedBandedMGSolver(Fb, dm, repl_rows=16, coarse_n=4).solve(
                bg, rtol=1e-8, maxiter=40)
            if k > 30:
                raise AssertionError("sharded BandedMG lost h-independence")
            x1, _, _ = ShardedBandedMGSolver(Fb, m1, repl_rows=16, coarse_n=4).solve(
                bg, rtol=1e-8, maxiter=40)
            agree("sharded BandedMG CG", x, x1, 1e-8)

    # the scattered path on a block-scrambled numbering
    nh = 24
    nd_h = (nh + 1) ** 2
    xh, yh, c0h, c1h, c2h, bndh = irregular_mesh_device_soa(nh, 0.2, dtype=torch.float64,
                                                            device=dev)
    soa_h, _ = MatrixFreeSoA.build(xh, yh, c0h, c1h, c2h, nd_h, 8)
    E_h, _ = soa_h.to_ell(9)
    S_, G_ = 32, 13
    GI_ = pow(G_, -1, S_)
    i_ = torch.arange(nd_h, device=dev)
    nfull = (nd_h // S_) * S_
    pm = torch.where(i_ < nfull, (i_ // S_) * S_ + (G_ * (i_ % S_)) % S_, i_)
    pinv = torch.where(i_ < nfull, (i_ // S_) * S_ + (GI_ * (i_ % S_)) % S_, i_)
    E_sc = ELLSoA(E_h.vals[:, pinv], pm[E_h.cols[:, pinv].long()].to(torch.int32), (nd_h, nd_h))
    bnd_sc = bndh[pinv]
    try:
        lane = HaloLaneSolver(E_sc, dm, rounds=10)
    except ValueError:  # many shards: the scrambled band exceeds the block
        E_sc, bnd_sc = E_h, bndh
        lane = HaloLaneSolver(E_sc, dm, rounds=10)
    free_sc = (~bnd_sc).to(torch.float64)
    b_sc = torch.where(bnd_sc, 0.0, 1.0).to(torch.float64)
    x, _, _ = lane.solve(b_sc, free_sc, rtol=1e-8, maxiter=800)
    x1, _, _ = HaloLaneSolver(E_sc, m1, rounds=10).solve(b_sc, free_sc, rtol=1e-8, maxiter=800)
    agree("halo lane CG", x, x1, 1e-8)

    # time-sharded space-time Kronecker CG
    n_t = 2 * n_dev + 3  # not divisible by n_dev: exercises padding
    T_stiff = np.diag(2.0 * np.ones(n_t)) - np.diag(np.ones(n_t - 1), 1) - np.diag(
        np.ones(n_t - 1), -1)
    T_mass = (np.diag(4.0 * np.ones(n_t)) + np.diag(np.ones(n_t - 1), 1)
              + np.diag(np.ones(n_t - 1), -1)) / 6.0
    bst = torch.ones(n_t * space.n_dofs, dtype=torch.float64, device=dev)
    terms = [(T_mass, A), (T_stiff, M)]
    x, _, _ = ShardedSpaceTime(terms, dm).solve(bst, rtol=1e-8, maxiter=800)
    x1, _, _ = ShardedSpaceTime(terms, m1).solve(bst, rtol=1e-8, maxiter=800)
    agree("time-sharded Kronecker CG", x, x1, 1e-8)

    # mode-parallel fast diagonalization
    S1m = masked_matrix(A, torch.as_tensor(space.boundary_dofs, device=dev))
    x, _ = solve_space_time_fdm(T_mass, T_stiff, M, S1m, bst, rtol=1e-8, device_mesh=dm)
    x1, _ = solve_space_time_fdm(T_mass, T_stiff, M, S1m, bst, rtol=1e-8, device_mesh=m1)
    agree("FDM mode-parallel", x, x1, 1e-8)
    return done


# -- solve specs: the same system handed to both packages as NumPy ----------

def _sparse(spec, dev):
    from ..interop import sparse_from_numpy

    rows, cols, vals, shape = spec
    return sparse_from_numpy(rows, cols, vals, shape, device=dev)


def run_spec(device_mesh: ShardMesh, spec: dict) -> dict:
    """Build spec["kind"]'s solver from the spec's arrays on
    ``device_mesh``, solve, and return its outputs as NumPy:
    x, iterations ``k`` and the residual ``res`` (per kind below)."""
    import fdapde_core_tpu_torch as fdt
    from ..geometry import Triangulation
    from ..interop import dia_from_numpy, ell_from_numpy, grid_dia_from_numpy
    from ..ops.auxgrid import AuxGridPreconditioner
    from ..ops.dia_split import BandedSplit
    from . import (HaloDIAParabolic, HaloDIASolver, HaloELLSolver, HaloGridDIASolver,
                   HaloLaneSolver, ShardedPoisson, ShardedSpaceTime)
    from .banded import ShardedBandedMGSolver
    from .mg import ShardedGridMG

    dev, kind, s = device_mesh.device, spec["kind"], spec
    out = {}
    if kind in ("sharded_poisson", "elliptic_sharded"):
        mesh = Triangulation(s["nodes"], s["cells"], s["boundary"])
        op = -fdt.laplacian()
        if s.get("reaction") is not None:
            op = op + fdt.reaction(s["reaction"])
        if kind == "elliptic_sharded":
            f = s["forcing"]  # a constant, or values at the quadrature nodes
            x, info = fdt.models.solve_elliptic_sharded(
                mesh, op, (lambda p: f) if np.isscalar(f) else f, s["g"],
                device_mesh=device_mesh, rtol=s["rtol"])
            k, res, out["strategy"] = info["iterations"], info["residual"], info["strategy"]
        else:
            sp = ShardedPoisson(mesh, s.get("order", 1), device_mesh, operator=op,
                                spmv=s.get("spmv", "segment"),
                                preconditioner=s.get("preconditioner", "jacobi"))
            x, res, k = sp.solve(s["b"], s["g"], rtol=s["rtol"], maxiter=s["maxiter"])
            if s.get("assemble"):
                out["A_loc"], out["dofs"] = sp.assemble().cpu().numpy(), sp._dofs
    elif kind == "halo_dia":
        D = dia_from_numpy(s["data"], s["offsets"], device=dev)
        x, res, k = HaloDIASolver(D, device_mesh).solve(s["b"], s["free"], rtol=s["rtol"],
                                                        maxiter=s.get("maxiter", 1000))
    elif kind == "halo_dia_parabolic":
        Ad = dia_from_numpy(s["A"], s["offsets"], device=dev)
        Md = dia_from_numpy(s["M"], s["offsets"], device=dev)
        solver = HaloDIAParabolic(Ad, Md, s["dt"], device_mesh)
        x = solver.solve(s["F"], s["G"], s["u0"], s["free"], rtol=s["rtol"])
        k, res = solver.step_iterations, 0.0
    elif kind == "halo_grid":
        G = grid_dia_from_numpy(s["data"], s["offsets2d"], s["shape2d"], device=dev)
        x, res, k = HaloGridDIASolver(G, torch.as_tensor(s["free"], device=dev), device_mesh
                                      ).solve(s["b"], rtol=s["rtol"], maxiter=s["maxiter"])
    elif kind in ("grid_mg", "banded_mg"):
        G = grid_dia_from_numpy(s["data"], s["offsets2d"], s["shape2d"], device=dev)
        kw = dict(repl_rows=s["repl_rows"], coarse_n=s["coarse_n"])
        solver = (ShardedGridMG(G, device_mesh, **kw) if kind == "grid_mg" else
                  ShardedBandedMGSolver(BandedSplit(G, None, s["n"]), device_mesh, **kw))
        x, res, k = solver.solve(s["b"], rtol=s["rtol"], maxiter=s["maxiter"])
        if kind == "grid_mg":
            out["T"] = solver.T
    elif kind in ("halo_ell", "halo_lane"):
        n = s["vals"].shape[1]
        E = ell_from_numpy(s["vals"], s["cols"], (n, n), device=dev)
        if kind == "halo_ell":
            solver = HaloELLSolver(E, device_mesh)
        else:
            aux = None
            if s.get("aux") is not None:
                coords, diag, grid_n = s["aux"]
                aux = AuxGridPreconditioner.build(coords, torch.as_tensor(diag, device=dev),
                                                  grid_n=grid_n, dtype=torch.float64, device=dev)
            solver = HaloLaneSolver(E, device_mesh, aux=aux)
        x, res, k = solver.solve(s["b"], s["free"], rtol=s["rtol"], maxiter=s["maxiter"])
    elif kind == "space_time":
        terms = [(T, _sparse(S, dev)) for T, S in s["terms"]]
        x, res, k = ShardedSpaceTime(terms, device_mesh).solve(s["b"], rtol=s["rtol"],
                                                               maxiter=s["maxiter"])
    elif kind == "fdm":
        from ..models.space_time import solve_space_time_fdm

        x, info = solve_space_time_fdm(s["T0"], s["T1"], _sparse(s["S0"], dev),
                                       _sparse(s["S1"], dev), s["b"], rtol=s["rtol"],
                                       device_mesh=device_mesh)
        k, res = info.iterations, 0.0
    else:
        raise ValueError(f"unknown spec kind {kind!r}")
    out.update(x=x.detach().cpu().numpy(), k=np.asarray(k), res=np.asarray(float(res)))
    return out


def _worker(rank: int, world: int, workdir: str):
    """One gloo CPU rank: every spec on the world, and on rank 0 also on a
    world of one; rank 0 writes ``result.npz``."""
    torch.set_num_threads(1)
    work = Path(workdir)
    mesh = init_world("cpu", rank, world, store_file=str(work / "store"))
    try:
        with open(work / "specs.pkl", "rb") as f:
            job = pickle.load(f)
        out = {}
        for i, spec in enumerate(job["specs"]):
            for tag, m in (("N", mesh), ("1", make_device_mesh(1))):
                if tag == "1" and rank != 0:
                    continue
                for key, val in run_spec(m, spec).items():
                    out[f"{i}/{tag}/{key}"] = val
        if job.get("dryrun"):
            for name, (d, rtol) in dryrun_multichip(mesh).items():
                out[f"dryrun/{name}"] = np.asarray([d, rtol])
        if rank == 0:
            np.savez(work / "result.npz", **out)
    finally:
        close_world()


def spawn_gloo(specs, n_ranks: int, workdir, dryrun: bool = False):
    """Run ``specs`` (dicts for ``run_spec``) on ``n_ranks`` spawned gloo
    CPU ranks. Returns ([{"N": outputs, "1": outputs} per spec], {path:
    (max|diff|, rtol)} of the dry run, empty unless ``dryrun``)."""
    import torch.multiprocessing as mp

    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    for stale in ("store", "result.npz"):
        if (work / stale).exists():
            os.remove(work / stale)
    with open(work / "specs.pkl", "wb") as f:
        pickle.dump({"specs": list(specs), "dryrun": dryrun}, f)
    mp.start_processes(_worker, args=(n_ranks, str(work)), nprocs=n_ranks, join=True,
                       start_method="spawn")
    results = [{"N": {}, "1": {}} for _ in specs]
    dry = {}
    with np.load(work / "result.npz", allow_pickle=False) as data:
        for key in data.files:
            if key.startswith("dryrun/"):
                dry[key[len("dryrun/"):]] = tuple(data[key].tolist())
                continue
            i, tag, name = key.split("/", 2)
            results[int(i)][tag][name] = data[key]
    return results, dry
