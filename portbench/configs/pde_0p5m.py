"""Set-up and one job of ``pde_0p5m``: fdaPDE-core's advection-diffusion
problem through the program's ``PDE`` API on ``bench.py``'s ``general``
mesh (519,841 dofs), a new transport speed alpha a job.

Set-up makes the Delaunay mesh on the host (the API takes host arrays),
builds the program's problem once on a small mesh of the same kind (the
kernels and the native library are loaded there, and one job's calls
made), then times the real build (``build_s``: the median of three
builds): ``Triangulation``, the ``PDE`` constructor, and what the space
builds once per mesh on the first ``init()`` (the quadrature nodes, the
matrix pattern and the two device scatter tables of the assembly), so
that no job pays the mesh's one-off set-up. A job is
what a user's sweep over the transport speed does on a fixed mesh: set
the operator -Lap + (-alpha, 0) . grad, the forcing as values at the
quadrature nodes (``tests/test_fem_pde.py:72-73``) and zero Dirichlet
data, then ``init()`` and ``solve()``. Its iterations are the solve's
``solve_info``; it has converged only if ``success`` is set.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness import meshes
from portbench.harness.runner import job_seed, timed_builds

GAMMA = math.pi


def job_alpha(seed, job, spec):
    """The job's transport speed, uniform on [low, high] from its seed."""
    rng = np.random.default_rng(job_seed(seed, job))
    return float(spec["low"] + (spec["high"] - spec["low"]) * rng.random())


class Bench:
    def __init__(self, cfg, traffic, device, log):
        import fdapde_core_tpu_torch as fdt

        self.fdt, self.cfg, self.traffic = fdt, cfg, traffic
        sync = (lambda: torch.cuda.synchronize()) if torch.device(device).type == "cuda" else (lambda: None)
        m = cfg["mesh"]
        t0 = time.perf_counter()
        self.pts, self.cells, self.bnd, _ = meshes.delaunay_mesh(m["nx"], m["seed"], m["amp"])
        t_mesh = time.perf_counter() - t0

        def build(pts, cells, bnd):
            mesh = fdt.Triangulation(pts, cells, bnd)
            pde = fdt.PDE(mesh, -fdt.laplacian() + fdt.advection((-1.0, 0.0)),
                          order=cfg["order"], solver_rtol=cfg["solver_rtol"],
                          solver_maxiter=cfg["solver_maxiter"],
                          solver_preconditioner=cfg["solver_preconditioner"],
                          device=device, dtype=getattr(torch, cfg["dtype"]))
            # what the space builds once per mesh, on its first init: the
            # quadrature nodes, the matrix pattern and the device scatters
            space = pde.space
            space.quadrature_nodes
            space.scatter
            space.segment_sum("matrix", pde.device)
            space.segment_sum("forcing", pde.device)
            return pde

        # the kernels and the native library are loaded (and on a first run
        # built) by a build and a job on a small mesh of the same kind
        t0 = time.perf_counter()
        w = traffic["warmup"]
        small = build(*meshes.delaunay_mesh(w["nx"], m["seed"], m["amp"])[:3])
        self._job(small, 1.0)
        del small
        sync()
        t_small = time.perf_counter() - t0

        self.pde, self.build_s, builds = timed_builds(
            lambda: build(self.pts, self.cells, self.bnd), sync)
        log(f"{cfg['name']} {traffic['traffic']}: {self.pts.shape[0]} dofs, {self.cells.shape[0]} "
            f"cells; mesh {t_mesh:.4f} s, small build and job {t_small:.4f} s, builds {builds} s")

    def _job(self, pde, alpha):
        fdt = self.fdt
        pde.set_differential_operator(-fdt.laplacian() + fdt.advection((-alpha, 0.0)))
        q = pde.quadrature_nodes()
        pde.set_forcing(GAMMA * np.sin(math.pi * q[:, 1]))
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
        pde.init()
        pde.solve()
        return {"x": pde.solution(), "iterations": int(pde.solve_info.iterations),
                "converged": bool(pde.success)}

    def inputs(self, seed, job):
        return {"job": job, "alpha": job_alpha(seed, job, self.cfg["alpha"])}

    def run(self, inp):
        return self._job(self.pde, inp["alpha"])

    def keep(self, out):
        return {"x": out["x"]}

    def release(self):
        del self.pde

    def reference_data(self):
        return {"nodes": self.pts, "cells": self.cells, "boundary": self.bnd}
