"""Set-up and one job of ``heat_0p5m``: fdaPDE-core's heat equation through
the program's ``PDE`` API on ``bench.py``'s ``general`` mesh (519,841
dofs), 100 implicit-Euler steps a job, a new diffusivity mu a job.

Set-up makes the Delaunay mesh on the host (the API takes host arrays) and
the (quadrature nodes, instants) array of sin(2 pi x) sin(2 pi y) e^-t
that every job's forcing scales, builds the program's problem once on a
small mesh of the same kind and runs one job there (the kernels and the
native library are loaded, one job's calls made), then times the real
build (``build_s``: the median of three builds): ``Triangulation``, the
``PDE`` constructor, and what the space builds once per mesh on the first
``init()`` (the quadrature nodes, the matrix pattern and the two device
scatter tables of the assembly). After the small job, and after every
job of a window, the job raises unless ``PDE.report()`` names the
auxiliary grid for the parabolic solve and no fall-back from it: a
program whose parabolic solve drops the configuration's preconditioner
("auto" at this size) runs another configuration, so the set-up fails
and a window's job counts as failed.

A job is what a user's calibration of the diffusivity does on a fixed mesh
and time grid: set the operator dt() - mu Lap, the forcing as values at the
quadrature nodes and instants, zero Dirichlet data and the initial
condition, then ``init()`` and ``solve()``. Its iterations are the steps'
(``step_info``), summed; it has converged only if every step did.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness import meshes
from portbench.harness.runner import job_seed, timed_builds


def job_mu(seed, job, spec):
    """The job's diffusivity, uniform on [low, high] from its seed."""
    rng = np.random.default_rng(job_seed(seed, job))
    return float(spec["low"] + (spec["high"] - spec["low"]) * rng.random())


def time_grid(cfg):
    t = cfg["times"]
    return np.linspace(t["start"], t["stop"], t["count"])


def mode(x, y):
    return np.sin(2 * math.pi * x) * np.sin(2 * math.pi * y)


class Problem:
    """The forcing's shape on one mesh: sin(2 pi x) sin(2 pi y) e^-t at the
    quadrature nodes and instants, and the initial condition at the dofs.
    A job's forcing, a multiple of the shape, is written into one host
    buffer of the same size, as a user's loop over mu would reuse it: the
    job pays for the multiplication, not for 2.5 GB of fresh pages."""

    def __init__(self, pde, times):
        q, c = pde.quadrature_nodes(), pde.dof_coords()
        self.shape = mode(q[:, 0], q[:, 1])[:, None] * np.exp(-times)[None, :]
        self.buffer = np.empty_like(self.shape)
        self.u0 = mode(c[:, 0], c[:, 1])

    def forcing(self, mu):
        """(8 pi^2 mu - 1) times the shape, in the buffer."""
        return np.multiply(self.shape, 8 * math.pi ** 2 * mu - 1, out=self.buffer)


class Bench:
    def __init__(self, cfg, traffic, device, log):
        import fdapde_core_tpu_torch as fdt

        self.fdt, self.cfg, self.traffic = fdt, cfg, traffic
        self.times = time_grid(cfg)
        sync = (lambda: torch.cuda.synchronize()) if torch.device(device).type == "cuda" else (lambda: None)
        m = cfg["mesh"]
        t0 = time.perf_counter()
        self.pts, self.cells, self.bnd, _ = meshes.delaunay_mesh(m["nx"], m["seed"], m["amp"])
        t_mesh = time.perf_counter() - t0

        def build(pts, cells, bnd):
            mesh = fdt.Triangulation(pts, cells, bnd)
            pde = fdt.PDE(mesh, fdt.dt() - fdt.laplacian(), times=self.times,
                          order=cfg["order"], solver_rtol=cfg["solver_rtol"],
                          solver_maxiter=cfg["solver_maxiter"],
                          solver_preconditioner=cfg["solver_preconditioner"],
                          lumped_mass=cfg["lumped_mass"],
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
        self._job(small, Problem(small, self.times), 1.0)
        rung = small.report().get("preconditioner")
        del small
        sync()
        t_small = time.perf_counter() - t0

        self.pde, self.build_s, builds = timed_builds(
            lambda: build(self.pts, self.cells, self.bnd), sync)
        t0 = time.perf_counter()
        self.problem = Problem(self.pde, self.times)
        t_shape = time.perf_counter() - t0
        log(f"{cfg['name']} {traffic['traffic']}: {self.pts.shape[0]} dofs, {self.cells.shape[0]} "
            f"cells, {self.times.size} instants; mesh {t_mesh:.4f} s, small build and job "
            f"{t_small:.4f} s (rung {rung}), builds {builds} s, forcing shape "
            f"{self.problem.shape.shape} {t_shape:.4f} s")

    def _job(self, pde, problem, mu):
        fdt = self.fdt
        pde.set_differential_operator(fdt.dt() - mu * fdt.laplacian())
        pde.set_forcing(problem.forcing(mu))
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
        pde.set_initial_condition(problem.u0)
        pde.init()
        pde.solve()
        rep = pde.report()
        if rep.get("preconditioner") != "auxgrid" or rep.get("ladder_fallback", False):
            raise RuntimeError(
                f"the parabolic solve on {pde.n_dofs} dofs took the preconditioner "
                f"{rep.get('preconditioner')!r} (fall-back {rep.get('ladder_fallback')!r}), "
                "not the auxiliary grid that 'auto' selects at 20,000 dofs or more")
        return {"x": pde.solution(), "iterations": int(pde.step_info["iterations"].sum()),
                "converged": bool(pde.success)}

    def inputs(self, seed, job):
        return {"job": job, "mu": job_mu(seed, job, self.cfg["mu"])}

    def run(self, inp):
        return self._job(self.pde, self.problem, inp["mu"])

    def keep(self, out):
        return {"x": out["x"]}

    def release(self):
        del self.pde

    def reference_data(self):
        return {"nodes": self.pts, "cells": self.cells, "boundary": self.bnd, "times": self.times}
