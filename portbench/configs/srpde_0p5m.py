"""Set-up and one job of ``srpde_0p5m``: spatial regression with a -Laplacian
penalty (SR-PDE) on ``bench.py``'s ``general`` mesh (519,841 dofs), with
the data at 2,000,000 fixed uniform locations, of which those inside the
unit square are used.

Set-up makes the Delaunay mesh and the locations on the host (the API
takes host arrays), builds the program's model once on a small mesh of the
same kind (the kernels and the native library are loaded there, and one
job's call made), then times the real build, ``Triangulation`` and
``SmoothingRegression`` together (``build_s``: the median of three
builds). A job draws new
noise on the device and calls ``gcv`` or ``fit``, as the traffic says.
The Krylov iterations of a job are summed by a wrapper around the model's
CG, from the ``SolveInfo`` each call returns.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from portbench.harness import instruments, meshes
from portbench.harness.runner import job_seed, timed_builds


def locations(spec):
    """The data locations: uniform on [low, high]^2 from the fixed seed,
    those inside [0, 1]^2 (the mesh's domain), host float64 (k, 2)."""
    rng = np.random.default_rng(spec["seed"])
    pts = rng.uniform(spec["low"], spec["high"], size=(spec["n"], 2))
    inside = np.all((pts >= 0.0) & (pts <= 1.0), axis=1)
    return pts[inside]


def truth(locs_dev):
    return torch.sin(2 * math.pi * locs_dev[:, 0]) * torch.cos(2 * math.pi * locs_dev[:, 1])


def job_inputs(seed, job, f_true, sigma):
    """The job's observations y = truth + sigma eps, eps drawn on the device
    from the job's seed, and the seed of its probes."""
    s = job_seed(seed, job)
    gen = torch.Generator(device=f_true.device).manual_seed(s)
    eps = torch.randn(f_true.shape, generator=gen, dtype=f_true.dtype, device=f_true.device)
    return {"job": job, "y": f_true + sigma * eps, "probe_seed": s}


class Bench:
    def __init__(self, cfg, traffic, device, log):
        import fdapde_core_tpu_torch as fdt
        from fdapde_core_tpu_torch.models import SmoothingRegression
        from fdapde_core_tpu_torch.models import regression

        self.cfg, self.traffic = cfg, traffic
        sync = (lambda: torch.cuda.synchronize()) if torch.device(device).type == "cuda" else (lambda: None)
        m = cfg["mesh"]
        t0 = time.perf_counter()
        self.pts, self.cells, self.bnd, self.tri = meshes.delaunay_mesh(m["nx"], m["seed"], m["amp"])
        self.locs = locations(cfg["locations"])
        self.f_true = truth(torch.as_tensor(self.locs, device=device))
        t_mesh = time.perf_counter() - t0

        # every Krylov solve of a job: (iterations, converged)
        self.solves = []
        orig_cg = regression.cg

        @functools.wraps(orig_cg)
        def counted_cg(*args, **kwargs):
            x, info = orig_cg(*args, **kwargs)
            self.solves.append((int(info.iterations), bool(info.converged)))
            return x, info

        self._undo = instruments.replace_everywhere(orig_cg, counted_cg)

        def build(pts, cells, bnd):
            mesh = fdt.Triangulation(pts, cells, bnd)
            return mesh, SmoothingRegression(mesh, -fdt.laplacian(), device=device)

        # the kernels and the native library are loaded (and on a first run
        # built) by a build and a job on a small mesh of the same kind
        t0 = time.perf_counter()
        w = traffic["warmup"]
        wp, wc, wb, _ = meshes.delaunay_mesh(w["nx"], m["seed"], m["amp"])
        _, small = build(wp, wc, wb)
        wl = locations(dict(cfg["locations"], n=w["n_locations"]))
        winp = job_inputs(0, -1, truth(torch.as_tensor(wl, device=device)), cfg["sigma"])
        self._call(small, wl, winp)
        del small, winp
        sync()
        t_small = time.perf_counter() - t0

        (self.mesh, self.model), self.build_s, builds = timed_builds(
            lambda: build(self.pts, self.cells, self.bnd), sync)
        log(f"{cfg['name']} {traffic['traffic']}: {self.pts.shape[0]} dofs, {self.cells.shape[0]} "
            f"cells, {self.locs.shape[0]} locations; mesh and locations {t_mesh:.4f} s, small "
            f"build and job {t_small:.4f} s, builds {builds} s")

    def _call(self, model, locs, inp):
        c = self.cfg
        if self.traffic["job"] == "gcv":
            score = model.gcv(locs, inp["y"], c["lam"], n_probes=c["n_probes"],
                              seed=inp["probe_seed"], rtol=c["rtol"], maxiter=c["maxiter"])
            return score, model.coefficients_
        return None, model.fit(locs, inp["y"], c["lam"], rtol=c["rtol"], maxiter=c["maxiter"])

    def inputs(self, seed, job):
        return job_inputs(seed, job, self.f_true, self.cfg["sigma"])

    def run(self, inp):
        self.solves.clear()
        score, c = self._call(self.model, self.locs, inp)
        return {"score": score, "c": c, "iterations": sum(s[0] for s in self.solves),
                "converged": all(s[1] for s in self.solves) and bool(self.solves)}

    def keep(self, out):
        return {"score": out["score"], "c": out["c"]}

    def release(self):
        self._undo()
        del self.model, self.mesh

    def reference_data(self):
        return {"nodes": self.pts, "cells": self.cells, "delaunay": self.tri, "locs": self.locs}
