"""Set-up and one job of ``p1_poisson_10m``: 2D P1 Poisson with Dirichlet
data on the jittered n = 3200 criss-cross lattice (10,246,401 dofs), in
the numbering the cell's traffic names.

Set-up makes the mesh on the device (``harness/meshes.py``), builds the
program's solver once on a small mesh of the same kind and numbering (the
kernels are loaded and compiled there), then times the real constructor
(``build_s``: the median of three calls). A job draws a smooth
forcing and Dirichlet data from its seed, turns the forcing into a load
vector through the program's own load entry, and solves to the configured
tolerance.
"""

from __future__ import annotations

import math
import time

import torch

from portbench.harness import meshes
from portbench.harness.runner import job_seed, timed_builds


def make_mesh(n, amp, numbering, device):
    nodes, cells, bnd = meshes.criss_cross_mesh(n, amp, torch.float64, device)
    if numbering["kind"] == "block scramble":
        nodes, cells, bnd = meshes.scrambled(nodes, cells, bnd, numbering["S"], numbering["G"])
    elif numbering["kind"] != "lattice":
        raise ValueError(f"unknown numbering {numbering['kind']!r}")
    return nodes, cells, bnd


def centroids(nodes, cells):
    c = cells.long()
    return ((nodes[c[:, 0]] + nodes[c[:, 1]] + nodes[c[:, 2]]) / 3.0).unbind(1)


def job_inputs(cfg, seed, job, cx, cy, x, y):
    """The job's forcing at the centroids (cx, cy) and Dirichlet data at
    the nodes (x, y), from a handful of numbers drawn from its seed."""
    gen = torch.Generator().manual_seed(job_seed(seed, job))
    modes = cfg["assumed"]["modes"]
    a = 0.5 + torch.rand(len(modes), generator=gen, dtype=torch.float64)
    c = 2.0 * torch.rand(4, generator=gen, dtype=torch.float64) - 1.0
    f = torch.zeros_like(cx)
    for (k, l), am in zip(modes, a.tolist()):
        f += (am * math.pi**2 * (k * k + l * l)) * torch.sin(k * math.pi * cx) * torch.sin(l * math.pi * cy)
    c0, c1, c2, c3 = c.tolist()
    g = c0 + c1 * x + c2 * y + c3 * x * y
    return {"job": job, "f": f, "g": g}


class Bench:
    def __init__(self, cfg, traffic, device, log):
        from fdapde_core_tpu_torch.models import MatrixFreeElliptic

        self.cfg = cfg
        sync = (lambda: torch.cuda.synchronize()) if torch.device(device).type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        self.nodes, self.cells, self.bnd = make_mesh(cfg["mesh"]["n"], cfg["mesh"]["amp"],
                                                     traffic["numbering"], device)
        self.cx, self.cy = centroids(self.nodes, self.cells)
        self.x, self.y = self.nodes[:, 0].contiguous(), self.nodes[:, 1].contiguous()
        sync()
        t_mesh = time.perf_counter() - t0

        def build(nodes, cells, bnd):
            return MatrixFreeElliptic(nodes, cells, bnd, gather_kernel=cfg["gather_kernel"],
                                      preconditioner=cfg["preconditioner"], device=device)

        # the kernel library is loaded (and on a first run built) by a
        # build and a solve on a small mesh of the same kind and numbering
        t0 = time.perf_counter()
        w = traffic["warmup"]
        wn, wc, wb = make_mesh(w["n"], cfg["mesh"]["amp"], w["numbering"], device)
        small = build(wn, wc, wb)
        wcx, wcy = centroids(wn, wc)
        winp = job_inputs(cfg, 0, -1, wcx, wcy, wn[:, 0], wn[:, 1])
        small.solve(small.load_vector(winp["f"]), winp["g"], rtol=cfg["rtol"],
                    maxiter=cfg["maxiter"])
        del small, winp
        sync()
        t_small = time.perf_counter() - t0

        self.model, self.build_s, builds = timed_builds(
            lambda: build(self.nodes, self.cells, self.bnd), sync)
        log(f"{cfg['name']} {traffic['traffic']}: {self.nodes.shape[0]} dofs, "
            f"{self.cells.shape[0]} cells; mesh {t_mesh:.4f} s, small build and solve "
            f"{t_small:.4f} s, builds {builds} s; preconditioner "
            f"{self.model.preconditioner!r}")

    def inputs(self, seed, job):
        return job_inputs(self.cfg, seed, job, self.cx, self.cy, self.x, self.y)

    def run(self, inp):
        b = self.model.load_vector(inp["f"])
        x, its, rel = self.model.solve(b, inp["g"], rtol=self.cfg["rtol"],
                                       maxiter=self.cfg["maxiter"])
        rel = float(rel)
        return {"x": x, "iterations": int(its), "rel": rel, "converged": rel <= self.cfg["rtol"]}

    def keep(self, out):
        return {"x": out["x"]}

    def release(self):
        del self.model

    def reference_data(self):
        return {"nodes": self.nodes, "cells": self.cells, "boundary": self.bnd}
