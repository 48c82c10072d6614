"""The port's ``PDE`` API on fdaPDE-core's advection-diffusion problem
(``fem_pde_test.cpp:113-166``) against the benchmark's plain reference
(``portbench/reference/pde_0p5m.py``), at a small size on the CPU: the
solution passes the reference's check, planted faults do not, and the
solve's spans are recorded only while recording is on.

CPU only; no JAX.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import fdapde_core_tpu_torch as fdt
from fdapde_core_tpu_torch.pde.pde import PDE
from fdapde_core_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
NX = 24  # a 625-dof mesh of the benchmark's kind
MAXITER = 100  # the program needs 12-13 iterations here; a planted fault may never converge
# the benchmark's true_residual limit; the squared L2 error is the
# discretisation's at h = 1/24 (2.1e-8 to 2.2e-8 for alpha in [0.5, 2]),
# not the benchmark's mesh's
LIMITS = {"true_residual": 1e-10, "l2_error": 1e-7}


def _load(rel):
    spec = importlib.util.spec_from_file_location(rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    meshes = _load("portbench/harness/meshes.py")
    reference = _load("portbench/reference/pde_0p5m.py")
    pts, cells, bnd, _ = meshes.delaunay_mesh(NX, 7, 0.35)
    return reference, {"nodes": pts, "cells": cells, "boundary": bnd}


@pytest.fixture(autouse=True)
def _recording_off():
    profiling.stop_recording()
    profiling.take_records()
    yield
    profiling.stop_recording()
    profiling.take_records()


def _problem(data, dtype=torch.float64):
    return fdt.PDE(fdt.Triangulation(data["nodes"], data["cells"], data["boundary"]),
                   -fdt.laplacian(), order=1, solver_maxiter=MAXITER, solver_preconditioner="auto",
                   device=CPU, dtype=dtype)


def _solve(data, alpha, sign=1.0, dtype=torch.float64, pde=None):
    """One job of the benchmark's cell: init + solve of the problem with
    beta = (-sign alpha, 0) through the "auto" ladder."""
    pde = pde or _problem(data, dtype)
    pde.set_differential_operator(-fdt.laplacian() + fdt.advection((-sign * alpha, 0.0)))
    q = pde.quadrature_nodes()
    pde.set_forcing(math.pi * np.sin(math.pi * q[:, 1]))
    pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
    pde.init()
    pde.solve()
    return pde


def _drop_the_mask(monkeypatch):
    monkeypatch.setattr(PDE, "_boundary",
                        lambda self: (torch.zeros(self.n_dofs, dtype=torch.bool), None))


CASES = {
    "program": {},
    "advection_sign_flipped": {"sign": -1.0},
    "float32_solve": {"dtype": torch.float32},
    "dirichlet_mask_dropped": {"plant": _drop_the_mask},
}


@pytest.mark.parametrize("case", list(CASES))
def test_pde_init_solve_against_the_reference(case, bench, monkeypatch):
    """The program's solution passes the reference's check (true residual
    in the reference's Dirichlet system, squared L2 error to the closed
    form) for seeded alphas; each planted fault fails it."""
    reference, data = bench
    kw = dict(CASES[case])
    plant = kw.pop("plant", None)
    if plant is not None:
        plant(monkeypatch)
    rng = np.random.default_rng(21)
    for alpha in rng.uniform(0.5, 2.0, 2):
        with np.errstate(all="ignore"):
            pde = _solve(data, float(alpha), **kw)
        checks = reference.check(data, [(0, {"alpha": float(alpha)}, {"x": pde.solution()})],
                                 {"limits": LIMITS}, None, CPU)
        correct = all(value <= limit for _, value, limit in checks)
        if case == "program":
            assert correct, checks
            rep = pde.report()
            assert rep["success"] and rep["preconditioner"] == "auxgrid"
            assert not rep["ladder_fallback"] and not rep["recovered"]
            assert 5 <= rep["solver_iterations"] <= 40
        else:
            assert not correct, (case, checks)


def test_pde_spans_recorded_only_while_recording(bench, monkeypatch):
    """On: a ``pde.init`` root valued by the dofs, one span per assembled
    term, each split into the assembly's three stages; a ``pde.solve``
    root holding one ``precond.build`` of rung 0 (the auxiliary grid)
    and one BiCGStab ``krylov.solve``. Off: nothing. When the auxiliary
    grid fails to build, the ladder's fall-back shows as a second
    ``precond.build`` (rung 1, SA-AMG), in a warning and in ``report()``."""
    _, data = bench
    pde = _problem(data)
    _solve(data, 1.0, pde=pde)
    assert profiling.take_records() == []
    with profiling.recording() as recs:
        _solve(data, 1.0, pde=pde)
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["pde.init", "pde.solve"]
    init, solve = roots
    assert recs[init].value == pde.n_dofs

    def children(i):
        return [j for j, r in enumerate(recs) if r.parent == i]

    terms = children(init)
    assert [recs[j].name for j in terms] == ["pde.init.stiff", "pde.init.mass", "pde.init.force"]
    for j in terms:
        assert [recs[k].name for k in children(j)] == [
            "assembly.upload", "assembly.local", "assembly.scatter"]
    under = [recs[j] for j in children(solve)]
    assert [(r.name, r.value) for r in under if r.name == "precond.build"] == [("precond.build", 0)]
    (krylov,) = [r for r in under if r.name == "krylov.solve"]
    assert krylov.value == pde.report()["solver_iterations"]
    assert not any(r.name == "krylov.recover" for r in recs)

    from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner

    def failing_build(*a, **k):
        raise ValueError("no covering grid")

    monkeypatch.setattr(AuxGridPreconditioner, "build", failing_build)
    with profiling.recording() as recs, pytest.warns(UserWarning, match="falling back to SA-AMG"):
        _solve(data, 1.0, pde=pde)
    assert [(r.name, r.value) for r in recs if r.name == "precond.build"] == [
        ("precond.build", 0), ("precond.build", 1)]
    rep = pde.report()
    assert rep["success"] and rep["ladder_fallback"] and rep["preconditioner"] == "amg"
