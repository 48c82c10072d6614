"""CPU tests of the cell ``heat_0p5m.trajectory``: the cell end to end and
traced at a tiny size, its float32 control and planted faults through the
harness, the set-up's refusal of a parabolic solve off the auxiliary grid,
and its two new per-layer metrics (``metrics/parabolic.*.py``) on
synthetic spans and on a program that records none.

    python -m pytest portbench/tests/test_portbench_heat.py -q
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402
from fdapde_core_tpu_torch.utils.profiling import SpanRecord  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "heat_0p5m.trajectory"
SEED = 3_000_000_321  # larger than 32 signed bits hold
METRICS = ("parabolic.iters_per_step", "parabolic.step_host_ms")
# the metrics the cell shares with the others whose readers find something
# on the CPU (those of the device trace read nothing there; the two kernel
# shares read 0, since the CPU takes the V-cycle's plain functions)
SHARED_ON_CPU = ("krylov.iterations", "krylov.iter_ms", "krylov.host_ms_per_iter",
                 "krylov.wait_ms_per_iter", "precond.apply_ms", "precond.coarse_kernel_pct",
                 "precond.level_kernel_pct", "build.mesh_s", "pde.init_s", "pde.precond_build_s",
                 "pde.escalations_per_job")
ZERO_ON_CPU = ("precond.coarse_kernel_pct", "precond.level_kernel_pct", "pde.escalations_per_job")
CFG = json.loads((ROOT / "portbench" / "configs" / "heat_0p5m.json").read_text())
# a 625-dof mesh of the same kind over 11 instants (dt = 0.1), on the "auto"
# ladder's first rung as the configuration's mesh is; its squared L2 error
# is implicit Euler's at dt = 0.1 (5.2e-6 to 5.4e-6), the other limits the
# configuration's
TINY = {"config": {"mesh": {"kind": "tiny", "nx": 24, "seed": 7, "amp": 0.35},
                   "times": {"start": 0.0, "stop": 1.0, "count": 11},
                   "solver_preconditioner": "auto", "solver_maxiter": 100,
                   "limits": dict(CFG["limits"], l2_error=2e-5)},
        "traffic": {"warmup": {"nx": 8}}}


def tiny_run(trace=False, seconds=0.3, overrides=None):
    return runner.run_cell(ROOT, CELL, SEED, seconds, trace, device="cpu",
                           overrides=copy.deepcopy(overrides or TINY))


def test_cell_end_to_end():
    result, lines = tiny_run()
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    wanted = {m["name"] for m in SPEC["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert set(result["metrics"]) == wanted == {"solve_s", "build_s", "peak_gib", "setup_s"}
    assert set(result["checks"]) >= {"true_residual.job0", "trajectory_gap.job0", "l2_error.job0"}


def test_cell_traced():
    result, lines = tiny_run(trace=True)
    assert result["correct"], lines
    metrics = result["metrics"]
    assert set(metrics) == set(METRICS + SHARED_ON_CPU)
    assert all(metrics[m]["value"] == 0 for m in ZERO_ON_CPU)
    assert all(metrics[m]["value"] > 0 for m in METRICS + SHARED_ON_CPU if m not in ZERO_ON_CPU)
    # 10 steps a job: the job's iterations are its steps'
    assert metrics["krylov.iterations"]["value"] == pytest.approx(
        10 * metrics["parabolic.iters_per_step"]["value"], rel=0.15)


def test_control_is_not_correct():
    """The reference in float32 in the program's place fails the check's
    residual or trajectory limit."""
    from portbench import control

    out = control.readings(CELL, [], [11, 12, 13], device="cpu", overrides=copy.deepcopy(TINY))
    limits = TINY["config"]["limits"]
    for _, reading in out["control"]:
        assert any(reading[k] > limits[k] for k in ("true_residual", "trajectory_gap")), reading


def _wrap_solve(mp, change):
    """PDE's parabolic solve through ``change(args, kwargs)``, which may
    alter its arguments and return a function of the output."""
    from fdapde_core_tpu_torch.fem import solvers

    orig = solvers.solve_parabolic

    def solve(*args, **kwargs):
        args, kwargs = list(args), dict(kwargs)
        post = change(args, kwargs) or (lambda out: out)
        return post(orig(*args, **kwargs))

    mp.setattr(solvers, "solve_parabolic", solve)


class _MassOffTheRight:
    """The mass matrix in K = A + M / dt, but nothing on the right-hand side
    (M u_prev)."""

    def __init__(self, M):
        self.M = M

    def __mul__(self, c):
        return self.M * c

    def __matmul__(self, v):
        return torch.zeros_like(v)


def _mass_dropped(mp):
    def change(args, kwargs):
        args[1] = _MassOffTheRight(args[1])

    _wrap_solve(mp, change)


def _dt_doubled(mp):
    def change(args, kwargs):
        args[6] = 2 * args[6]

    _wrap_solve(mp, change)


def _float32_solve(mp):
    def change(args, kwargs):
        args[0] = args[0].with_vals(args[0].vals.float())
        args[1] = args[1].with_vals(args[1].vals.float())
        for i in (2, 4, 5):
            args[i] = args[i].float()
        kwargs["rtol"] = 1e-5
        return lambda out: (out[0].double(), out[1])

    _wrap_solve(mp, change)


FAULTS = [_mass_dropped, _dt_doubled, _float32_solve]


@pytest.mark.parametrize("plant", FAULTS, ids=[p.__name__[1:] for p in FAULTS])
def test_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    result, lines = tiny_run()
    assert result["correct"] is False, lines


def _jacobi(mp):
    """A parabolic solve that drops its preconditioner: Jacobi, reported."""
    def change(args, kwargs):
        kwargs["preconditioner"] = None

    _wrap_solve(mp, change)


def _unreported(mp):
    """A program whose report() names no rung for a parabolic solve (the
    parent of this cell)."""
    from fdapde_core_tpu_torch.pde.pde import PDE

    orig = PDE.report
    mp.setattr(PDE, "report", lambda self: {k: v for k, v in orig(self).items()
                                            if k != "preconditioner"})


@pytest.mark.parametrize("plant", [_jacobi, _unreported], ids=["jacobi", "unreported"])
def test_setup_refuses_a_solve_off_the_aux_grid(plant, monkeypatch):
    plant(monkeypatch)
    with pytest.raises(RuntimeError, match="not the auxiliary grid"):
        tiny_run()


def _bench():
    """The cell's Bench at the tiny size, set up on the CPU."""
    cell = runner.Cell(SPEC, CELL, False, copy.deepcopy(TINY))
    return cell.bench_module.Bench(cell.cfg, cell.traffic, "cpu", lambda msg: None)


def test_window_job_off_the_aux_grid_raises(monkeypatch):
    """A job of the window whose parabolic solve falls back from the
    auxiliary grid (here, its build fails after the set-up) raises, so the
    harness counts it failed instead of timing another configuration."""
    from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner

    bench = _bench()
    inp = bench.inputs(SEED, 0)
    assert bench.run(inp)["converged"]

    def failing_build(*a, **k):
        raise ValueError("no covering grid")

    monkeypatch.setattr(AuxGridPreconditioner, "build", failing_build)
    with pytest.warns(UserWarning, match="falling back to SA-AMG"), \
            pytest.raises(RuntimeError, match="fall-back True"):
        bench.run(inp)


def test_check_reads_the_gap_on_the_first_kept_job():
    """The check reads the residual and the L2 error of every kept job and
    the trajectory gap of the first alone; the reference's own float64
    trajectories pass it, with no gap."""
    import numpy as np

    from portbench.harness import meshes

    reference = runner.load_module(ROOT / "portbench" / "reference" / "heat_0p5m.py")
    pts, cells, bnd, _ = meshes.delaunay_mesh(24, 7, 0.35)
    data = {"nodes": pts, "cells": cells, "boundary": bnd, "times": np.linspace(0.0, 1.0, 11)}
    mesh = reference.mesh(data)
    pairs = [(job, {"mu": mu}, {"x": mesh.system(mu).trajectory()})
             for job, mu in ((3, 0.7), (8, 1.9))]
    checks = reference.check(data, pairs, TINY["config"], None, "cpu")
    assert [name for name, _, _ in checks] == [
        "true_residual.job3", "trajectory_gap.job3", "l2_error.job3",
        "true_residual.job8", "l2_error.job8"]
    assert all(value <= limit for _, value, limit in checks), checks
    assert dict((n, v) for n, v, _ in checks)["trajectory_gap.job3"] == 0.0


MS = 1_000_000  # ns


def _rec(name, start_ms, end_ms, parent=None, root=0, value=None):
    return SpanRecord(name, start_ms * MS, end_ms * MS, parent, root, value)


def _run_with(recs, jobs):
    run = runner.Run("cpu")
    run.program_spans = {"setup": [], "main": recs, "traced": []}
    run.main.jobs = [{"iterations": 0}] * jobs
    return run


def _reader(name):
    return runner.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def test_metrics_on_synthetic_spans():
    """Two steps of a first pass (20 and 30 iterations, 2 and 4 ms outside
    their solves), then a GMRES(50) rerun inside krylov.recover whose step
    is left out. Times in ms."""
    recs = [
        _rec("pde.solve", 0, 200, None, 0),              # 0
        _rec("precond.build", 0, 10, 0, 0, 0),           # 1
        _rec("parabolic.step", 10, 40, 0, 0, 20),        # 2
        _rec("krylov.solve", 12, 40, 2, 0, 20),          # 3
        _rec("precond.apply", 13, 14, 3, 0),             # 4
        _rec("parabolic.step", 40, 80, 0, 0, 30),        # 5
        _rec("krylov.solve", 42, 78, 5, 0, 30),          # 6
        _rec("krylov.recover", 80, 200, 0, 0),           # 7
        _rec("parabolic.step", 80, 200, 7, 0, 50),       # 8
    ]
    run = _run_with(recs, 1)
    values = {m: _reader(m).read(run) for m in METRICS}
    assert values["parabolic.iters_per_step"] == pytest.approx((20 + 30) / 2)
    assert values["parabolic.step_host_ms"] == pytest.approx((2 + 4) / 2)


def test_metrics_silent_without_the_spans():
    """A program without the parabolic.step span (the parent of this
    cell), or one without a recorder, gives no value and raises nothing."""
    other = [_rec("pde.solve", 0, 20, None, 0), _rec("krylov.solve", 1, 10, 0, 0, 5)]
    for recs in (other, []):
        run = _run_with(recs, 3)
        assert all(_reader(m).read(run) is None for m in METRICS)
    run = runner.Run("cpu")  # nothing installed
    assert all(_reader(m).read(run) is None for m in METRICS)


def test_metric_files_agree_with_benchmark():
    """Each new metric's file states what BENCHMARK.json gives it, and its
    list holds this cell (later cells may join it); every metric the cell
    shares and reads on the CPU lists it; the cell's traffic file its own
    entry; the configuration cuts nothing."""
    entries = {m["name"]: m for m in SPEC["per_layer"] if m["name"] in METRICS}
    assert set(entries) == set(METRICS)
    for name, m in entries.items():
        mod = _reader(name)
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"]), name
        assert CELL in m["workloads"]
    shared = [m for m in SPEC["per_layer"]
              if m["name"] not in METRICS and CELL in m.get("workloads", [])]
    assert {m["name"] for m in shared} >= set(SHARED_ON_CPU)
    (w,) = [w for w in SPEC["workloads"] if w["name"] == CELL]
    t = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json").read_text())
    assert {k: t[k] for k in ("config", "traffic", "chips", "why")} == {
        k: w[k] for k in ("config", "traffic", "chips", "why")}
    (c,) = [c for c in SPEC["configs"] if c["name"] == "heat_0p5m"]
    assert c["file"] == "portbench/configs/heat_0p5m.json" and c["reduced"] == CFG["reduced"] == []
