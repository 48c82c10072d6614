"""CPU tests of the cell ``pde_0p5m.init_solve``: the cell end to end and
traced at a tiny size, its control and planted faults through the
harness, and its three new per-layer metrics (``metrics/pde.*.py``) on
synthetic spans and on a program that records none.

    python -m pytest portbench/tests/test_portbench_pde.py -q
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
CELL = "pde_0p5m.init_solve"
SEED = 3_000_000_321  # larger than 32 signed bits hold
METRICS = ("pde.init_s", "pde.precond_build_s", "pde.escalations_per_job")
# the metrics the cell shares with the others whose readers find something
# on the CPU (those of the device trace read nothing there)
SHARED_ON_CPU = ("krylov.iterations", "krylov.iter_ms", "krylov.host_ms_per_iter",
                 "krylov.wait_ms_per_iter", "precond.apply_ms", "precond.coarse_kernel_pct",
                 "build.mesh_s")
CFG = json.loads((ROOT / "portbench" / "configs" / "pde_0p5m.json").read_text())
# a 625-dof mesh of the same kind, on the "auto" ladder's first rung as the
# configuration's mesh is; its squared L2 error is the discretisation's at
# h = 1/24 (2.1e-8 to 2.2e-8), the residual limit the configuration's
TINY = {"config": {"mesh": {"kind": "tiny", "nx": 24, "seed": 7, "amp": 0.35},
                   "solver_preconditioner": "auto", "solver_maxiter": 100,
                   "limits": dict(CFG["limits"], l2_error=1e-7)},
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
    assert set(result["checks"]) >= {"true_residual.job0", "l2_error.job0"}


def test_cell_traced():
    result, lines = tiny_run(trace=True)
    assert result["correct"], lines
    metrics = result["metrics"]
    assert set(metrics) == set(METRICS + SHARED_ON_CPU)
    assert metrics["pde.escalations_per_job"]["value"] == 0
    # the coarse solve's kernel is CUDA's: the CPU's coarse solves read 0 %
    assert metrics["precond.coarse_kernel_pct"]["value"] == 0
    assert all(metrics[m]["value"] > 0 for m in METRICS[:2] + SHARED_ON_CPU
               if m != "precond.coarse_kernel_pct")


def test_control_is_not_correct():
    """The reference in float32 in the program's place fails the check."""
    from portbench import control

    out = control.readings(CELL, [], [11, 12, 13], device="cpu", overrides=copy.deepcopy(TINY))
    limits = TINY["config"]["limits"]
    for _, reading in out["control"]:
        assert any(v > limits[k] for k, v in reading.items()), reading


def _sign_flipped(mp):
    from fdapde_core_tpu_torch.fem import assembler

    orig = assembler.local_matrices

    def local(term_kind, *a, **k):
        out = orig(term_kind, *a, **k)
        return -out if term_kind == "advection" else out

    mp.setattr(assembler, "local_matrices", local)


def _float32_solve(mp):
    from fdapde_core_tpu_torch.fem import solvers

    orig = solvers.solve_elliptic

    def solve(A, b, mask, g, symmetric=True, rtol=1e-12, maxiter=None, recovery=True,
              preconditioner=None):
        A32 = A.with_vals(A.vals.float())
        x, info = orig(A32, b.float(), mask, g.float(), symmetric, 1e-5, maxiter, recovery,
                       preconditioner)
        return x.double(), info

    mp.setattr(solvers, "solve_elliptic", solve)


def _mask_dropped(mp):
    from fdapde_core_tpu_torch.pde.pde import PDE

    mp.setattr(PDE, "_boundary", lambda self: (torch.zeros(self.n_dofs, dtype=torch.bool), None))


FAULTS = [_sign_flipped, _float32_solve, _mask_dropped]


@pytest.mark.parametrize("plant", FAULTS, ids=[p.__name__[1:] for p in FAULTS])
def test_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    result, lines = tiny_run()
    assert result["correct"] is False, lines


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
    """Two jobs: the first falls back to SA-AMG and recovers, the second
    takes the auxiliary grid alone. Times in ms."""
    recs = [
        _rec("pde.init", 0, 40, None, 0, 100),          # 0
        _rec("pde.init.stiff", 0, 20, 0, 0),            # 1
        _rec("assembly.local", 5, 15, 1, 0),            # 2
        _rec("pde.solve", 50, 150, None, 3),            # 3
        _rec("precond.build", 50, 60, 3, 3, 0),         # 4
        _rec("precond.build", 60, 80, 3, 3, 1),         # 5
        _rec("krylov.solve", 80, 120, 3, 3, 4),         # 6
        _rec("precond.apply", 85, 90, 6, 3),            # 7
        _rec("krylov.recover", 120, 150, 3, 3),         # 8
        _rec("pde.init", 200, 220, None, 9, 100),       # 9
        _rec("pde.solve", 230, 300, None, 10),          # 10
        _rec("precond.build", 230, 240, 10, 10, 0),     # 11
        _rec("krylov.solve", 240, 300, 10, 10, 6),      # 12
        _rec("krylov.solve", 400, 500, None, 13, 50),   # 13: outside pde.solve
    ]
    run = _run_with(recs, 2)
    values = {m: _reader(m).read(run) for m in METRICS}
    assert values["pde.init_s"] == pytest.approx((0.040 + 0.020) / 2)
    assert values["pde.precond_build_s"] == pytest.approx((0.010 + 0.020 + 0.010) / 2)
    assert values["pde.escalations_per_job"] == pytest.approx((1 + 1) / 2)


def test_metrics_silent_without_the_spans():
    """A program without the PDE API's spans (the parent of this cell), or
    one without a recorder, gives no value and raises nothing."""
    other = [_rec("krylov.solve", 0, 10, None, 0, 5), _rec("precond.apply", 1, 2, 0, 0)]
    for recs in (other, []):
        run = _run_with(recs, 3)
        assert all(_reader(m).read(run) is None for m in METRICS)
    run = runner.Run("cpu")  # nothing installed
    assert all(_reader(m).read(run) is None for m in METRICS)


def test_metric_files_agree_with_benchmark():
    """Each new metric's file states what BENCHMARK.json gives it, and lists
    this cell alone; a metric the cell shares lists it last; the cell's
    traffic file its own entry."""
    entries = {m["name"]: m for m in SPEC["per_layer"] if m["name"] in METRICS}
    assert set(entries) == set(METRICS)
    for name, m in entries.items():
        mod = _reader(name)
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"]), name
        assert m["workloads"] == [CELL]
    shared = [m for m in SPEC["per_layer"] if m["name"] not in METRICS and CELL in m["workloads"]]
    assert {m["name"] for m in shared} >= set(SHARED_ON_CPU)
    assert all(m["workloads"][-1] == CELL for m in shared)
    (w,) = [w for w in SPEC["workloads"] if w["name"] == CELL]
    t = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json").read_text())
    assert {k: t[k] for k in ("config", "traffic", "chips", "why")} == {
        k: w[k] for k in ("config", "traffic", "chips", "why")}
    (c,) = [c for c in SPEC["configs"] if c["name"] == "pde_0p5m"]
    assert c["file"] == "portbench/configs/pde_0p5m.json" and c["reduced"] == CFG["reduced"] == []
