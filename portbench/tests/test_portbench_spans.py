"""CPU tests of the per-layer metrics that read the program's own spans
(``harness/spans.py`` and the ten readers in ``metrics/``): their values on
synthetic spans and a synthetic trace, their silence on a program without
the recorder, and the windows in which the program records.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import runner, spans  # noqa: E402
from portbench.harness.trace import Trace  # noqa: E402
from fdapde_core_tpu_torch.utils import profiling  # noqa: E402
from fdapde_core_tpu_torch.utils.profiling import SpanRecord  # noqa: E402

METRICS = ("driver.self_s", "krylov.host_ms_per_iter", "krylov.wait_ms_per_iter",
           "precond.apply_ms", "precond.launches_per_apply", "evaluation.locate_s",
           "evaluation.host_s", "build.mesh_s", "build.space_s", "build.assembly_s")
MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def _recording_off():
    profiling.stop_recording()
    profiling.take_records()
    yield
    profiling.stop_recording()
    profiling.take_records()


def reader(name):
    return runner.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def rec(name, start_ms, end_ms, parent=None, root=0, value=None):
    return SpanRecord(name, start_ms * MS, end_ms * MS, parent, root, value)


def halved(recs):
    return [r._replace(start_ns=r.start_ns // 2, end_ns=r.end_ns // 2) for r in recs]


def synthetic_run():
    """Two jobs in each window: a gcv-like root with a Psi build and a
    solve, and a Poisson-like load vector and solve whose preconditioner
    runs a two-level V-cycle; launches at known times in the traced
    window. The main window's spans take half as long as the traced
    window's: the metrics of time read the main window, the launch counts
    the traced one."""
    traced = [
        rec("regression.gcv", 0, 100),                                  # 0
        rec("evaluation.basis", 1, 41, 0, 0, 1000),                     # 1
        rec("evaluation.locate", 1, 11, 1, 0),                          # 2
        rec("evaluation.host", 11, 41, 1, 0),                           # 3
        rec("evaluation.affine_maps", 11, 21, 3, 0),                    # 4
        rec("krylov.solve", 50, 90, 0, 0, 4),                           # 5
        rec("krylov.read", 60, 62, 5, 0),                               # 6
        rec("krylov.read", 70, 72, 5, 0),                               # 7
        rec("matfree.load_vector", 200, 204, None, 8),                  # 8
        rec("matfree.solve", 210, 300, None, 9),                        # 9
        rec("krylov.solve", 212, 292, 9, 9, 2),                         # 10
        rec("precond.apply", 220, 240, 10, 9),                          # 11
        rec("mg.smooth", 221, 223, 11, 9, 0),                           # 12
        rec("mg.coarse", 224, 234, 11, 9, 1),                           # 13
        rec("krylov.read", 250, 260, 10, 9),                            # 14
        rec("precond.apply", 262, 272, 10, 9),                          # 15
    ]
    setup = [rec(n, 10 * k, 10 * k + d) for k, (n, d) in enumerate(
        [("build.mesh", 9), ("build.space", 9), ("build.assembly", 9),   # the small build
         ("build.mesh", 1), ("build.space", 4), ("build.assembly", 2),
         ("build.mesh", 3), ("build.space", 5), ("build.assembly", 6),
         ("build.mesh", 2), ("build.space", 6), ("build.assembly", 4)])]
    # launches: 3 in the first apply (2 in its coarse solve), 1 in the
    # second, 2 in the loop outside the preconditioner, 1 outside any span;
    # a driver-API call inside a runtime call is one launch
    host = [(s * MS, s * MS + 1000, "cudaLaunchKernel") for s in (222, 225, 230, 265, 255, 291, 500)]
    host += [(230 * MS + 100, 230 * MS + 500, "cuLaunchKernel"),
             (261 * MS, 262 * MS, "cudaStreamSynchronize")]
    run = runner.Run("cpu")
    run.main.jobs = [{"iterations": 4}, {"iterations": 2}]
    run.traced.jobs = [{"iterations": 4}, {"iterations": 2}]
    run.traced.trace = Trace([(0, 10, "k")], host, 600 * MS)
    run.program_spans = {"setup": setup, "main": halved(traced), "traced": traced}
    return run


def test_readers_on_synthetic_spans(capsys):
    run = synthetic_run()
    got = {m: reader(m).read(run) for m in METRICS}
    s = 1e-3  # seconds a millisecond
    h = 0.5  # the main window's times against the traced window's
    want = {
        # roots 100 + 4 + 90 ms, less the Psi build (40) and the solves (40 + 80)
        "driver.self_s": h * (100 + 4 + 90 - 40 - 40 - 80) * s / 2,
        # solves 120 ms less reads 14 ms over 6 iterations
        "krylov.host_ms_per_iter": h * (120 - 14) / 6,
        "krylov.wait_ms_per_iter": h * 14 / 6,
        "precond.apply_ms": h * (20 + 10) / 2,
        "precond.launches_per_apply": 4 / 2,
        "evaluation.locate_s": h * 10 * s / 2,
        "evaluation.host_s": h * 30 * s / 2,
        # the last three builds: medians of (1, 3, 2), (4, 5, 6), (2, 6, 4) ms
        "build.mesh_s": 2 * s,
        "build.space_s": 5 * s,
        "build.assembly_s": 4 * s,
    }
    assert got == pytest.approx(want)
    err = capsys.readouterr().err
    assert ("precond mg.coarse level 1: 1 spans, 2.5000 host ms an apply untraced, 1.00 "
            "launches an apply") in err
    assert "program spans: 16 in the main window, 2.67 a Krylov iteration" in err
    assert "6 of the traced window's 7 kernel launches lie inside a root span" in err
    assert "0.67 launches inside precond.apply a Krylov iteration" in err


def test_readers_silent_without_the_recorder(monkeypatch):
    """A program without the recorder (an older commit): installing does
    nothing, nothing is recorded and every reader returns None."""
    monkeypatch.setattr(spans, "recorder", lambda: None)
    run = runner.Run("cpu")
    run.main.jobs = run.traced.jobs = [{"iterations": 3}]
    run.traced.trace = Trace([(0, 10, "k")], [(1, 2, "cudaLaunchKernel")], 100)
    spans.record_setup()
    for m in METRICS:
        mod = reader(m)
        mod.install(run)()
    assert not profiling.is_recording()
    assert all(reader(m).read(run) is None for m in METRICS)


def test_split_at_the_traced_window():
    """One recording over both windows splits at the first root that ends
    after the traced window's first profiled event; the traced window's
    parents and roots index its own list."""
    recs = [rec("matfree.solve", 0, 10), rec("krylov.solve", 1, 9, 0, 0, 3),
            rec("matfree.solve", 20, 30, None, 2), rec("krylov.solve", 21, 29, 2, 2, 3),
            # the traced window: a child that ends before its root's first launch
            rec("regression.gcv", 40, 60, None, 4), rec("evaluation.locate", 41, 42, 4, 4),
            rec("krylov.solve", 50, 59, 4, 4, 5)]
    main, traced = spans.split(recs, Trace([(45 * MS, 46 * MS, "k")], [(44 * MS, 45 * MS, "c")], 0))
    assert main == recs[:4]
    assert [(r.name, r.parent, r.root) for r in traced] == [
        ("regression.gcv", None, 0), ("evaluation.locate", 0, 0), ("krylov.solve", 0, 0)]
    assert spans.split(recs, None) == ([], [])


def test_loading_readers_leaves_recording_off():
    """Loading the build readers arms the set-up's recording only where the
    runner's ``Cell`` loads them, for the run it sets up."""
    for m in METRICS:
        reader(m)
    assert not profiling.is_recording()
    spec = runner.load_spec(ROOT)
    runner.Cell(spec, "srpde_0p5m.fit", False)
    assert not profiling.is_recording()
    runner.Cell(spec, "srpde_0p5m.fit", True)
    assert profiling.is_recording()


def _recording_seen(monkeypatch):
    """(window index, recording?) for each job of each window of a run."""
    seen = []
    orig_measure = runner.measure

    def measure(w, seconds, bench, *a, **k):
        window = len({i for i, _ in seen})
        orig_run = bench.run

        def run(inp):
            seen.append((window, profiling.is_recording()))
            return orig_run(inp)

        bench.run = run
        try:
            return orig_measure(w, seconds, bench, *a, **k)
        finally:
            bench.run = orig_run

    monkeypatch.setattr(runner, "measure", measure)
    return seen


def test_untraced_run_records_nothing(monkeypatch):
    """A ``--trace 0`` run, which gives the end-to-end metrics, loads no
    reader: the program records nothing while its window's jobs run."""
    from test_portbench_harness import TINY

    seen = _recording_seen(monkeypatch)
    name = "srpde_0p5m.gcv"
    result, lines = runner.run_cell(ROOT, name, 5_000_000_019, 0.3, False, device="cpu",
                                    overrides=copy.deepcopy(TINY[name]))
    assert result["correct"], lines
    assert seen and all(w == 0 and not on for w, on in seen)
    assert not profiling.is_recording()


def test_traced_run_records_both_windows(monkeypatch):
    """A traced tiny run of a cell that reads every new metric of time: the
    program records during set-up (the build metrics' window) and through
    both windows, and stops at the run's end."""
    from test_portbench_harness import TINY

    seen = _recording_seen(monkeypatch)
    name = "srpde_0p5m.fit"
    result, lines = runner.run_cell(ROOT, name, 5_000_000_017, 0.3, True, device="cpu",
                                    overrides=copy.deepcopy(TINY[name]))
    assert result["correct"], lines
    assert {w for w, _ in seen} == {0, 1} and all(on for _, on in seen)
    assert not profiling.is_recording()
    metrics = result["metrics"]
    # on the CPU the launch count finds no runtime call to read
    assert {"driver.self_s", "krylov.host_ms_per_iter", "krylov.wait_ms_per_iter",
            "evaluation.locate_s", "evaluation.host_s", "build.mesh_s", "build.space_s",
            "build.assembly_s"} <= set(metrics)
    assert all(metrics[m]["value"] > 0 for m in ("driver.self_s", "krylov.host_ms_per_iter",
                                                  "evaluation.locate_s", "build.assembly_s"))
