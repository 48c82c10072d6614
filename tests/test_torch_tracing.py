"""The port's span recorder (``fdapde_core_tpu_torch.utils.profiling``):
off by default at the cost of a flag test, and when on, spans at the
layer boundaries that nest as the calls do, carry the counts the calls
return, and share a clock with ``torch.profiler``'s events.

CPU only, at small sizes; no JAX.
"""

import json

import numpy as np
import pytest
import torch

import fdapde_core_tpu_torch as fdt
from fdapde_core_tpu_torch.geometry import unit_square_mesh
from fdapde_core_tpu_torch.models import SmoothingRegression, regression
from fdapde_core_tpu_torch.ops.auxgrid import _grid_stencil
from fdapde_core_tpu_torch.ops.grid_mg import GridMG
from fdapde_core_tpu_torch.utils import profiling

CPU = "cpu"


@pytest.fixture(autouse=True)
def _recording_off():
    profiling.stop_recording()
    profiling.take_records()
    yield
    profiling.stop_recording()
    profiling.take_records()


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def test_disabled_span_records_nothing():
    """Off: span returns one shared no-op, which takes a value and keeps
    nothing; a solve through the spanned loops records nothing."""
    assert not profiling.is_recording()
    a, b = profiling.span("krylov.solve"), profiling.span("mg.smooth", 3)
    assert a is b
    with profiling.span("x") as sp:
        sp.value = 7
    assert sp.value is None
    A = torch.diag(torch.arange(1.0, 21.0, dtype=torch.float64))
    x, info = fdt.linear_algebra.cg(A, torch.ones(20, dtype=torch.float64), rtol=1e-12)
    assert info.converged and profiling.take_records() == []


def test_records_nest_and_keep_values():
    with profiling.recording() as recs:
        with profiling.span("a", 1):
            with profiling.span("b") as sp:
                sp.value = 5
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    assert [r.name for r in recs] == ["a", "b", "c", "d"]
    assert [(r.parent, r.root, r.value) for r in recs] == [(None, 0, 1), (0, 0, 5), (0, 0, None),
                                                            (None, 3, None)]
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert recs[0].start_ns <= recs[1].start_ns and recs[2].end_ns <= recs[0].end_ns
    assert not profiling.is_recording() and profiling.take_records() == []


@pytest.mark.parametrize("fit", [False, True], ids=["gcv", "fit"])
def test_regression_spans(fit, monkeypatch):
    """One root per call, the Psi build's location and its device build
    inside it, and one krylov.solve per CG solve valued by the iterations
    the solve returns: the fit's, and for gcv one block solve of the probes
    holding a krylov.block span valued by the probe count; the set-up's
    stages in the constructor, the assembly's in its own three."""
    square = unit_square_mesh(12)
    with profiling.recording() as setup:
        mesh = fdt.Triangulation(square.nodes, square.cells, square.boundary_nodes)
        model = SmoothingRegression(mesh, -fdt.laplacian(), device=CPU)
    assert [(r.name, r.parent) for r in setup] == [("build.mesh", None), ("build.space", None),
                                                  ("build.assembly", None),
                                                  ("assembly.upload", 2), ("assembly.local", 2),
                                                  ("assembly.scatter", 2)]
    returned = []
    orig = regression.cg

    def cg(*a, **k):
        x, info = orig(*a, **k)
        returned.append(info.iterations)
        return x, info

    monkeypatch.setattr(regression, "cg", cg)
    rng = np.random.default_rng(0)
    locs = rng.uniform(0.0, 1.0, (300, 2))
    y = np.sin(4 * locs[:, 0]) + 0.1 * rng.standard_normal(300)
    with profiling.recording() as recs:
        if fit:
            model.fit(locs, y, 1e-2)
        else:
            model.gcv(locs, y, 1e-2, n_probes=3, seed=4)
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["regression.fit" if fit else "regression.gcv"]
    (basis,) = [i for i, r in enumerate(recs) if r.name == "evaluation.basis"]
    assert recs[basis].parent == 0 and recs[basis].value == 300
    assert [r.name for r in _children(recs, basis)] == ["evaluation.locate", "evaluation.host"]
    host = recs.index(_children(recs, basis)[1])
    assert [r.name for r in _children(recs, host)] == ["evaluation.device_build"]
    solves = [i for i, r in enumerate(recs) if r.name == "krylov.solve"]
    assert len(solves) == (1 if fit else 2) == len(returned)
    assert [recs[i].value for i in solves] == returned and all(recs[i].parent == 0 for i in solves)
    blocks = [i for i, r in enumerate(recs) if r.name == "krylov.block"]
    if fit:
        assert blocks == []
    else:  # the probes' block solve: its loop inside a krylov.block span
        (block,) = blocks
        assert recs[block].parent == solves[1] and recs[block].value == 3
        assert _children(recs, solves[1]) == [recs[block]]
    for i in solves[:1] + blocks:
        kids = {r.name for r in _children(recs, i)}
        assert kids == {"krylov.operator", "precond.apply", "krylov.read"}, kids
    assert all(r.root == 0 for r in recs)


def test_vcycle_spans_every_level():
    """A GridMG V-cycle: smooth (pre and post), residual, restrict and
    prolong at every level but the coarsest, one coarse solve there."""
    m = 65
    interior = torch.zeros(m, dtype=torch.float64)
    interior[1:-1] = 1.0
    mg = GridMG.build(_grid_stencil(interior[:, None] * interior[None, :]), coarse_n=4)
    assert mg.n_levels == 5
    r = torch.rand(m * m, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    with profiling.recording() as recs:
        z = mg.v_cycle(r)
    assert torch.equal(z, mg.v_cycle(r))  # off again: the same result
    counts = {}
    for rec in recs:
        counts[(rec.name, rec.value)] = counts.get((rec.name, rec.value), 0) + 1
    want = {("mg.coarse", 4): 1}
    for lvl in range(4):
        want.update({("mg.smooth", lvl): 2, ("mg.residual", lvl): 1, ("mg.restrict", lvl): 1,
                     ("mg.prolong", lvl): 1})
    assert counts == want
    # the level below runs between a level's restrict and prolong
    order = [(r.name, r.value) for r in recs]
    assert order.index(("mg.restrict", 0)) < order.index(("mg.coarse", 4)) < order.index(
        ("mg.prolong", 0))


def test_spans_share_the_profilers_clock(tmp_path):
    """A record_function marker opened inside a span lies within the span,
    in torch.profiler's events and in the Chrome trace xprof_trace writes
    (its spans on a track of their own)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as recs:
            with profiling.span("outer"):
                with record_function("marker"):
                    torch.ones(64).sum()
    (rec,) = recs
    (mark,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "marker"]
    assert rec.start_ns <= mark.start_ns() <= mark.start_ns() + mark.duration_ns() <= rec.end_ns

    with profiling.xprof_trace(str(tmp_path / "trace")):
        with profiling.span("outer", 2):
            with record_function("marker"):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (spanned,) = [e for e in events if e.get("cat") == "program_span"]
    (marker,) = [e for e in events if e.get("name") == "marker" and e.get("ph") == "X"]
    assert spanned["name"] == "outer" and spanned["args"] == {"value": 2}
    assert spanned["ts"] <= marker["ts"] and (marker["ts"] + marker["dur"]
                                              <= spanned["ts"] + spanned["dur"])
    assert not profiling.is_recording()
