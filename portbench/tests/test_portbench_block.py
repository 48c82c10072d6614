"""CPU tests of ``krylov.block_pct``: the share of the untraced window's
column-iterations that ran in solves holding a ``krylov.block`` span, on
hand-made span records and on tiny traced runs of the two ``srpde`` cells.

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

from portbench.harness import runner  # noqa: E402
from fdapde_core_tpu_torch.utils.profiling import SpanRecord  # noqa: E402

METRIC = ROOT / "portbench" / "metrics" / "krylov.block_pct.py"


def read(main):
    run = runner.Run("cpu")
    run.program_spans = {"setup": [], "main": main, "traced": []}
    return runner.load_module(METRIC).read(run)


def job(t, fit_its, block_its=None, nested=False):
    """A gcv-like job at time t: a fit's vector solve of ``fit_its``
    iterations, then (``block_its`` not None) a block solve of the probes;
    with ``nested``, the vector solve sits inside another krylov.solve (an
    outer solve's inner one: only the outermost counts)."""
    recs = [SpanRecord("regression.gcv", t, t + 90, None, 0, None)]
    outer = 0
    if nested:
        recs.append(SpanRecord("krylov.solve", t + 1, t + 40, 0, 0, fit_its))
        outer = 1
    recs.append(SpanRecord("krylov.solve", t + 2, t + 39, outer, 0, fit_its))
    recs.append(SpanRecord("krylov.read", t + 3, t + 4, len(recs) - 1, 0, None))
    if block_its is not None:
        solve = len(recs)
        recs.append(SpanRecord("krylov.solve", t + 41, t + 89, 0, 0, block_its))
        recs.append(SpanRecord("krylov.block", t + 42, t + 88, solve, 0, 16))
        recs.append(SpanRecord("krylov.operator", t + 43, t + 44, solve + 1, 0, None))
    return recs


def window(*jobs):
    """The jobs' records in one take, parents and roots reindexed."""
    out = []
    for recs in jobs:
        n = len(out)
        out += [r._replace(parent=None if r.parent is None else r.parent + n, root=r.root + n)
                for r in recs]
    return out


@pytest.mark.parametrize("main, want", [
    (window(job(0, 123, 1931), job(100, 123, 1933)), 100.0 * 3864 / 4110),  # gcv
    (window(job(0, 100, 300)), 75.0),
    (window(job(0, 123), job(100, 124)), 0.0),                               # fit
    (window(job(0, 100, 300, nested=True)), 75.0),  # the inner solve is part of the outer
    ([], None),                                     # a program without the recorder
], ids=["gcv", "share", "fit", "nested", "no-spans"])
def test_block_pct(main, want):
    got = read(main)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-15)


@pytest.mark.parametrize("name, positive", [("srpde_0p5m.gcv", True), ("srpde_0p5m.fit", False)])
def test_block_pct_on_tiny_runs(name, positive):
    """A traced tiny gcv run reads a share above 0 (the probes' block
    solve), a traced tiny fit 0 (one vector solve)."""
    from test_portbench_harness import TINY

    result, lines = runner.run_cell(ROOT, name, 5_000_000_026, 0.3, True, device="cpu",
                                    overrides=copy.deepcopy(TINY[name]))
    assert result["correct"], lines
    value = result["metrics"]["krylov.block_pct"]["value"]
    assert (0.0 < value < 100.0) if positive else value == 0.0
