"""CPU test of ``precond.level_kernel_pct`` on hand-made span records: the
share of the untraced window's finer-level V-cycle stage spans
(``mg.smooth``, ``mg.residual``, ``mg.restrict``, ``mg.prolong``) that
hold an ``mg.kernel`` span.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402
from fdapde_core_tpu_torch.utils.profiling import SpanRecord  # noqa: E402

STAGES = ("mg.smooth", "mg.residual", "mg.restrict", "mg.prolong", "mg.smooth")


def read(main):
    run = runner.Run("cpu")
    run.program_spans = {"setup": [], "main": main, "traced": []}
    return runner.load_module(ROOT / "portbench" / "metrics"
                              / "precond.level_kernel_pct.py").read(run)


def applies(kernel_in, open_stage=False):
    """Two Krylov iterations' applies, each the five stages of level 0 and
    a coarse solve at level 1 (which holds a coarse-kernel span, read by
    another metric); the stages of the applies in ``kernel_in`` hold an
    ``mg.kernel`` span. ``open_stage``: one more stage span left open."""
    recs = [SpanRecord("krylov.solve", 0, 1000, None, 0, 2)]
    for k in range(2):
        t = 10 + 400 * k
        apply = len(recs)
        recs.append(SpanRecord("precond.apply", t, t + 300, 0, 0, None))
        for s, name in enumerate(STAGES):
            stage = len(recs)
            recs.append(SpanRecord(name, t + 20 * s + 1, t + 20 * s + 10, apply, 0, 0))
            if k in kernel_in:
                recs.append(SpanRecord("mg.kernel", t + 20 * s + 2, t + 20 * s + 9, stage, 0, 0))
        coarse = len(recs)
        recs.append(SpanRecord("mg.coarse", t + 200, t + 250, apply, 0, 1))
        recs.append(SpanRecord("mg.coarse.kernel", t + 201, t + 249, coarse, 0, 1))
    if open_stage:
        recs.append(SpanRecord("mg.smooth", 900, None, 0, 0, 0))
    return recs


@pytest.mark.parametrize("main, want", [
    (applies({0, 1}), 100.0),     # every stage on the kernels
    (applies({1}), 50.0),
    (applies(set()), 0.0),        # a program without the stage kernels
    (applies({0, 1}, open_stage=True), 100.0),  # an unfinished span is not counted
    ([SpanRecord("krylov.solve", 0, 100, None, 0, 50)], None),  # no V-cycle (Jacobi CG)
    ([], None),                   # a program without the recorder
], ids=["all", "half", "parent", "open", "no-vcycle", "no-spans"])
def test_level_kernel_pct(main, want):
    assert read(main) == want
