"""CPU test of ``precond.coarse_kernel_pct`` on hand-made span records: the
share of the untraced window's ``mg.coarse`` spans that hold an
``mg.coarse.kernel`` span.

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


def read(main):
    run = runner.Run("cpu")
    run.program_spans = {"setup": [], "main": main, "traced": []}
    return runner.load_module(ROOT / "portbench" / "metrics"
                              / "precond.coarse_kernel_pct.py").read(run)


def applies(kernel_in):
    """Two Krylov iterations' applies, each a smooth and a coarse solve at
    level 2; the coarse solves listed in ``kernel_in`` hold a kernel span."""
    recs = [SpanRecord("krylov.solve", 0, 100, None, 0, 2)]
    for k in range(2):
        apply = len(recs)
        recs.append(SpanRecord("precond.apply", 10 + 40 * k, 40 + 40 * k, 0, 0, None))
        recs.append(SpanRecord("mg.smooth", 11 + 40 * k, 12 + 40 * k, apply, 0, 0))
        coarse = len(recs)
        recs.append(SpanRecord("mg.coarse", 13 + 40 * k, 30 + 40 * k, apply, 0, 2))
        if k in kernel_in:
            recs.append(SpanRecord("mg.coarse.kernel", 14 + 40 * k, 29 + 40 * k, coarse, 0, 2))
    return recs


@pytest.mark.parametrize("main, want", [
    (applies({0, 1}), 100.0),     # every coarse solve on the kernel
    (applies({1}), 50.0),
    (applies(set()), 0.0),        # a program without the kernel
    ([SpanRecord("krylov.solve", 0, 100, None, 0, 50)], None),  # no V-cycle (Jacobi CG)
    ([], None),                   # a program without the recorder
], ids=["all", "half", "parent", "no-coarse", "no-spans"])
def test_coarse_kernel_pct(main, want):
    assert read(main) == want
