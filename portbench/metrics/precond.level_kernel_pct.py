"""The share, in %, of the untraced window's V-cycle stages on the levels
above the coarsest (the ``mg.smooth``, ``mg.residual``, ``mg.restrict`` and
``mg.prolong`` spans) that ran on the stage kernels: those that enclose an
``mg.kernel`` span. A program whose stages have no kernels records none
and reads 0; a window with no V-cycle reads nothing."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "program_span", "preconditioner", "solve_s"

STAGES = ("mg.smooth", "mg.residual", "mg.restrict", "mg.prolong")


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    stages = [i for i, r in enumerate(recs) if r.name in STAGES and r.end_ns is not None]
    if not stages:
        return None
    kernel = {r.parent for r in spans.named(recs, ("mg.kernel",))}
    return 100.0 * sum(i in kernel for i in stages) / len(stages)
