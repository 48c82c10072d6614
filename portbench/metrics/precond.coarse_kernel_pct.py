"""The share, in %, of the untraced window's V-cycle coarse solves (the
``mg.coarse`` spans) that ran on the coarse-solve kernel: those that
enclose an ``mg.coarse.kernel`` span. A program whose coarse solve has no
kernel records none and reads 0; a window with no coarse solve reads
nothing."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "program_span", "preconditioner", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    coarse = [i for i, r in enumerate(recs) if r.name == "mg.coarse" and r.end_ns is not None]
    if not coarse:
        return None
    kernel = {r.parent for r in spans.named(recs, ("mg.coarse.kernel",))}
    return 100.0 * sum(i in kernel for i in coarse) / len(coarse)
