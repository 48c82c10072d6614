"""Milliseconds a Krylov iteration the host waits on the device: the
untraced window's ``krylov.read`` spans (the loop's host reads of its
residual, each of which waits for the work queued before it) inside its
``krylov.solve`` spans, over the iterations the solves report."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "Krylov loop", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    solves, iterations = spans.solve_iterations(recs)
    if not iterations:
        return None
    waits = sum(spans.seconds(recs[i]) for i in spans.within(recs, solves, ("krylov.read",)))
    return waits * 1e3 / iterations
