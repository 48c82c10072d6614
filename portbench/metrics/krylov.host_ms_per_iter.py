"""Milliseconds of the host's own work a Krylov iteration: the untraced
window's ``krylov.solve`` spans less the ``krylov.read`` spans inside them
(the host's waits on the residual it reads), over the iterations the
solves report (the spans' values). The operator, the preconditioner and
the loop's Python, as the host runs them, are in it."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "Krylov loop", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    solves, iterations = spans.solve_iterations(recs)
    if not iterations:
        return None
    total = sum(spans.seconds(recs[i]) for i in solves)
    waits = sum(spans.seconds(recs[i]) for i in spans.within(recs, solves, ("krylov.read",)))
    return (total - waits) * 1e3 / iterations
