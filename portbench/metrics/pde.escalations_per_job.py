"""Escalations a job: in each of the untraced window's ``pde.solve`` spans,
every ``precond.build`` after the first (the "auto" ladder's fall-back
from the auxiliary grid to SA-AMG) and every ``krylov.recover`` (the
escalation to GMRES(50) of a solve that did not converge), summed and
divided by the window's jobs. 0 when every solve converged on its first
rung."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "lower", "program_span", "driver", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    solves = spans.outermost(recs, ("pde.solve",))
    if not solves or not run.main.jobs:
        return None
    count = 0
    for i in solves:
        count += max(0, len(spans.within(recs, [i], ("precond.build",))) - 1)
        count += len(spans.within(recs, [i], ("krylov.recover",)))
    return count / len(run.main.jobs)
