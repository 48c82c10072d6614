"""Seconds a job spends setting up its preconditioner: the untraced
window's ``precond.build`` spans inside ``pde.solve`` (the auxiliary
grid's host set-up on this cell's "auto" rung; an SA-AMG build after a
fall-back counts too), summed and divided by its jobs."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "program_span", "preconditioner", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    builds = spans.within(recs, spans.outermost(recs, ("pde.solve",)), ("precond.build",))
    if not builds or not run.main.jobs:
        return None
    return sum(spans.seconds(recs[i]) for i in builds) / len(run.main.jobs)
