"""Krylov iterations an implicit-Euler step: the mean value of the
untraced window's ``parabolic.step`` spans (each valued by its step's
iterations), the steps of a trajectory's GMRES(50) rerun, inside
``krylov.recover``, left out (``pde.escalations_per_job`` counts the
rerun)."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "lower", "program_span", "Krylov loop", "solve_s"
STEP, RERUN = "parabolic.step", "krylov.recover"


def install(run):
    return spans.install(run)


def first_pass_steps(recs):
    """Indices of the ``parabolic.step`` records that no ``krylov.recover``
    encloses."""
    reruns = spans.outermost(recs, (RERUN,))
    rerun = set(spans.within(recs, reruns, (STEP,)))
    return [i for i in spans.outermost(recs, (STEP,)) if i not in rerun]


def read(run):
    recs = spans.main_spans(run)
    steps = first_pass_steps(recs)
    if not steps:
        return None
    return sum(recs[i].value or 0 for i in steps) / len(steps)
