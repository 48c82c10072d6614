"""Seconds a job spends locating its points: the untraced window's
``evaluation.locate`` spans (the device point location and the read of
its cell ids on the host), summed and divided by its jobs."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "program_span", "evaluation", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.named(spans.main_spans(run), ("evaluation.locate",))
    if not recs or not run.main.jobs:
        return None
    return sum(spans.seconds(r) for r in recs) / len(run.main.jobs)
