"""Seconds a job spends in the driver's own code: the program's root spans
of a job's user call (``regression.fit`` / ``regression.gcv``,
``matfree.load_vector`` / ``matfree.solve``) less the ``krylov.solve``
and ``evaluation.basis`` spans inside them, summed over the untraced
window and divided by its jobs. On ``gcv`` this holds the Hutchinson probe
matrix, drawn on the host and uploaded. The run also logs the share of
the traced window's kernel launches that lie inside some program span (the
spans and the profile share one clock), and the main window's spans an
iteration, which with a span's cost give what recording adds to it."""

import sys

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "program_span", "driver", "solve_s"
INNER = ("krylov.solve", "evaluation.basis")


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    jobs = len(run.main.jobs)
    roots = [i for i, r in enumerate(recs)
             if r.parent is None and r.name in spans.DRIVER_ROOTS and r.end_ns is not None]
    if not roots or not jobs:
        return None
    if run.main.iterations:
        print(f"program spans: {len(recs)} in the main window, {len(recs) / run.main.iterations:.2f} "
              f"a Krylov iteration", file=sys.stderr, flush=True)
    starts = spans.launch_starts(run.traced.trace)
    if starts:
        inside = spans.covered(starts, [r for r in spans.traced_spans(run) if r.parent is None])
        print(f"program spans: {inside} of the traced window's {len(starts)} kernel launches "
              f"lie inside a root span ({100.0 * inside / len(starts):.3f} %)",
              file=sys.stderr, flush=True)
    total = sum(spans.seconds(recs[i]) for i in roots)
    inner = sum(spans.seconds(recs[i]) for i in spans.within(recs, roots, INNER))
    return (total - inner) / jobs
