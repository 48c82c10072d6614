"""Krylov iterations a job: the iterations the entry returns, summed over
the job's solves (the inner iterations on the lane path), averaged over
the untraced window's jobs."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "lower", "program_counter", "driver", "solve_s"


def read(run):
    if not run.jobs:
        return None
    return run.iterations / len(run.jobs)
