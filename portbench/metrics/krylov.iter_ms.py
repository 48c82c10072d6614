"""Milliseconds a Krylov iteration: the untraced window's jobs on the
host's clock, less the spans of work outside the loop that the run
recorded (the Psi build, ``evaluation.basis``, where the cell measures
it), over the window's iterations. What else a job spends outside its
iterations (a load vector, a lift) is shared out over them."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "host_clock", "Krylov loop", "solve_s"
OUTSIDE_THE_LOOP = ("evaluation.basis",)


def read(run):
    if not run.iterations:
        return None
    outside = sum(sum(run.spans.get(name, ())) for name in OUTSIDE_THE_LOOP)
    return (run.window_s - outside) * 1e3 / run.iterations
