"""Kernel launches a Krylov iteration: the kernels the profiler saw run in
the traced window over the traced window's iterations."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "lower", "device_trace", "device", "solve_s"


def read(run):
    t = run.traced.trace
    if t is None or not t.device or not run.traced.iterations:
        return None
    return len(t.kernels) / run.traced.iterations
