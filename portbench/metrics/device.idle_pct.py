"""The device's idle share of the traced window, in %: 100 (1 - the union
of the device's activity intervals over the window's length). The window
is profiled with CUDA activity alone, so the host runs near its untraced
speed; the run logs the ratio of its traced to its untraced time an
iteration."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "lower", "device_trace", "device", "solve_s"


def read(run):
    t = run.traced.trace
    if t is None or not t.device or t.window_ns <= 0:
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns)
