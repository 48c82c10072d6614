"""Host waits for the device a Krylov iteration: the CUDA runtime calls in
the traced window that block the host (stream, device and event
synchronise, and synchronous copies, as a read of a device scalar makes)
over the traced window's iterations."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "lower", "device_trace", "Krylov loop", "solve_s"


def read(run):
    t = run.traced.trace
    if t is None or not t.device or not run.traced.iterations:
        return None
    return t.host_syncs() / run.traced.iterations
