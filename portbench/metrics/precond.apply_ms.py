"""Milliseconds a preconditioner apply takes on the host's clock: the mean
of the untraced window's ``precond.apply`` spans (the aux-grid or banded
V-cycle inside the Krylov loop). A span does not wait for the device, so
an apply's launches are in it and the kernels they queue may run after
it."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "preconditioner", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    applies = spans.named(spans.main_spans(run), ("precond.apply",))
    if not applies:
        return None
    return sum(spans.seconds(r) for r in applies) * 1e3 / len(applies)
