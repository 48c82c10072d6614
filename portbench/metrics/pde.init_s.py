"""Seconds a job spends in ``PDE.init``: the untraced window's ``pde.init``
spans (the assembly of the operator, the mass matrix and the forcing,
``pde.init.stiff``, ``pde.init.mass`` and ``pde.init.force`` inside),
summed and divided by its jobs. A span does not wait for the device, so
the assembly's launches are in it and the kernels they queue may run
after it."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "program_span", "assembly and set-up", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    inits = spans.named(spans.main_spans(run), ("pde.init",))
    if not inits or not run.main.jobs:
        return None
    return sum(spans.seconds(r) for r in inits) / len(run.main.jobs)
