"""Host milliseconds an implicit-Euler step spends outside its Krylov
solve: the mean over the untraced window's ``parabolic.step`` spans of the
span less the ``krylov.solve`` inside it. That is the step's right-hand
side (the mass product and the forcing column), the Dirichlet lift and
the warm start, as the host issues them; a span does not wait for the
device. The steps of a trajectory's GMRES(50) rerun, inside
``krylov.recover``, are left out."""

from portbench.harness import spans
from portbench.harness.runner import BENCH_DIR, load_module

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "driver", "solve_s"
_steps = load_module(BENCH_DIR / "metrics" / "parabolic.iters_per_step.py").first_pass_steps


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    steps = _steps(recs)
    if not steps:
        return None
    solves = spans.within(recs, steps, ("krylov.solve",))
    total = sum(spans.seconds(recs[i]) for i in steps)
    inside = sum(spans.seconds(recs[i]) for i in solves)
    return (total - inside) * 1e3 / len(steps)
