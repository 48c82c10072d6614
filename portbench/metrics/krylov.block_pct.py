"""The share, in %, of the untraced window's Krylov column-iterations (the
values of the outermost ``krylov.solve`` spans) that ran in block solves:
solves that enclose a ``krylov.block`` span. A window whose solves hold no
``krylov.block`` span reads 0; one with no iterations reads nothing."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "program_span", "Krylov loop", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    solves, iterations = spans.solve_iterations(recs)
    if not iterations:
        return None
    # each record's outermost krylov.solve (records follow their parents)
    top = [None] * len(recs)
    for i, r in enumerate(recs):
        up = None if r.parent is None else top[r.parent]
        top[i] = i if up is None and r.name == "krylov.solve" else up
    blocked = {top[i] for i, r in enumerate(recs) if r.name == "krylov.block"}
    return 100.0 * sum(recs[i].value or 0 for i in solves if i in blocked) / iterations
