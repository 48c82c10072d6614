"""Kernel launches a preconditioner apply: the kernel-launch runtime calls
of the traced window's profile whose start lies inside a
``precond.apply`` span, over the applies. The run also logs, for each
span of the preconditioner's layer and each level (``mg.*`` spans are
valued by their V-cycle level, 0 the finest), its spans and host
milliseconds an apply in the untraced window, its launches an apply in
the traced one, and the apply's launches per Krylov iteration."""

import sys

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "lower", "program_span", "preconditioner", "solve_s"
STAGES = ("precond.apply", "auxgrid.restrict", "auxgrid.interpolate", "mg.smooth", "mg.residual",
          "mg.restrict", "mg.prolong", "mg.coarse")


def install(run):
    return spans.install(run)


def _groups(recs):
    """(stage index, level or -1) -> the stage's records."""
    out = {}
    for r in spans.named(recs, STAGES):
        out.setdefault((STAGES.index(r.name), r.value if r.value is not None else -1), []).append(r)
    return out


def read(run):
    recs = spans.traced_spans(run)
    applies = spans.named(recs, ("precond.apply",))
    starts = spans.launch_starts(run.traced.trace)
    if not applies or not starts:
        return None
    n = len(applies)
    main = _groups(spans.main_spans(run))
    n_main = len(main.get((0, -1), ()))
    for key, rs in sorted(_groups(recs).items()):
        k, level = key
        host = sum(spans.seconds(r) for r in main.get(key, ()))
        print(f"precond {STAGES[k]}{'' if level < 0 else f' level {level}'}: "
              f"{len(main.get(key, ()))} spans, "
              f"{host * 1e3 / n_main if n_main else float('nan'):.4f} host ms an apply untraced, "
              f"{spans.count_inside(starts, rs) / n:.2f} launches an apply",
              file=sys.stderr, flush=True)
    launches = spans.count_inside(starts, applies)
    if run.traced.iterations:
        print(f"precond: {launches / run.traced.iterations:.2f} launches inside precond.apply a "
              f"Krylov iteration ({n} applies, {run.traced.iterations} iterations)",
              file=sys.stderr, flush=True)
    return launches / n
