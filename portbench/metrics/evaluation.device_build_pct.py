"""The share, in %, of the untraced window's host stages of the Psi build
(the ``evaluation.host`` spans) that built Psi on the device: those that
enclose an ``evaluation.device_build`` span. A program that builds Psi on
the host records none and reads 0; a window with no Psi build reads
nothing."""

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "program_span", "evaluation", "solve_s"


def install(run):
    return spans.install(run)


def read(run):
    recs = spans.main_spans(run)
    host = [i for i, r in enumerate(recs) if r.name == "evaluation.host" and r.end_ns is not None]
    if not host:
        return None
    built = {r.parent for r in spans.named(recs, ("evaluation.device_build",))}
    return 100.0 * sum(i in built for i in host) / len(host)
