"""Seconds a job spends in the host's part of the Psi build: the untraced
window's ``evaluation.host`` spans (the affine maps, the basis values at
the pulled-back points and the upload of Psi's entries), summed and
divided by its jobs. The run also logs the three stages' seconds a job."""

import sys

from portbench.harness import spans

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "program_span", "evaluation", "solve_s"
STAGES = ("evaluation.affine_maps", "evaluation.basis_values", "evaluation.upload")


def install(run):
    return spans.install(run)


def read(run):
    all_recs = spans.main_spans(run)
    recs = spans.named(all_recs, ("evaluation.host",))
    jobs = len(run.main.jobs)
    if not recs or not jobs:
        return None
    stages = {s: sum(spans.seconds(r) for r in spans.named(all_recs, (s,))) / jobs for s in STAGES}
    print("evaluation.host stages, seconds a job: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()), file=sys.stderr, flush=True)
    return sum(spans.seconds(r) for r in recs) / jobs
