"""Seconds a job spends building Psi: a span from the benchmark around the
program's ``fem.evaluation.eval_basis_pointwise`` (point location on the
device, then the host's basis evaluation and the upload), synchronised at
both ends; summed over the untraced window and divided by its jobs."""

from portbench.harness.instruments import install_span

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "program_span", "evaluation", "solve_s"
SPAN = "evaluation.basis"


def install(run):
    return install_span(run.rec, "fdapde_core_tpu_torch.fem.evaluation", "eval_basis_pointwise",
                        SPAN)


def read(run):
    spans = run.spans.get(SPAN)
    if not spans or not run.jobs:
        return None
    return sum(spans) / len(run.jobs)
