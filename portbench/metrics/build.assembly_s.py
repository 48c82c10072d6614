"""Seconds of one build in ``SmoothingRegression``'s assembly of its
penalty: the median of the ``build.assembly`` spans of the timed builds,
the last ``BUILD_REPEATS`` (the small build comes first). The builds run
during set-up, before any instrument is installed, so this reader starts the program's recording when the runner loads it,
and the main window's install keeps the set-up's records
(``harness/spans.py``)."""

from portbench.harness import spans
from portbench.harness.runner import BUILD_REPEATS

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "program_span", "assembly and set-up", "build_s"
SPAN = "build.assembly"

spans.record_setup()


def install(run):
    return spans.install(run)


def read(run):
    return spans.build_median(run, SPAN, BUILD_REPEATS)
