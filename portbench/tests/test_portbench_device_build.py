"""CPU test of ``evaluation.device_build_pct`` on hand-made span records:
the share of the untraced window's ``evaluation.host`` spans that hold an
``evaluation.device_build`` span.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402
from fdapde_core_tpu_torch.utils.profiling import SpanRecord  # noqa: E402


def read(main):
    run = runner.Run("cpu")
    run.program_spans = {"setup": [], "main": main, "traced": []}
    return runner.load_module(ROOT / "portbench" / "metrics"
                              / "evaluation.device_build_pct.py").read(run)


def builds(device_in, host_stages=("evaluation.device_build",)):
    """Two jobs' Psi builds, each a locate and a host stage; the host
    stages of the jobs in ``device_in`` hold ``host_stages``, the others
    the parent's three host stages."""
    recs = []
    for k in range(2):
        root = len(recs)
        recs.append(SpanRecord("regression.fit", 100 * k, 100 * k + 90, None, root, None))
        basis = len(recs)
        recs.append(SpanRecord("evaluation.basis", 100 * k + 1, 100 * k + 50, root, root, 7))
        recs.append(SpanRecord("evaluation.locate", 100 * k + 2, 100 * k + 10, basis, root, None))
        host = len(recs)
        recs.append(SpanRecord("evaluation.host", 100 * k + 11, 100 * k + 49, basis, root, None))
        stages = host_stages if k in device_in else (
            "evaluation.affine_maps", "evaluation.basis_values", "evaluation.upload")
        for j, name in enumerate(stages):
            recs.append(SpanRecord(name, 100 * k + 12 + j, 100 * k + 13 + j, host, root, None))
        recs.append(SpanRecord("krylov.solve", 100 * k + 51, 100 * k + 89, root, root, 123))
    return recs


@pytest.mark.parametrize("main, want", [
    (builds({0, 1}), 100.0),      # every build on the device
    (builds({1}), 50.0),
    (builds(set()), 0.0),         # the parent: host stages only
    (builds({0, 1}, ()), 0.0),    # a host stage with no device build inside
    ([SpanRecord("krylov.solve", 0, 100, None, 0, 50)], None),  # no Psi build (Poisson)
    ([], None),                   # a program without the recorder
], ids=["all", "half", "parent", "empty-host", "no-build", "no-spans"])
def test_device_build_pct(main, want):
    assert read(main) == want
