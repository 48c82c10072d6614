#!/usr/bin/env python3
"""The benchmark of fdapde_core_tpu_torch (the PyTorch/CUDA port): one run
of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. Cells, configurations, traffic and metrics are named in
``BENCHMARK.json`` and read from their files under ``portbench/``
(``harness/runner.py``). With ``--trace 0`` the last line of standard
output holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a profiled window; both hold ``correct``, the
result of the check against the plain reference (``reference/``), whose
numbers and limits are also the last lines of standard error.

Exits 2, printing no result, without the cards the cell asks for, and 3
if a JAX module or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start():
    """perf_counter() at this process's start (Linux /proc), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    import argparse
    import json
    import subprocess
    from pathlib import Path

    import torch

    from portbench.harness.runner import forbidden_modules, load_spec, log, run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cells = {w["name"]: w for w in load_spec(Path(ROOT))["workloads"]}
    chips = cells[args.workload]["chips"] if args.workload in cells else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}")
        return 2
    torch.cuda.set_device(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi not read ({exc})"
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda", process_start=PROCESS_START, chips=chips)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process, which the benchmark forbids: {', '.join(bad)}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
