#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process at the cell's
own size: the check's numbers for the program on many seeds (the lower
reading) and for the control on a few (the upper reading). The control
is the plain reference put in the program's place in the precision below
the configuration's (float32 for float64): ``reference/<config>.py``'s
``control``. The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... --control-seeds 7,8,9

Prints one JSON line a reading, and a summary line last. Runs on the card
(``--device cpu`` with ``--tiny`` for a rehearsal at test size).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell_name, program_seeds, control_seeds, device="cuda", overrides=None):
    """{"program": [...], "control": [...]}: each entry (seed, {name: value})."""
    import torch

    from portbench.harness.runner import Cell, load_spec, log

    cell = Cell(load_spec(__import__("pathlib").Path(ROOT)), cell_name, False, overrides)
    out = {"program": [], "control": []}
    if program_seeds:
        bench = cell.bench_module.Bench(cell.cfg, cell.traffic, device, log)
        kept = []
        for seed in program_seeds:
            t0 = time.perf_counter()
            res = bench.run(bench.inputs(seed, 0))
            log(f"program seed {seed}: {res['iterations']} iterations, converged "
                f"{res['converged']}, {time.perf_counter() - t0:.4f} s")
            kept.append((seed, bench.keep(res)))
        bench.release()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        data = bench.reference_data()
        for seed, res in kept:
            checks = cell.reference.check(data, [(0, bench.inputs(seed, 0), res)], cell.cfg,
                                          cell.traffic, device)
            out["program"].append((seed, {n.split(".")[0]: v for n, v, _ in checks}))
            print(json.dumps({"side": "program", "seed": seed, "readings": out["program"][-1][1]}),
                  flush=True)
    else:
        bench = None
    if control_seeds:
        if bench is None:
            bench = cell.bench_module.Bench(cell.cfg, cell.traffic, device, log)
            bench.release()
        data = bench.reference_data()
        for seed in control_seeds:
            inp = bench.inputs(seed, 0)
            t0 = time.perf_counter()
            res = cell.reference.control(data, inp, cell.cfg, cell.traffic, device)
            log(f"control seed {seed}: {time.perf_counter() - t0:.4f} s")
            checks = cell.reference.check(data, [(0, inp, res)], cell.cfg, cell.traffic, device)
            out["control"].append((seed, {n.split(".")[0]: v for n, v, _ in checks}))
            print(json.dumps({"side": "control", "seed": seed, "readings": out["control"][-1][1]}),
                  flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    seeds = [[int(s) for s in a.split(",") if s] for a in (args.program_seeds, args.control_seeds)]
    out = readings(args.workload, *seeds, device=args.device)
    summary = {}
    for side, rows in out.items():
        for _, r in rows:
            for name, v in r.items():
                lo, hi = summary.setdefault(side, {}).get(name, (float("inf"), 0.0))
                summary[side][name] = (min(lo, v), max(hi, v))
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
