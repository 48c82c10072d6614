"""One run of one cell: set-up, warm-up, the measured window, the
metrics, and the check of what the window produced against the plain
reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (sizes, tolerances, limits) and
  ``configs/<config>.py``, whose ``Bench(cfg, traffic, device, log)`` sets
  the program up (``build_s``) and has ``inputs(seed, job)``,
  ``run(inputs)``, ``keep(outputs)``, ``release()`` and
  ``reference_data()``;
- ``workloads/<cell>.json``: the traffic parameters;
- ``metrics/<metric>.py``: ``read(run)`` and, where the metric needs an
  instrument, ``install(run)``: installed before the run's first window,
  or before the traced window where the module sets ``WINDOW = "traced"``;
- ``reference/<config>.py``: ``check(data, pairs, cfg, traffic, device)``,
  the comparison that decides ``correct``.

The loop is closed, with one caller: each job starts when the last has
ended, and the window ends with the job during which its jobs' seconds
reach ``seconds``. After each job the harness collects Python's garbage,
outside the job's time, and records the device bytes that frees: what the
job left in reference cycles, which a user's loop would hold until
Python's own collector ran.

A ``--trace 1`` run measures the same window untraced first, for the
metrics taken on the host's clock and from the program's counters, then
profiles a shorter window (CUDA activity alone, no host operators) for the
metrics taken from the device's trace.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import statistics
import sys
import time
import traceback
from pathlib import Path

import torch

from . import instruments
from .trace import traced

BENCH_DIR = Path(__file__).resolve().parents[1]
# modules that may not be loaded in the process that prints a result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "fdapde_core_tpu")
KEEP = 2  # jobs of the window kept, drawn from the seed, for the check
# the traced window's length: its metrics are ratios that 10 s of jobs read
# as well as the whole window, and the trace's reduction grows with it
TRACE_SECONDS = 10
# builds timed in every configuration, of which build_s is the median: one
# build of srpde_0p5m spreads by 12-14 % from run to run without its
# farthest run (the host's speed drifts), and a Poisson build of ~0.2 s is
# under the host clock's resolution of a quarter of a second
BUILD_REPEATS = 3


def job_seed(seed: int, job: int) -> int:
    """The seed of one job's inputs: distinct for every (seed, job)."""
    return (seed * 1_000_003 + job + 2) % (2**61 - 1)


def timed_builds(build, sync):
    """(the last of ``BUILD_REPEATS`` builds, their median seconds, each
    one's seconds). Each build starts with the last one's state freed, so
    the device holds one at a time."""
    out, times = None, []
    for _ in range(BUILD_REPEATS):
        out = None
        gc.collect()
        sync()
        t0 = time.perf_counter()
        out = build()
        sync()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times), [round(t, 4) for t in times]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path):
    """A module from a file of the benchmark (file names may hold dots)."""
    name = "portbench_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path):
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    metrics, read from their files."""

    def __init__(self, spec, name, trace: bool, overrides=None):
        overrides = overrides or {}
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.config = self.entry["config"]
        self.cfg = json.loads((BENCH_DIR / "configs" / f"{self.config}.json").read_text())
        self.cfg.update(overrides.get("config", {}))
        self.traffic = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
        self.traffic.update(overrides.get("traffic", {}))
        self.bench_module = load_module(BENCH_DIR / "configs" / f"{self.config}.py")
        self.reference = load_module(BENCH_DIR / "reference" / f"{self.config}.py")
        kind = "per_layer" if trace else "end_to_end"
        self.metrics = [m for m in spec[kind] if name in m.get("workloads", [name])]
        self.readers = ({m["name"]: load_module(BENCH_DIR / "metrics" / f"{m['name']}.py")
                         for m in self.metrics} if trace else {})


class Window:
    """The jobs of one measured window and what the instruments recorded
    during it."""

    def __init__(self):
        self.jobs = []  # {"seconds", "iterations", "converged", "peak", "cycle_bytes", "gc_s"}
        self.window_s = 0.0  # the jobs' seconds, summed
        self.spans = {}  # name -> [host seconds of each call]
        self.launches = {}  # name -> [per-launch records]
        self.trace = None  # the traced window's Trace

    @property
    def iterations(self):
        return sum(j["iterations"] for j in self.jobs)


class Run:
    """What one run measured: its untraced window (``jobs``,
    ``window_s``, ``spans``, ``iterations``) and, in a traced run, the
    traced window (``traced``). Per-layer metric readers read this."""

    def __init__(self, device):
        self.main = Window()
        self.traced = Window()
        self.rec = instruments.Recorder(instruments.device_sync(device))
        self.undo = []

    def __getattr__(self, name):
        if name in ("jobs", "window_s", "spans", "iterations"):
            return getattr(self.main, name)
        raise AttributeError(name)


class Reservoir:
    """A uniform sample of ``k`` of the jobs seen, drawn from the seed."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        i = self.rng.randrange(self.seen)
        if i < self.k:
            self.items[i] = item


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def measure(w, seconds, bench, seed, first_job, kept, sync, collect, cuda):
    """Jobs back to back into window ``w`` until their seconds reach
    ``seconds``; returns (attempted, failed, the next job's index). With
    ``collect``, Python's garbage is collected after each job, outside its
    time, and the device bytes that frees recorded."""
    attempted = failed = 0
    job = first_job
    while w.window_s < seconds:
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = bench.run(bench.inputs(seed, job))
            sync()
        except Exception:  # a job that raises is counted as failed; the loop goes on
            log(f"job {job} raised:\n{traceback.format_exc()}")
            failed += 1
            out = None
        if out is not None:
            kept.offer((job, bench.keep(out)))
        out_ok = out is not None and out["converged"]
        n_iter = None if out is None else out["iterations"]
        out = None
        t1 = time.perf_counter()
        w.window_s += t1 - t0
        cycle_bytes = gc_s = None
        if collect:
            before = torch.cuda.memory_allocated() if cuda else None
            g0 = time.perf_counter()
            gc.collect()
            gc_s = time.perf_counter() - g0
            if cuda:
                cycle_bytes = before - torch.cuda.memory_allocated()
        if n_iter is not None:
            failed += not out_ok
            w.jobs.append({"seconds": t1 - t0, "iterations": n_iter, "converged": out_ok,
                           "peak": torch.cuda.max_memory_allocated() if cuda else 0,
                           "cycle_bytes": cycle_bytes, "gc_s": gc_s})
        job += 1
    return attempted, failed, job


def log_window(label, w):
    log(f"{label} jobs (seconds, peak GiB after, MiB freed by the collection after, its "
        f"seconds): " + ", ".join(
            f"{j['seconds']:.4f} {j['peak'] / 2**30:.4f}"
            + ("" if j["gc_s"] is None else f" {(j['cycle_bytes'] or 0) / 2**20:.1f} {j['gc_s']:.4f}")
            for j in w.jobs))
    log(f"{label} window: {len(w.jobs)} jobs completed in {w.window_s:.4f} s, iterations per "
        f"job {[j['iterations'] for j in w.jobs]}")


def run_cell(root, name, seed, seconds, trace, device="cuda", process_start=None,
             overrides=None, chips=1):
    """One run; returns (result dict, check lines). The result is what the
    command prints as its last line."""
    root = Path(root)
    if process_start is None:
        process_start = time.perf_counter()
    spec = load_spec(root)
    cell = Cell(spec, name, trace, overrides)
    sync = instruments.device_sync(device)
    run = Run(device)
    cuda = torch.device(device).type == "cuda"

    torch.zeros(1, device=device)  # the device's context, apart from the set-up proper
    sync()
    t_entry = time.perf_counter()
    bench = cell.bench_module.Bench(cell.cfg, cell.traffic, device, log)
    t_bench = time.perf_counter()
    warm = bench.inputs(seed, -1)
    bench.run(warm)  # every shape of the window, once
    sync()
    del warm
    log(f"set-up: start-up (interpreter, torch, the device's context) "
        f"{t_entry - process_start:.4f} s, configuration set-up {t_bench - t_entry:.4f} s "
        f"(build {bench.build_s:.4f} s of it), warm-up job {time.perf_counter() - t_bench:.4f} s")

    def install(when):
        for m in cell.metrics:
            reader = cell.readers[m["name"]]
            if getattr(reader, "install", None) is not None and getattr(
                    reader, "WINDOW", "main") == when:
                run.undo.append(reader.install(run))

    if trace:
        install("main")
    sync()
    # set-up's garbage is collected and frozen, so the collection after
    # each job scans only what that job made
    gc.collect()
    gc.freeze()

    kept = Reservoir(KEEP, seed)
    t_start = time.perf_counter()
    setup_s = t_start - process_start
    run.rec.spans, run.rec.launches = run.main.spans, run.main.launches
    attempted, failed, job = measure(run.main, seconds, bench, seed, 0, kept, sync, True, cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log_window("window", run.main)
    if trace:
        install("traced")
        run.rec.spans, run.rec.launches = run.traced.spans, run.traced.launches
        with traced(device) as box:
            t0 = time.perf_counter()
            a, f, job = measure(run.traced, min(seconds, TRACE_SECONDS), bench, seed, job, kept,
                                sync, False, cuda)
            t_window = time.perf_counter() - t0
        attempted, failed = attempted + a, failed + f
        run.traced.trace = box[0] if box else None
        if run.traced.trace is not None:
            run.traced.trace.window_ns = int(t_window * 1e9)
        log_window("traced", run.traced)
        if run.main.iterations and run.traced.iterations:
            log(f"traced window: {1e3 * t_window / run.traced.iterations:.4f} ms an iteration "
                f"against {1e3 * run.main.window_s / run.main.iterations:.4f} untraced "
                f"(x {t_window / run.traced.iterations / (run.main.window_s / run.main.iterations):.4f})")
    gc.unfreeze()
    for undo in run.undo:
        undo()
    done = len(run.main.jobs)
    log(f"window: {attempted} jobs attempted, {done + len(run.traced.jobs)} completed, {failed} "
        f"failed; set-up {setup_s:.4f} s, build {bench.build_s:.4f} s")

    metrics = {}
    if trace:
        for m in cell.metrics:
            value = cell.readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif done:
        e2e = {"solve_s": run.main.window_s / done, "build_s": bench.build_s,
               "peak_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell.metrics:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info(device, chips, peak)}
    if trace and run.traced.trace is not None:
        result["device"]["busy_s"] = run.traced.trace.busy_ns() / 1e9
        result["device"]["window_s"] = run.traced.trace.window_ns / 1e9
        result["breakdown"] = run.traced.trace.breakdown()
    run.traced.trace = None

    # the check: after the window, with the peak read and the program's state freed
    bench.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    pairs = [(job, bench.inputs(seed, job), out) for job, out in sorted(kept.items,
                                                                          key=lambda kv: kv[0])]
    checks = cell.reference.check(bench.reference_data(), pairs, cell.cfg, cell.traffic, device)
    log(f"reference check of jobs {[p[0] for p in pairs]}: {time.perf_counter() - t_ref:.4f} s")
    ok = bool(pairs) and all(value <= limit for _, value, limit in checks)
    result["correct"] = ok and failed == 0
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    lines = [f"check {n}: {v!r} (limit {lim!r})" for n, v, lim in checks]
    if not pairs:
        lines.append("check jobs_completed: 0 (limit: at least 1)")
    return result, lines


def device_info(device, chips, peak):
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
