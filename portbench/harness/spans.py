"""The program's own spans (``fdapde_core_tpu_torch.utils.profiling``) for
the per-layer metrics that read them: when to record them, and how to
reduce them.

The program opens spans at its layer boundaries; they cost one flag test
each while recording is off. This module turns recording on and off for
the windows of a ``--trace 1`` run and keeps what was recorded on the run,
in ``run.program_spans`` ("setup", "main" and "traced": lists of the
program's span records, times on the profiler's clock):

- set-up: the ``build.*`` metrics read the constructors' spans, and the
  runner builds the program before it installs any instrument (its
  ``Cell`` loads the metric readers, then the configuration's ``Bench``
  builds, then the main window's instruments are installed). So those
  readers call ``record_setup()`` when the ``Cell`` loads them, and the
  first ``install`` keeps the set-up's records;
- the untraced main window: ``install`` records from its start to the end
  of the run. The metrics of time read this window, where no profiler
  slows the host; a span costs a few microseconds there (``PERF.md``);
- the traced window: the counts that need the profile (launches inside a
  span) read its spans. The first undo, after both windows, stops
  recording and splits the records at the traced window's first profiled
  event: every span of the main window has ended before the profiler
  starts.

A ``--trace 0`` run loads no reader, so the program records nothing there
and the end-to-end metrics are taken with recording off. On a program
without the recorder (an older commit) nothing is recorded and the
readers return None.
"""

from __future__ import annotations

import bisect
import importlib
import statistics
import sys

PROFILING = "fdapde_core_tpu_torch.utils.profiling"
# runtime calls that launch a kernel (CUDA runtime and driver API)
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
# the roots a job's user call opens, in either configuration
DRIVER_ROOTS = ("regression.fit", "regression.gcv", "matfree.solve", "matfree.load_vector")


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        mod = importlib.import_module(PROFILING)
    except ImportError:
        return None
    if not all(hasattr(mod, n) for n in ("start_recording", "stop_recording", "take_records",
                                         "is_recording")):
        return None
    return mod


def _store(run):
    store = getattr(run, "program_spans", None)
    if store is None:
        store = run.program_spans = {}
    return store


def _loaded_by_cell():
    """Whether the caller runs inside the runner's ``Cell`` construction."""
    from . import runner

    code = runner.Cell.__init__.__code__
    frame = sys._getframe(1)
    while frame is not None and frame.f_code is not code:
        frame = frame.f_back
    return frame is not None


def record_setup():
    """Record the set-up's spans from now until the first ``install``,
    where the runner's ``Cell`` loads the calling reader: a reader loaded
    anywhere else (a test, a listing) leaves the recorder as it is."""
    rec = recorder()
    if rec is not None and not rec.is_recording() and _loaded_by_cell():
        rec.start_recording()


def install(run):
    """Keep the set-up's records and record from here (the main window's
    start) to the end of the run, once per run. The undo is the first
    installer's: it stops recording and splits the records between the two
    windows."""
    store = _store(run)
    if "main" in store:
        return lambda: None
    store["setup"], store["main"], store["traced"] = [], [], []
    rec = recorder()
    if rec is None:
        return lambda: None
    if rec.is_recording():
        rec.stop_recording()
        store["setup"] = rec.take_records()
    rec.start_recording()

    def undo():
        rec.stop_recording()
        store["main"], store["traced"] = split(rec.take_records(), run.traced.trace)

    return undo


def split(recs, trace):
    """(the main window's records, the traced window's) of one recording
    over both windows. The records run in the order they started, each
    root before its spans; the main window's roots have all ended before
    the traced window's first profiled event, and each root of the traced
    window holds some of its profiled work, so the traced window starts at
    the first root that ends after that event. Without a profile of the
    traced window the two cannot be told apart, and both are empty."""
    events = [] if trace is None else trace.device + trace.host
    if not events:
        return [], []
    t0 = min(s for s, _, _ in events)
    n = next((i for i, r in enumerate(recs)
              if r.parent is None and (r.end_ns is None or r.end_ns >= t0)), len(recs))
    # the traced window's parents and roots, as indices into its own list
    traced = [r._replace(parent=None if r.parent is None else r.parent - n, root=r.root - n)
              for r in recs[n:]]
    return recs[:n], traced


def setup_spans(run):
    return _store(run).get("setup") or []


def main_spans(run):
    return _store(run).get("main") or []


def traced_spans(run):
    return _store(run).get("traced") or []


def seconds(rec):
    return (rec.end_ns - rec.start_ns) / 1e9


def named(recs, names):
    """The records named in ``names``."""
    return [r for r in recs if r.name in names and r.end_ns is not None]


def outermost(recs, names):
    """Indices of the records named in ``names`` that no other such record
    encloses."""
    inside = [False] * len(recs)
    out = []
    for i, r in enumerate(recs):
        p = r.parent
        if p is not None:
            inside[i] = inside[p] or recs[p].name in names
        if r.name in names and not inside[i] and r.end_ns is not None:
            out.append(i)
    return out


def within(recs, tops, names):
    """Indices of the outermost records named in ``names`` under any of the
    records ``tops`` (indices): a record inside another such one is part of
    it."""
    top = set(tops)
    under = [False] * len(recs)
    for i, r in enumerate(recs):
        p = r.parent
        if p is not None:
            under[i] = under[p] or p in top
    return [i for i in outermost(recs, names) if under[i]]


def solve_iterations(recs):
    """(outermost ``krylov.solve`` indices, their iterations)."""
    solves = outermost(recs, ("krylov.solve",))
    return solves, sum(recs[i].value or 0 for i in solves)


def launch_starts(trace):
    """Sorted start times of the kernel-launch runtime calls in the traced
    window's host events, a driver-API call inside a runtime call counted
    once."""
    if trace is None:
        return []
    calls = sorted((s, e) for s, e, name in trace.host if name.startswith(LAUNCH_PREFIXES))
    out, last_end = [], -1
    for s, e in calls:
        if s >= last_end:
            out.append(s)
            last_end = e
    return out


def count_inside(starts, recs):
    """Launches (sorted ``starts``) inside the spans ``recs``; the spans of
    one name and value do not overlap, so none is counted twice."""
    return sum(bisect.bisect_right(starts, r.end_ns) - bisect.bisect_left(starts, r.start_ns)
               for r in recs)


def covered(starts, recs):
    """Launches inside at least one of ``recs`` (the union of the spans)."""
    merged = []
    for s, e in sorted((r.start_ns, r.end_ns) for r in recs if r.end_ns is not None):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s) for s, e in merged)


def build_median(run, name, repeats):
    """The median seconds of span ``name`` over the last ``repeats`` of the
    set-up (the timed builds, which follow the small build), or None."""
    recs = [r for r in setup_spans(run) if r.name == name and r.end_ns is not None]
    if len(recs) < repeats:
        return None
    return statistics.median(seconds(r) for r in recs[-repeats:])
