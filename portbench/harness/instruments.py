"""Instruments the benchmark installs around the program at run time:
wrappers from the benchmark's own files, never changes to the program.

``replace_everywhere`` swaps a function of the program for a wrapper in
every module of the program that holds it (a name imported with ``from
... import`` is a binding of its own in the importing module), and returns
the undo. The wrappers record into a ``Recorder`` that the run owns.
"""

from __future__ import annotations

import functools
import sys
import time
import weakref

import torch

PROGRAM = "fdapde_core_tpu_torch"


def replace_everywhere(orig, new, package=PROGRAM):
    """Bind ``new`` in place of ``orig`` in every loaded module of
    ``package`` that holds ``orig`` under some name. Returns a callable that
    puts ``orig`` back."""
    swapped = []
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != package:
            continue
        for attr, val in list(vars(mod).items()):
            if val is orig:
                setattr(mod, attr, new)
                swapped.append((mod, attr))

    def undo():
        for mod, attr in swapped:
            setattr(mod, attr, orig)

    if not swapped:
        raise RuntimeError(f"{getattr(orig, '__name__', orig)} is bound in no module of {package}")
    return undo


class Recorder:
    """What the instruments see: named spans (host seconds) and per-launch
    records, into the dicts of the window being measured (the runner
    points ``spans`` and ``launches`` at them)."""

    def __init__(self, sync):
        self.sync = sync  # called at both ends of a span (the device's synchronize)
        self.spans = {}
        self.launches = {}

    def span(self, name, fn):
        """fn wrapped so that each call adds its host seconds, from a
        synchronised start to a synchronised end, to span ``name``."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                self.spans.setdefault(name, []).append(time.perf_counter() - t0)

        return wrapped


class TableEntries:
    """Stored entries of each table a launch reads, counted once per table
    on the device (no host read) and kept only while the table lives."""

    def __init__(self):
        self._seen = {}

    def get(self, table, count):
        key = id(table)
        hit = self._seen.get(key)
        if hit is not None and hit[0]() is table:
            return hit[1]
        entries = count()
        self._seen[key] = (weakref.ref(table), entries)
        return entries


def install_k2_recorder(rec: Recorder):
    """Record, for every launch of K2's two forms, the bytes its byte model
    counts (``metrics/k2_bytes.py``), in ``rec.launches["k2"]`` as (entries,
    a 0-d tensor or an int; the other bytes, an int). Returns the undo."""
    import importlib

    from portbench.metrics.k2_bytes import COL_BYTES, compact_entries, launch_bytes

    gs = importlib.import_module(f"{PROGRAM}.ops.gather_spmv")
    orig_compact, orig_sliced = gs.ell_spmv, gs.sliced_ell_spmm
    tables = TableEntries()

    @functools.wraps(orig_compact)
    def compact(vals, cols, x, warp_w=None):
        y = orig_compact(vals, cols, x, warp_w)
        K, n = vals.shape
        entries = tables.get(vals, lambda: compact_entries(vals, cols, x.shape[0]))
        rec.launches.setdefault("k2", []).append((entries, vals.element_size() + COL_BYTES,
                    launch_bytes(0, 0, n, x.shape[0], x.element_size(), y.element_size())))
        return y

    @functools.wraps(orig_sliced)
    def sliced(A, X, backward=False):
        Y = orig_sliced(A, X, backward)
        k = 1 if X.dim() == 1 else X.shape[1]
        rec.launches.setdefault("k2", []).append((A.dest.shape[0], A.vals.element_size() + COL_BYTES,
                    launch_bytes(0, 0, A.shape[0], A.shape[1], X.element_size(),
                                 Y.element_size(), k)))
        return Y

    undo = [replace_everywhere(orig_compact, compact), replace_everywhere(orig_sliced, sliced)]
    return lambda: [u() for u in undo]


def k2_bytes(launches):
    """Total bytes of the K2 launches recorded in a window's ``launches``
    (reads the device counts)."""
    total, per_table = 0, {}
    for entries, entry_bytes, rest in launches.get("k2", []):
        total += rest
        if isinstance(entries, int):
            total += entries * entry_bytes
        else:  # one device count per table: read it once
            _, _, launches = per_table.get(id(entries), (None, 0, 0))
            per_table[id(entries)] = (entries, entry_bytes, launches + 1)
    for entries, entry_bytes, launches in per_table.values():
        total += int(entries) * entry_bytes * launches
    return total


def install_span(rec: Recorder, module: str, name: str, span: str):
    """A span named ``span`` around the program's ``module.name``, wherever
    it is bound. Returns the undo."""
    import importlib

    orig = getattr(importlib.import_module(module), name)
    return replace_everywhere(orig, rec.span(span, orig))


def device_sync(device):
    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
