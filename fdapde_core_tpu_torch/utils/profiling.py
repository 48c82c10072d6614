"""Tracing / profiling helpers.

Port of ``fdapde_core_tpu/utils/profiling.py`` (fdaPDE-core has no timers
or counters), with a span recorder of the port's own:

- `timer(...)`: wall-clock context manager accumulating into a dict; it
  synchronizes the devices of the tensors in ``sync`` before it reads the
  clock (JAX blocks on its arrays),
- `span(name, value=None)`: a named span around one layer's work. The
  program opens spans at its layer boundaries (the model's entry points,
  the Krylov loop, the preconditioner and its V-cycle levels, the basis
  evaluation, the set-up stages). They are off by default: a disabled
  ``span`` tests one module flag and returns a shared no-op, reading no
  clock and allocating nothing. Between `start_recording()` and
  `stop_recording()` (or inside `recording()`) each span is kept in memory
  as a `SpanRecord` until `take_records()`. A span never synchronizes,
  launches or reads the device: its times are the host's, on the clock of
  ``torch.profiler``'s events, so a profile of the same block places
  kernel launches inside the spans that issued them,
- `xprof_trace(dir)`: a ``torch.profiler`` trace of the enclosed block,
  CUDA activity included where a card is present, exported into ``dir``
  as one Chrome trace (view it in Perfetto or TensorBoard) with the
  program's spans on a track of their own. This is the operator's view of
  where a call's time goes: the card's tracer records every kernel launch
  of the process, the ctypes launches of ``csrc/`` among them, and the
  spans name the layer that issued each one.

The recorder keeps one stack of open spans for the process: spans are
recorded from the thread that runs the program.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch

from .sanitize import _tree

__all__ = ["SpanRecord", "is_recording", "recording", "span", "start_recording",
           "stop_recording", "take_records", "timer", "xprof_trace"]


@contextmanager
def timer(name: str, store: dict | None = None, sync=None):
    """Time a block; `sync`: a tensor, or nested lists/tuples/dicts of
    them, whose devices are synchronized before the clock is read."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        devices = {t.device for _, t in _tree(sync)
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        for device in devices:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if store is not None:
            store[name] = store.get(name, 0.0) + dt


# -- spans -------------------------------------------------------------------

class SpanRecord(NamedTuple):
    """One recorded span. ``parent`` is the index of the enclosing span in
    the same take (None for a root); ``root`` the index of its root, which
    groups the spans of one call of an entry point; ``value`` one small
    integer given at the boundary (iterations, a level, points) or None.
    Times are nanoseconds on the profiler's (Unix-epoch) clock."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    root: int
    value: int | None


_recording = False
_offset_ns = 0  # added to perf_counter_ns() to read on the profiler's clock
_open = []  # indices into _spans of the open spans, innermost last
_spans = []  # [_Span] in the order they started


class _NoSpan:
    """The shared span of a disabled recorder: does nothing, and takes a
    ``value`` without keeping it. Its enter and exit are static: a bound
    method pair costs about twice as much under ``with``."""

    __slots__ = ()
    __enter__ = staticmethod(lambda: _NO_SPAN)
    __exit__ = staticmethod(lambda *exc: False)

    @property
    def value(self):
        return None

    @value.setter
    def value(self, v):
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "value", "start_ns", "end_ns", "parent", "root")

    def __init__(self, name, value):
        self.name = name
        self.value = value

    def __enter__(self):
        index = len(_spans)
        if _open:
            self.parent = _open[-1]
            self.root = _spans[self.parent].root
        else:
            self.parent = None
            self.root = index
        _spans.append(self)
        _open.append(index)
        self.end_ns = None
        self.start_ns = time.perf_counter_ns() + _offset_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns() + _offset_ns
        if _open:  # a restart inside the span cleared the stack
            _open.pop()
        return False


def span(name: str, value: int | None = None):
    """A context manager around one layer's work, recorded while recording
    is on. ``value`` (a Python int, never a device value) may also be set
    on the object ``with`` binds, before the block ends."""
    if not _recording:
        return _NO_SPAN
    return _Span(name, value)


def start_recording():
    """Record spans from now on, dropping any not taken. The clock offset
    is fixed here: the profiler's events read Unix-epoch nanoseconds."""
    global _recording, _offset_ns
    _spans.clear()
    _open.clear()
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _recording = True


def stop_recording():
    """Stop recording; what was recorded stays until `take_records()`."""
    global _recording
    _recording = False


def take_records() -> list:
    """The spans recorded since recording started (or the last take), as
    `SpanRecord`s in the order they started, and forget them. Take them
    outside any open span: a span still open has no end (``end_ns`` None)."""
    out = [SpanRecord(s.name, s.start_ns, s.end_ns, s.parent, s.root, s.value) for s in _spans]
    _spans.clear()
    return out


def is_recording() -> bool:
    return _recording


@contextmanager
def recording():
    """Record the spans of the block; yields a list that holds its
    `SpanRecord`s once the block has ended."""
    out = []
    start_recording()
    try:
        yield out
    finally:
        stop_recording()
        out.extend(take_records())


@contextmanager
def xprof_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into `log_dir`
    (one ``*.pt.trace.json`` file), the program's spans of the block on a
    track named "program spans" beside the profiler's host and device
    tracks, on the same clock."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with recording() as spans:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"{os.uname().nodename}_{os.getpid()}."
                                 f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(_chrome_events(spans, trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)


_SPAN_TRACK = 2**31 - 1  # the spans' thread id in a Chrome trace: above any Linux thread id


def _chrome_events(spans, base_ns):
    """Chrome trace events of ``spans`` ("X" events, microseconds after
    ``base_ns``, as the profiler writes its own) on a track of their own."""
    pid, tid = os.getpid(), _SPAN_TRACK
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "program spans"}}]
    for s in spans:
        if s.end_ns is None:
            continue
        args = {} if s.value is None else {"value": s.value}
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": tid,
                    "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": args})
    return out
