"""The profiler over the traced window, and its reduction to what the
per-layer metrics read.

On a card the profiler records CUDA activity alone: the device's kernels,
copies and sets, and the host's CUDA runtime calls. The host's operators
are not recorded, so the host runs near its untraced speed (a traced run
logs the ratio of its traced to its untraced time an iteration). Busy time
is the union of the device's activity intervals, not their sum, so
overlapping work is counted once; the window's length is the traced
block's on the host's clock, set by the caller.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# runtime calls on which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
GAP_FLOOR_NS = 20_000  # idle gaps shorter than this are not named in the breakdown
GAPS_NAMED = 2_000  # at most this many of the longest gaps are named


class Trace:
    """The traced window's events, reduced.

    device: [(start_ns, end_ns, name)] of the device's activities in the
    window; host: [(start_ns, end_ns, name)] of the host's events in it
    (CUDA runtime calls on a card, operators on the CPU); window_ns: the
    window's length."""

    def __init__(self, device, host, window_ns):
        self.device = device
        self.host = host
        self.window_ns = window_ns

    @property
    def kernels(self):
        return [e for e in self.device if not e[2].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self):
        merged = []
        for s, e, _ in sorted(self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_ns(self):
        return sum(e - s for s, e in self.busy_intervals())

    def device_seconds_by_name(self):
        out = {}
        for s, e, name in self.device:
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out

    def host_syncs(self):
        return sum(1 for _, _, name in self.host if name in SYNC_CALLS)

    def idle_gaps(self):
        """(seconds, what the host was doing) of each idle gap of the
        device, the longest first: the innermost host event that spans the
        gap's middle ("host in ..."), else the last one the host had
        returned from before it ("host after ...": the host ran its own
        code, the program's Python, from there)."""
        busy = self.busy_intervals()
        if not busy:
            return []
        gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                for i in range(len(busy) - 1)]
        gaps = sorted((g for g in gaps if g[0] >= GAP_FLOOR_NS), reverse=True)[:GAPS_NAMED]
        host = sorted(self.host)
        starts = [h[0] for h in host]
        out = []
        for length, s, e in gaps:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            name, best, last, last_end = None, None, None, -1
            for j in range(i - 1, max(-1, i - 400), -1):
                hs, he, hn = host[j]
                if he >= mid and (best is None or he - hs < best):
                    name, best = hn, he - hs
                elif last_end < he < mid:
                    last, last_end = hn, he
            if name is not None:
                name = f"host in {name}"
            else:
                name = f"host after {last}" if last else "host: no host event before it"
            out.append((length / 1e9, name))
        return out

    def breakdown(self, top=10):
        ops = sorted(self.device_seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
        by_host = {}
        for sec, name in self.idle_gaps():
            by_host[name] = by_host.get(name, 0.0) + sec
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _ns(ev):
    return ev.start_ns(), ev.start_ns() + ev.duration_ns()


@contextlib.contextmanager
def traced(device):
    """Profile the block: CUDA activity alone on a card, the host's
    operators on the CPU. Yields a one-element list that holds the
    ``Trace`` once the block has ended; its ``window_ns`` is the span of
    its events until the caller sets the block's length."""
    acts = [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [ProfilerActivity.CPU]
    box = []
    with profile(activities=acts) as prof:
        yield box
        t_stop = time.perf_counter()
    t_events = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for ev in events:
        (host if ev.device_type() == DeviceType.CPU else dev).append((*_ns(ev), ev.name()))
    ends = [e for _, e, _ in dev + host]
    window = max(ends) - min(s for s, _, _ in dev + host) if ends else 0
    box.append(Trace(dev, host, window))
    print(f"trace: profiler stopped in {t_events - t_stop:.2f} s, {len(events)} events read "
          f"and reduced in {time.perf_counter() - t_events:.2f} s", file=sys.stderr, flush=True)
