"""Tracing / profiling helpers.

Port of ``fdapde_core_tpu/utils/profiling.py`` (fdaPDE-core has no timers
or counters):

- `timer(...)`: wall-clock context manager accumulating into a dict; it
  synchronizes the devices of the tensors in ``sync`` before it reads the
  clock (JAX blocks on its arrays),
- `xprof_trace(dir)`: a ``torch.profiler`` trace of the enclosed block,
  CUDA activity included where a card is present, exported into ``dir``
  as a Chrome trace (view it in Perfetto or TensorBoard). The card's
  tracer records every kernel launch of the process, the ctypes launches
  of ``csrc/`` among them,
- `flops_bandwidth(...)`: achieved-rate report helper for kernels.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from .sanitize import _tree

__all__ = ["timer", "xprof_trace", "flops_bandwidth"]


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


@contextmanager
def xprof_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into `log_dir`
    (one ``*.pt.trace.json`` file)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def flops_bandwidth(seconds: float, flops: float = 0.0, bytes_moved: float = 0.0) -> dict:
    """Achieved rates for a measured kernel execution."""
    out = {"seconds": seconds}
    if flops:
        out["gflops_per_s"] = flops / seconds / 1e9
    if bytes_moved:
        out["gbytes_per_s"] = bytes_moved / seconds / 1e9
    return out
