"""Python binding of the native first-encounter hash pass (NumPy in/out).

Port of ``fdapde_core_tpu/native/topology.py``; the library raises where
JAX's returns None (see ``build.py``)."""

from __future__ import annotations

import numpy as np

from .build import get_lib

__all__ = ["first_encounter_unique_native"]

# number of first_encounter_unique_native calls since import (a caller may
# reset it to 0): how a run shows the native path was taken
native_calls = 0


def first_encounter_unique_native(keys: np.ndarray):
    """Native first-encounter unique over int32 rows.

    keys: (n, k) rows already normalized (converted to C-contiguous int32).
    Returns (unique_rows, ids) like geometry.triangulation.first_encounter_unique.
    """
    global native_calls
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    n, k = keys.shape
    ids = np.empty(n, dtype=np.int32)
    uniq = np.empty((n, k), dtype=np.int32)
    n_uniq = lib.first_encounter_unique(keys.ctypes.data, n, k, ids.ctypes.data,
                                        uniq.ctypes.data)
    if n_uniq < 0:
        raise RuntimeError("native first_encounter_unique failed")
    native_calls += 1
    return uniq[:n_uniq].copy(), ids
