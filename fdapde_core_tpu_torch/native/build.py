"""Build and load the native host library (``topology.cpp``, ``fspai.cpp``,
``rcm.cpp``) at first use.

Port of ``fdapde_core_tpu/native/build.py``: one ``g++ -O3 -fPIC -shared
-std=c++17`` over the sources into ``fdapde_core_tpu_torch/_build/``, cached
by a hash of the sources and flags (as ``_build.py`` caches the CUDA
kernels), loaded with ``ctypes``. Differences from the JAX module:

- a failed compile raises with g++'s output, where JAX turns every failure
  into "unavailable" and silently takes the NumPy paths;
- ``native_available()`` is False only when no ``g++`` is on ``PATH``.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["get_lib", "native_available"]

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE.parent / "_build"
_SOURCES = ("topology.cpp", "fspai.cpp", "rcm.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_VP, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "first_encounter_unique": (_I64, (_VP, _I64, _I32, _VP, _VP)),
    "sort_rows": (None, (_VP, _I64, _I32)),
    # indptr (int64), indices (int32), values (f64), n, alpha, beta,
    # epsilon, rows_out, cols_out, vals_out
    "fspai_csr": (_I64, (_VP, _VP, _VP, _I64, _I32, _I32, _F64, _VP, _VP, _VP)),
    # indptr (int64), indices (int64), n, perm_out (int64)
    "rcm_order": (_I64, (_VP, _VP, _I64, _VP)),
}


def native_available() -> bool:
    """Whether the native library can be built here: a ``g++`` on PATH."""
    return shutil.which("g++") is not None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    return _BUILD / f"libfdapde_native_{h.hexdigest()[:16]}.so"


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library, compiled first if the cached one is stale.
    Raises RuntimeError when g++ is missing or the compile fails."""
    so = _library_path()
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH: the native library cannot be built")
        _BUILD.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
            out = Path(tmpdir) / "lib.so"
            cmd = [cxx, *CXX_FLAGS, *(str(_HERE / s) for s in _SOURCES), "-o", str(out)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            # a private name, then a rename: concurrent builds never load
            # a half-written library
            os.replace(out, so)
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib
