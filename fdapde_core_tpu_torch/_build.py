"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, which is loaded with ``ctypes``. The
library is cached under ``_build/`` by a hash of the sources and flags, so
an unchanged checkout builds once. A failed build raises with nvcc's output;
there is no fallback. Nothing here runs at import time: CPU-only use of the
package never needs a CUDA toolchain.
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

__all__ = ["library", "build_log"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # per-kernel registers / spills into the build log
)

# C entry points: (name, argtypes); every one returns a cudaError_t as int
_VP, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "p1_stencil_layers_f32": (_VP, _VP, _I64, _I64, _I64, _VP, _I64, _I64, _VP),
    "p1_stencil_layers_f64": (_VP, _VP, _I64, _I64, _I64, _VP, _I64, _I64, _VP),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> Path:
    return _BUILD / f"libfdapde_kernels_{_digest(_sources())}.so"


def build_log() -> str:
    """nvcc's output (ptxas register/spill report) for the current build."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if the cached library is stale, then load it."""
    so = _library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
