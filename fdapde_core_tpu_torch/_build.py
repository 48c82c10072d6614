"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with its own ``nvcc`` for Hopper (``sm_90a``), all of
them started together, and the objects link into one shared library with a
plain C interface, which is loaded with ``ctypes``. The library is cached
under ``_build/`` by a hash of the sources and flags, so an unchanged
checkout builds once. A failed build raises with nvcc's output; there is no
fallback. Nothing here runs at import time: CPU-only use of the package
never needs a CUDA toolchain.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # per-kernel registers / spills into the build log
)

# C entry points: (name, argtypes); every one returns a cudaError_t as int
_VP, _I64, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    "p1_stencil_layers_f32": (_VP, _VP, _I64, _I64, _I64, _VP, _I64, _I64, _VP),
    "p1_stencil_layers_f64": (_VP, _VP, _I64, _I64, _I64, _VP, _I64, _I64, _VP),
    "p1_offdiag_planes_f32": (_VP, _VP, _I64, _I64, _I64, _VP, _VP),
    "p1_offdiag_planes_f64": (_VP, _VP, _I64, _I64, _I64, _VP, _VP),
    "dia_spmv_f32": (_VP, _VP, _VP, _VP, _I64, _I64, _VP),
    "dia_spmv_f64": (_VP, _VP, _VP, _VP, _I64, _I64, _VP),
    "ell_spmv_f32": (_VP, _VP, _VP, _VP, _VP, _I64, _I64, _VP),
    "ell_spmv_f64": (_VP, _VP, _VP, _VP, _VP, _I64, _I64, _VP),
    "ell_spmv_bf16": (_VP, _VP, _VP, _VP, _VP, _I64, _I64, _VP),
    "ell_spmv_f32_f64": (_VP, _VP, _VP, _VP, _VP, _I64, _I64, _VP),
    "sell_spmm_f32": (_VP, _VP, _VP, _VP, _VP, _I64, _VP, _I64, _I64, _VP, _I64, _I64, _I64, _VP),
    "sell_spmm_f64": (_VP, _VP, _VP, _VP, _VP, _I64, _VP, _I64, _I64, _VP, _I64, _I64, _I64, _VP),
    "p1_stiffness_2d_f32": (_VP, _VP, _I64, _VP),
    "p1_stiffness_2d_f64": (_VP, _VP, _I64, _VP),
    "p1_stiffness_edges_f32": (_VP, _VP, _I64, _F64, _VP),
    "p1_stiffness_edges_f64": (_VP, _VP, _I64, _F64, _VP),
    "p1_stiffness_edges_offdiag_f32": (_VP, _VP, _I64, _F64, _VP),
    "p1_stiffness_edges_offdiag_f64": (_VP, _VP, _I64, _F64, _VP),
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


def _run(cmd: list[str], proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return out


def _compile_and_link(tmpdir: Path) -> str:
    """One nvcc per source, all running at once, then one link into
    ``tmpdir/lib.so``. Returns the compilers' combined output."""
    nvcc = _nvcc()
    jobs = []
    try:
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmpdir / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [_run(cmd, proc) for cmd, proc in jobs]
    finally:
        for _, proc in jobs:  # a failed job must not leave the others running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    objects = [str(tmpdir / f"{src.stem}.o") for src in _sources()]
    cmd = [nvcc, "-shared", "-o", str(tmpdir / "lib.so"), *objects]
    logs.append(_run(cmd, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if the cached library is stale, then load it."""
    so = _library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
            log = _compile_and_link(Path(tmpdir))
            so.with_suffix(".log").write_text(log)
            # link to a private name, then rename: concurrent builders
            # never load a half-written library
            os.replace(Path(tmpdir) / "lib.so", so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
