"""Native (C++) host-side kernels, built with g++ at first use and bound with
ctypes: the first-encounter hash pass of mesh topology (``topology.cpp``),
FSPAI (``fspai.cpp``) and the reverse Cuthill-McKee ordering of
``parallel/reorder.py`` (``rcm.cpp``). Copies of the JAX package's
sources; the build raises on a failed compile (``build.py``)."""

from .build import get_lib, native_available
from .topology import first_encounter_unique_native

__all__ = ["first_encounter_unique_native", "get_lib", "native_available"]
