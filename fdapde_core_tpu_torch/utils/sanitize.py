"""Numerical sanitization hooks.

Port of ``fdapde_core_tpu/utils/sanitize.py``. fdaPDE-core's only
sanitization is valgrind in CI; the obligations here are checks that a NaN
or an infinity is caught at the operation that makes it:

- `debug_nans()`: a context manager in which every floating output of
  every torch operation is tested for non-finite values, raising
  ``FloatingPointError`` that names the operation (JAX flips
  ``jax_debug_nans``),
- `checked(fn)`: fn run under that test. Torch has no ``checkify``; the
  dispatch mode sees every operation fn runs, inside loops as well, so
  like checkify it catches an intermediate value that fn's output masks,
- `assert_all_finite(tree)`: an eager barrier over nested tensors and
  arrays for host-side call sites (after a solve, before a checkpoint).

Each test reads its result on the host, so on the card every operation
becomes a host sync: a debugging layer, not one to leave on. The mode sees
torch operations only. The package's CUDA kernels (``csrc/``) are ctypes
launches that write into tensors allocated beforehand, so a non-finite
value that a kernel makes is caught at the first torch operation whose
output carries it, not at the kernel, and not at all if that operation
masks it (on CPU tensors the kernels' plain torch versions run, and are
checked op by op). Allocations (``empty`` and its kind) are not tested:
their memory is not yet written.

Solver-level guards live in linear_algebra/solvers.py (residual isfinite
checks mark converged=False instead of looping forever); these utilities
are the debugging layer above them.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["debug_nans", "checked", "assert_all_finite"]

_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _tree(tree, path=""):
    """(path, leaf) pairs of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree(v, f"{path}[{i}]")
    else:
        yield path, tree


class _NonFiniteCheck(TorchDispatchMode):
    """Raises at the first operation with a non-finite floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNWRITTEN:
            return out
        for path, t in _tree(out):
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()):
                if not bool(torch.isfinite(t).all()):
                    what = "nan" if bool(torch.isnan(t).any()) else "inf"
                    raise FloatingPointError(f"{what} in the output{path} of {func}")
        return out


@contextmanager
def debug_nans(enable: bool = True):
    """Scoped non-finite check of every torch operation (see the module)."""
    if not enable:
        yield
        return
    with _NonFiniteCheck():
        yield


def checked(fn):
    """A version of `fn` that raises FloatingPointError on a NaN or an
    infinity made anywhere in its body, loops included."""

    def wrapper(*args, **kwargs):
        with _NonFiniteCheck():
            return fn(*args, **kwargs)

    return wrapper


def assert_all_finite(tree, name: str = "value"):
    """Raise FloatingPointError if any floating leaf (a tensor or a NumPy
    array) has NaN/inf; returns the tree unchanged (usable as a
    pass-through barrier)."""
    for path, leaf in _tree(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        else:
            bad = (isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating)
                   and not np.isfinite(leaf).all())
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")
    return tree
