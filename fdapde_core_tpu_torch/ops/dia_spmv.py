"""Flat DIA SpMV (K7): y[i] = sum_k data[k, i] * x[i + d_k].

Port of ``fdapde_core_tpu/ops/pallas_dia.py`` ``dia_spmv``, the fused form
of ``linear_algebra/dia.DIAMatrix.__matmul__``'s shift-and-add, with x
taken as zero outside [0, n).

- ``dia_spmv(data, offsets, x)`` is the kernel wrapper. On a CUDA tensor it
  launches the hand-written kernel ``csrc/dia_spmv.cu`` (built at first
  use, see ``_build.py``) and counts the launch in ``dia_spmv_launches``;
  on a CPU tensor it runs the plain version ``dia_spmv_reference``.
- The JAX kernel's TPU layout rules are dropped: n need not be a multiple
  of its 65536-row tile, the offsets need not fit a 128-rounded halo of one
  tile, and neither the zero-padded copy of x nor the manual x-window DMA
  exists. Any n and any offsets work (an offset with |d| >= n contributes
  nothing); the ``interpret`` argument is accepted and ignored.
"""

from __future__ import annotations

import torch

__all__ = ["dia_spmv", "dia_spmv_reference"]

# kernel launches since import (or since a caller last reset it to 0)
dia_spmv_launches = 0


def _shift(x, d: int):
    """shifted[i] = x[i + d], zero outside [0, n)."""
    n = x.shape[0]
    if d == 0:
        return x
    if abs(d) >= n:
        return torch.zeros_like(x)
    z = x.new_zeros(abs(d))
    return torch.cat([x[d:], z]) if d > 0 else torch.cat([z, x[:d]])


def dia_spmv_reference(data, offsets, x):
    """Plain PyTorch version: one shifted copy of x per offset, multiplied
    and added in offset order (``DIAMatrix.__matmul__`` of the JAX
    package). ``offsets``: a sequence of ints or an int64 tensor."""
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()
    out = torch.zeros_like(x)
    for k, d in enumerate(offsets):
        out = out + data[k] * _shift(x, int(d))
    return out


def _check(data, offsets, x):
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"data must be float32 or float64, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be (K, n), got shape {tuple(data.shape)}")
    K, n = data.shape
    if x.dim() != 1 or x.shape[0] != n or x.dtype != data.dtype:
        raise ValueError(f"x must be ({n},) {data.dtype}, got {x.dtype} {tuple(x.shape)}")
    if isinstance(offsets, torch.Tensor):
        if offsets.dtype != torch.int64 or offsets.shape != (K,) or offsets.device != data.device:
            raise ValueError(f"offsets must be a ({K},) int64 tensor on {data.device}, got "
                             f"{offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")
    elif len(offsets) != K:
        raise ValueError(f"{len(offsets)} offsets for {K} diagonals")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")
    if x.device != data.device:
        raise ValueError("data and x must share a device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def dia_spmv(data, offsets, x, interpret=None):
    """y = A x for DIA storage: ``data`` (K, n) float32 or float64 with
    data[k, i] = A[i, i + d_k]; ``offsets`` the K offsets d_k, as ints or
    as a (K,) int64 tensor on data's device (``DIAMatrix`` keeps one, so a
    product copies nothing to the card); ``x`` (n,) contiguous, of data's
    dtype. Returns a new (n,) tensor. ``interpret`` is ignored."""
    global dia_spmv_launches
    _check(data, offsets, x)
    K, n = data.shape
    if data.device.type == "cpu":
        return dia_spmv_reference(data, offsets, x)

    from .._build import library

    if not isinstance(offsets, torch.Tensor):
        offsets = torch.tensor([int(d) for d in offsets], dtype=torch.int64).to(data.device)
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    if n == 0:
        return y
    lib = library()
    fn = lib.dia_spmv_f32 if data.dtype == torch.float32 else lib.dia_spmv_f64
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), offsets.data_ptr(), x.data_ptr(), y.data_ptr(), K, n, stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: cudaError {err}")
    dia_spmv_launches += 1
    return y
