"""Closed-form P1 local stiffness of the 2D Laplacian: kernels K4, K5, K6.

Port of ``fdapde_core_tpu/ops/pallas_assembly.py`` ``p1_stiffness_2d``
(K6), ``p1_stiffness_edges`` (K4) and ``p1_stiffness_edges_offdiag`` (K5).
For a cell with b = (y2-y3, y3-y1, y1-y2), c = (x3-x2, x1-x3, x2-x1),

    A = (b b^T + c c^T) / (4 area),

the local matrix of the positive form int grad.grad (for P1 the quadrature
of ``fem/assembler.local_matrices`` gives the same matrix).

- ``p1_stiffness_2d(coords_t)``: (6, ...) rows x1, y1, x2, y2, x3, y3 ->
  (9, ...) row-major 3x3 entries. ``fem/assembler.local_matrices`` takes it
  for the Laplacian term of a 2D P1 space.
- ``p1_stiffness_edges(edges, eps=None)``: (4, ...) edge vectors
  (ux, uy, vx, vy) = (p2 - p1, p3 - p1) -> (6, ...) packed
  [a11, a12, a13, a22, a23, a33] (expand with ``closed_form.SYM_TO_FULL``);
  eps is added to ux, as in the JAX function.
- ``p1_stiffness_edges_offdiag(edges, eps=None)``: the same input ->
  (3, ...) [a12, a13, a23], valid for Laplacian and diffusion forms only
  (rows sum to zero, so the diagonal follows from these).

Each wrapper launches the hand-written kernel ``csrc/p1_local_stiffness.cu``
on a CUDA tensor (built at first use, see ``_build.py``) and counts the
launch in its ``*_launches`` count; on a CPU tensor it runs the plain
PyTorch version beside it (``*_reference``). The JAX functions take the
TPU's padded shapes ((6, C) with C a multiple of 65536, (4, L, 128) with L a
multiple of 1024); these take those shapes and any other trailing cell-axis
shape, unpadded. Degenerate cells give inf, as in JAX.
"""

from __future__ import annotations

import torch

from .closed_form import SYM_TO_FULL, p1_stiffness_2d_sym

__all__ = [
    "p1_stiffness_2d",
    "p1_stiffness_2d_reference",
    "p1_stiffness_edges",
    "p1_stiffness_edges_offdiag",
    "p1_stiffness_edges_offdiag_reference",
    "p1_stiffness_edges_reference",
]

# kernel launches since import (or since a caller last reset them to 0)
p1_stiffness_2d_launches = 0
p1_stiffness_edges_launches = 0
p1_stiffness_edges_offdiag_launches = 0


def p1_stiffness_2d_reference(coords_t):
    """Plain PyTorch version of K6: (6, ...) -> (9, ...)."""
    return p1_stiffness_2d_sym(coords_t)[list(SYM_TO_FULL)]


def p1_stiffness_edges_reference(edges, eps=None):
    """Plain PyTorch version of K4: (4, ...) -> (6, ...) packed. The
    closed form on the cell moved to p1 = 0, which gives the edge form's
    arithmetic operation for operation."""
    ux = edges[0] if eps is None else edges[0] + eps
    zero = torch.zeros_like(ux)
    return p1_stiffness_2d_sym(torch.stack([zero, zero, ux, edges[1], edges[2], edges[3]]))


def p1_stiffness_edges_offdiag_reference(edges, eps=None):
    """Plain PyTorch version of K5: (4, ...) -> (3, ...) [a12, a13, a23]."""
    return p1_stiffness_edges_reference(edges, eps)[[1, 2, 4]]


def _check(t, rows, name):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} must be float32 or float64, got {t.dtype}")
    if t.dim() < 2 or t.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, ...) with a cell axis, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _launch(symbol, inp, out_rows, *scalars):
    """Run ``symbol``_f32/_f64 of the built library on inp's stream into a
    new (out_rows, ...) tensor."""
    from .._build import library

    out = torch.empty((out_rows,) + tuple(inp.shape[1:]), dtype=inp.dtype, device=inp.device)
    suffix = "f32" if inp.dtype == torch.float32 else "f64"
    fn = getattr(library(), f"{symbol}_{suffix}")
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = fn(inp.data_ptr(), out.data_ptr(), inp[0].numel(), *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    return out


def p1_stiffness_2d(coords_t):
    """K6: (6, ...) contiguous float32/float64 vertex coordinates (rows x1,
    y1, x2, y2, x3, y3) -> (9, ...) row-major local stiffness."""
    global p1_stiffness_2d_launches
    _check(coords_t, 6, "coords_t")
    if coords_t.device.type == "cpu":
        return p1_stiffness_2d_reference(coords_t)
    out = _launch("p1_stiffness_2d", coords_t, 9)
    p1_stiffness_2d_launches += 1
    return out


def p1_stiffness_edges(edges, eps=None):
    """K4: (4, ...) contiguous float32/float64 edge vectors (rows ux, uy,
    vx, vy) -> (6, ...) packed [a11, a12, a13, a22, a23, a33]; eps (a
    number, default 0) is added to ux."""
    global p1_stiffness_edges_launches
    _check(edges, 4, "edges")
    if edges.device.type == "cpu":
        return p1_stiffness_edges_reference(edges, eps)
    out = _launch("p1_stiffness_edges", edges, 6, float(eps or 0.0))
    p1_stiffness_edges_launches += 1
    return out


def p1_stiffness_edges_offdiag(edges, eps=None):
    """K5: (4, ...) edge vectors -> (3, ...) [a12, a13, a23] (Laplacian and
    diffusion forms only); eps as in ``p1_stiffness_edges``."""
    global p1_stiffness_edges_offdiag_launches
    _check(edges, 4, "edges")
    if edges.device.type == "cpu":
        return p1_stiffness_edges_offdiag_reference(edges, eps)
    out = _launch("p1_stiffness_edges_offdiag", edges, 3, float(eps or 0.0))
    p1_stiffness_edges_offdiag_launches += 1
    return out
