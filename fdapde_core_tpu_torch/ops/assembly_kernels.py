"""Fused coords -> stencil-layer assembly of the P1 -laplacian (2D).

Port of ``fdapde_core_tpu/ops/pallas_assembly.py``
``p1_stencil_layers_from_coords``: from node coordinate planes X, Y (node
(i, j) at row i, column j) straight to the 7 layers of the global P1
stencil, in ``grid_assembly.GRID_OFFSETS2D`` order, in one pass.

- ``p1_stencil_layers_into`` is the kernel wrapper. On a CUDA tensor it
  launches the hand-written kernel ``csrc/p1_stencil.cu`` (built at first
  use, see ``_build.py``) and counts the launch in ``p1_stencil_launches``;
  on a CPU tensor it runs the plain version. It writes into a caller-given
  (7, n+1, n+1) view with a unit last stride, so one launch serves both the
  compact layers of ``grid_assembly.stencil_from_coords`` and the padded
  layout below.
- ``p1_stencil_layers_from_coords`` keeps the JAX function's padded return,
  (7, n+16, W) with node row I at row I+7 and zeros elsewhere, so tests
  compare the two element for element.
- ``p1_stencil_layers_from_coords_reference`` is the plain PyTorch version,
  written the way the JAX function's non-TPU branch is.
- ``p1_offdiag_planes_from_coords`` (K3, port of the JAX module's
  ``p1_offdiag_planes_from_coords``) stops at the assembly's first stage,
  the six off-diagonal planes; it launches the second entry point of
  ``csrc/p1_stencil.cu`` (count ``p1_offdiag_planes_launches``), beside its
  plain version ``p1_offdiag_planes_from_coords_reference``.
"""

from __future__ import annotations

import torch

__all__ = [
    "p1_offdiag_planes_from_coords",
    "p1_offdiag_planes_from_coords_reference",
    "p1_stencil_layers_from_coords",
    "p1_stencil_layers_from_coords_reference",
    "p1_stencil_layers_into",
]

# kernel launches since import (or since a caller last reset them to 0)
p1_stencil_launches = 0
p1_offdiag_planes_launches = 0

# layer stack order must match grid_assembly.GRID_OFFSETS2D
_LAYER_ORDER = ((-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0))

_BLOCK = (128, 2)  # threads per block in csrc/p1_stencil.cu (columns, rows)


def _coords_offdiag_planes(x0, y0, xs, ys, lane_roll):
    """Off-diagonal planes for triangle types A and B from coordinate rows.

    x0/y0: coordinate rows r; xs/ys: rows r+1. lane_roll(a) must produce
    a[:, j] <- a[:, j+1]. Returns (a12, a13, a23, b12, b13, b23).
    """
    rx = lane_roll(x0) - x0  # right edge at row r
    ry = lane_roll(y0) - y0
    dx = xs - x0  # down edge
    dy = ys - y0
    rxn = lane_roll(xs) - xs  # right edge at row r+1
    ryn = lane_roll(ys) - ys

    def offdiag(ux, uy, vx, vy):
        det = ux * vy - vx * uy
        # zero dets (degenerate or junk cells) give 0, not inf: the masking
        # below multiplies by 0 and inf * 0 = NaN
        inv = torch.where(det != 0, 1.0 / (2.0 * torch.abs(det)), 0.0)
        b1, b2, b3 = uy - vy, vy, -uy
        c1, c2, c3 = vx - ux, -vx, ux
        return (
            (b1 * b2 + c1 * c2) * inv,
            (b1 * b3 + c1 * c3) * inv,
            (b2 * b3 + c2 * c3) * inv,
        )

    a = offdiag(dx, dy, rx, ry)  # type A (a, b, a+1): u = down, v = right
    b = offdiag(rxn, ryn, rx - dx, ry - dy)  # type B (b, b+1, a+1)
    return a + b


def _stencil_rows_from_planes(planes, rshift):
    """7 stencil-layer rows for node rows [0, R) from 6 off-diagonal planes
    over zero-bordered quad rows [-1, R).

    rshift(p) must produce p[:, j] <- p[:, j-1] with column 0 receiving a
    zero. Returns layers in _LAYER_ORDER (sums as grid_assembly.
    _LAYER_SOURCES states them).
    """
    pa12, pa13, pa23, pb12, pb13, pb23 = planes
    L10 = pa12[1:] + rshift(pb23)[1:]
    Lm10 = pa12[:-1] + rshift(pb23)[:-1]
    L01 = pa13[1:] + pb12[:-1]
    L0m1 = rshift(pa13)[1:] + rshift(pb12)[:-1]
    Lm11 = pa23[:-1] + pb13[:-1]
    L1m1 = rshift(pa23)[1:] + rshift(pb13)[1:]
    L00 = -(L10 + Lm10 + L01 + L0m1 + Lm11 + L1m1)
    by_off = {
        (1, 0): L10, (-1, 0): Lm10, (0, 1): L01, (0, -1): L0m1,
        (-1, 1): Lm11, (1, -1): L1m1, (0, 0): L00,
    }
    return [by_off[o] for o in _LAYER_ORDER]


def p1_stencil_layers_from_coords_reference(X, Y, n: int):
    """Plain PyTorch version: (7, n+16, W) padded layers, node row I at row
    I+7, valid columns [0, n+1), zeros elsewhere. X, Y: (>= n+1, W) with
    W >= n+1; rows and columns beyond n may hold any finite junk."""
    W = X.shape[1]
    dtype, device = X.dtype, X.device
    lane_roll = lambda a: torch.roll(a, -1, dims=1)  # noqa: E731
    planes = _coords_offdiag_planes(
        X[:n], Y[:n], X[1:n + 1], Y[1:n + 1], lane_roll
    )
    lanes_ok = (torch.arange(W, device=device) < n).to(dtype)[None, :]
    z = torch.zeros((1, W), dtype=dtype, device=device)
    padded = [torch.cat([z, p * lanes_ok, z]) for p in planes]
    rsh = lambda p: torch.roll(p, 1, dims=1)  # noqa: E731
    layers = _stencil_rows_from_planes(padded, rsh)  # node rows [0, n+1)
    out = torch.zeros((7, n + 16, W), dtype=dtype, device=device)
    out[:, 7:7 + n + 1, :] = torch.stack(layers)
    return out


def _check_planes(X, Y, n):
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"n must be a positive int, got {n!r}")
    m = n + 1
    for name, t in (("X", X), ("Y", Y)):
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 or float64, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] < m or t.shape[1] < m:
            raise ValueError(f"{name} must be 2-D with at least {m} rows and columns, got {tuple(t.shape)}")
        if t.stride(1) != 1:
            raise ValueError(f"{name} needs a unit column stride, got strides {t.stride()}")
        if t.dtype != X.dtype or t.device != X.device:
            raise ValueError("X and Y must share dtype and device")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")


def _check(X, Y, n, out):
    _check_planes(X, Y, n)
    m = n + 1
    if out.dtype != X.dtype or out.device != X.device:
        raise ValueError("out must share X's dtype and device")
    if tuple(out.shape) != (7, m, m) or out.stride(2) != 1:
        raise ValueError(
            f"out must be (7, {m}, {m}) with a unit last stride, got "
            f"{tuple(out.shape)} with strides {out.stride()}"
        )


def _launch(symbol, X, Y, n, side, *out_args):
    """Run ``symbol``_f32/_f64 of ``csrc/p1_stencil.cu`` on X's stream over a
    (side, side) grid of threads; raises if the launch fails."""
    from .._build import library

    tiles = -(-side // _BLOCK[0]) * -(-side // _BLOCK[1])
    if tiles >= 2**31:
        raise ValueError(f"n = {n} needs {tiles} blocks, above the grid limit")
    fn = getattr(library(), f"{symbol}_{'f32' if X.dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), Y.data_ptr(), X.stride(0), Y.stride(0), n, *out_args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")


def p1_stencil_layers_into(X, Y, n: int, out):
    """Write the 7 stencil layers of nodes [0, n]^2 into ``out``.

    X, Y: (>= n+1, >= n+1) coordinate planes, float32 or float64, unit
    column stride. out: (7, n+1, n+1) tensor or view of X's dtype and
    device with a unit last stride. Returns out.
    """
    global p1_stencil_launches
    _check(X, Y, n, out)
    m = n + 1
    if X.device.type == "cpu":
        out.copy_(p1_stencil_layers_from_coords_reference(X, Y, n)[:, 7:7 + m, :m])
        return out
    _launch("p1_stencil_layers", X, Y, n, m, out.data_ptr(), out.stride(0), out.stride(1))
    p1_stencil_launches += 1
    return out


def p1_stencil_layers_from_coords(X, Y, n: int):
    """(7, n+16, W) padded stencil layers, W = X.shape[1]: node row I at
    row I+7, valid columns [0, n+1), zeros elsewhere (the JAX function's
    layout)."""
    m = n + 1
    out = torch.zeros((7, n + 16, X.shape[1]), dtype=X.dtype, device=X.device)
    p1_stencil_layers_into(X, Y, n, out[:, 7:7 + m, :m])
    return out


def p1_offdiag_planes_from_coords_reference(X, Y, n: int):
    """Plain PyTorch version of K3 (the JAX function's non-TPU branch):
    (6, n, n) planes [a12, a13, a23, b12, b13, b23] over quads [0, n)^2."""
    lane_roll = lambda a: torch.roll(a, -1, dims=1)  # noqa: E731
    planes = _coords_offdiag_planes(X[:n], Y[:n], X[1:n + 1], Y[1:n + 1], lane_roll)
    return torch.stack([p[:, :n] for p in planes])


def p1_offdiag_planes_from_coords(X, Y, n: int):
    """K3: the (6, n, n) off-diagonal planes [a12, a13, a23, b12, b13, b23]
    of quads [0, n)^2 (input of ``grid_assembly.stencil_from_offdiag_planes``).

    X, Y: (>= n+1, >= n+1) coordinate planes, float32 or float64, unit
    column stride; rows and columns beyond n are never read. On a CUDA
    tensor it launches the second entry point of ``csrc/p1_stencil.cu`` and
    counts it in ``p1_offdiag_planes_launches``; on a CPU tensor it runs the
    plain version. JAX's ``n % 128``, ``block_rows``, ``n_buf`` and ``eps``
    serve its TPU DMA pipeline and have no counterpart here.
    """
    global p1_offdiag_planes_launches
    _check_planes(X, Y, n)
    if X.device.type == "cpu":
        return p1_offdiag_planes_from_coords_reference(X, Y, n)
    out = torch.empty((6, n, n), dtype=X.dtype, device=X.device)
    _launch("p1_offdiag_planes", X, Y, n, n, out.data_ptr())
    p1_offdiag_planes_launches += 1
    return out
