"""Geometric multigrid on 2D grid stencils: Galerkin coarsening + V-cycle.

Jacobi-CG iteration counts grow like O(1/h); a multigrid V-cycle
preconditioner makes the preconditioned condition number O(1), so MG-CG
converges in a few tens of iterations at any size. Every ingredient is
strided slices and elementwise work:

- Galerkin coarse operators A_c = P^T A_f P computed directly on the
  stencil layers (variable coefficients and folded Dirichlet boundaries
  coarsen correctly with no rediscretization),
- bilinear prolongation P / full-weighting restriction P^T over the node
  grid (coarse node (I, J) = fine node (2I, 2J)),
- weighted-Jacobi smoothing (symmetric pre/post, so the V-cycle is an SPD
  preconditioner, valid inside CG),
- fixed unpreconditioned CG at the coarsest level: on a CUDA float32 or
  float64 vector, a 9-point (or narrower) stencil and m^2 <=
  ``COARSE_KERNEL_CAP``, all of its iterations in one launch of
  ``csrc/grid_coarse_cg.cu`` (``grid_coarse_cg``); otherwise, and always on
  the CPU, the plain loop ``_coarse_cg``.

On the levels above the coarsest, where ``level_kernels_apply`` holds (a
CUDA float32 or float64 vector, offsets within the 9-point window, layers
stored in float32, float64 or bfloat16 on the vector's device), the stages
run as the hand-written kernels of ``csrc/grid_mg_levels.cu``
(``LevelKernels``): one launch a Jacobi sweep, one for the residual, one
for the restriction, one for the prolongation and correction, seven a
level at nu = 2, with the plain functions' arithmetic, so that a V-cycle
is bitwise the plain one on the card. Anywhere else, and always on the
CPU, the plain functions ``_stencil``, ``_restrict``, ``_prolong`` and
``GridMG._smooth`` run.

Each level needs an odd node count m = n+1; coarsening stops when n goes
odd or n // 2 < coarse_n.

A V-cycle's stages are spans (``utils.profiling``) valued by their level
(0 the finest): ``mg.smooth`` (pre and post), ``mg.residual``,
``mg.restrict`` (from the level), ``mg.prolong`` (onto it) and
``mg.coarse``, which holds an ``mg.coarse.kernel`` span around the launch
where the kernel runs. Where the stage kernels run, each of the four
finer-level stage spans holds an ``mg.kernel`` span around its launches.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..utils.profiling import span
from .grid_cg import _safe_div
from .grid_dia import GridDIAMatrix, _pad2

__all__ = ["GridMG", "mg_preconditioned_cg", "galerkin_coarsen"]

# the largest m^2 the coarse-solve kernel takes (kCap in csrc/grid_coarse_cg.cu)
COARSE_KERNEL_CAP = 8192
# coarse-solve kernel launches since import (or since a caller last reset it to 0)
grid_coarse_cg_launches = 0
# stage-kernel launches on the finer levels, counted alike
grid_mg_level_launches = 0

_W = {-1: 0.5, 0: 1.0, 1: 0.5}  # bilinear interpolation weights

_NINE_POINT = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))


def _sampled(layer_padded, a: int, b: int, mc: int):
    """layer_padded[(1+2I+a, 1+2J+b)] for coarse (I, J) in [0, mc)^2."""
    end = 2 * (mc - 1) + 1
    return layer_padded[1 + a:1 + a + end:2, 1 + b:1 + b + end:2]


def galerkin_coarsen(G: GridDIAMatrix) -> GridDIAMatrix:
    """A_c = P^T A_f P on an (m, m) grid, m odd, coarse mc = (m+1)//2.

    Fine offsets must satisfy |di|, |dj| <= 1 (true for P1 tensor-product
    stencils and their Galerkin coarsenings, which stay 9-point).
    """
    m = G.shape2d[0]
    if G.shape2d[0] != G.shape2d[1]:
        raise ValueError("square grids only")
    if m % 2 != 1:
        raise ValueError("node count must be odd (cell count even)")
    if not all(abs(a) <= 1 and abs(b) <= 1 for a, b in G.offsets2d):
        raise ValueError("fine offsets must lie within the 9-point stencil")
    mc = (m + 1) // 2
    fine = {o: _pad2(G.data[k], 1) for k, o in enumerate(G.offsets2d)}

    layers = {}
    for (dI, dJ) in _NINE_POINT:
        acc = torch.zeros((mc, mc), dtype=G.data.dtype, device=G.data.device)
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                for (di, dj), lay in fine.items():
                    ap = a + di - 2 * dI
                    bp = b + dj - 2 * dJ
                    if ap in _W and bp in _W:
                        w = _W[a] * _W[b] * _W[ap] * _W[bp]
                        # fine rows outside the grid read the zero padding
                        acc = acc + w * _sampled(lay, a, b, mc)
        layers[(dI, dJ)] = acc
    data = torch.stack([layers[o] for o in _NINE_POINT])
    return GridDIAMatrix(data, _NINE_POINT, (mc, mc))


def _stencil(data, offsets2d, x, m):
    # layers are cast to the vector dtype (bf16 / f32 storage under f32 /
    # f64 vectors)
    xp = _pad2(x, 1)
    acc = None
    for k, (di, dj) in enumerate(offsets2d):
        t = data[k].to(x.dtype) * xp[1 + di:1 + di + m, 1 + dj:1 + dj + m]
        acc = t if acc is None else acc + t
    return acc


def _coarse_cg(data, offsets2d, m, b, n_iter):
    """``n_iter`` unpreconditioned CG iterations on the stencil from x = 0,
    with no early exit: the plain version of ``grid_coarse_cg``."""
    x, r, p, rr = torch.zeros_like(b), b, b, torch.sum(b * b)
    for _ in range(n_iter):
        Ap = _stencil(data, offsets2d, p, m)
        pAp = torch.sum(p * Ap)
        alpha = _safe_div(rr, pAp, pAp > 0)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = torch.sum(r * r)
        beta = _safe_div(rr_new, rr, rr > 0)
        p = p * beta + r
        rr = rr_new
    return x


def coarse_kernel_applies(b, offsets2d, m: int) -> bool:
    """Whether ``grid_coarse_cg`` takes this solve: b a CUDA float32 or
    float64 tensor, m^2 <= COARSE_KERNEL_CAP and every offset within the
    9-point stencil."""
    return (b.is_cuda and b.dtype in (torch.float32, torch.float64)
            and m * m <= COARSE_KERNEL_CAP and _within_window(offsets2d))


def grid_coarse_cg(layers, offsets2d, b, n_iter: int):
    """``_coarse_cg``'s iterations in one launch of the CUDA kernel
    ``csrc/grid_coarse_cg.cu`` (one thread block, nothing read back by the
    host), counted in ``grid_coarse_cg_launches``. b: (m, m) with
    ``coarse_kernel_applies(b, offsets2d, m)``, which states the kernel's
    domain (the kernel refuses what lies outside it); layers: (K, m, m) of
    b's dtype, contiguous, on b's device. Returns x (m, m)."""
    global grid_coarse_cg_launches
    m = b.shape[-1]
    if (not b.is_cuda or b.shape != (m, m) or layers.shape != (len(offsets2d), m, m)
            or layers.dtype != b.dtype or layers.device != b.device
            or not layers.is_contiguous()):
        raise ValueError(f"the coarse-solve kernel takes a CUDA (m, m) vector b and its ("
                         f"{len(offsets2d)}, m, m) layers of b's dtype on b's device, contiguous; "
                         f"got b {b.dtype} {tuple(b.shape)} on {b.device}, layers {layers.dtype} "
                         f"{tuple(layers.shape)} on {layers.device}")
    if b.device.index != torch.cuda.current_device():
        with torch.cuda.device(b.device):
            return grid_coarse_cg(layers, offsets2d, b, n_iter)
    from .._build import library

    lib = library()
    fn = {torch.float32: lib.grid_coarse_cg_f32, torch.float64: lib.grid_coarse_cg_f64}[b.dtype]
    b = b.contiguous()
    x = torch.empty_like(b)
    code = _offset_code(offsets2d)
    err = fn(layers.data_ptr(), b.data_ptr(), x.data_ptr(), len(offsets2d), m, code, int(n_iter),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"grid_coarse_cg kernel launch failed: cudaError {err}")
    grid_coarse_cg_launches += 1
    return x


def _restrict(r, mc):
    """Full weighting r_c = P^T r_f (coarse (I,J) <- fine (2I, 2J))."""
    rp = _pad2(r, 1)
    acc = None
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            t = _W[a] * _W[b] * _sampled(rp, a, b, mc)
            acc = t if acc is None else acc + t
    return acc


def _prolong(e, m):
    """Bilinear e_f = P e_c onto the (m, m) fine grid."""
    mc = e.shape[0]
    up = torch.zeros((m + 2, m + 2), dtype=e.dtype, device=e.device)
    up[1:2 * (mc - 1) + 2:2, 1:2 * (mc - 1) + 2:2] = e
    acc = None
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            t = _W[a] * _W[b] * up[1 + a:1 + a + m, 1 + b:1 + b + m]
            acc = t if acc is None else acc + t
    return acc


# the stage kernels' code for a layer storage dtype
_LAYER_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _offset_code(offsets2d) -> int:
    """The offsets packed 4 bits an offset, (di + 1) * 3 + (dj + 1) at bits
    4k .. 4k + 3, as ``csrc/grid_coarse_cg.cu`` and
    ``csrc/grid_mg_levels.cu`` read them."""
    return sum(((di + 1) * 3 + dj + 1) << (4 * k) for k, (di, dj) in enumerate(offsets2d))


def _within_window(offsets2d) -> bool:
    return (len(offsets2d) <= len(_NINE_POINT)
            and all(abs(di) <= 1 and abs(dj) <= 1 for di, dj in offsets2d))


def level_kernels_apply(b, layers, offsets2d) -> bool:
    """Whether the stage kernels take a level above the coarsest: b a CUDA
    float32 or float64 tensor, every offset within the 9-point window and
    the layers stored in float32, float64 or bfloat16 on b's device."""
    return (b.is_cuda and b.dtype in (torch.float32, torch.float64)
            and layers.dtype in _LAYER_CODES and layers.device == b.device
            and _within_window(offsets2d))


def _launched(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"grid_mg_levels {what} kernel launch failed: cudaError {err}")


class LevelKernels:
    """One level's stage kernels (``csrc/grid_mg_levels.cu``) for one
    vector dtype. The entry points, the layers' pointer and storage code
    and the packed offsets are resolved once, so that a launch allocates
    its output and makes the C call; the launches are counted in
    ``grid_mg_level_launches``. layers: (K, m, m), contiguous, on a CUDA
    device, stored in float32, float64 or bfloat16 (converted to the vector
    dtype as they are read); offsets within the 9-point window; m odd.
    The methods take contiguous (m, m) vectors of ``dtype`` on the layers'
    device, with that device current, and the stream to launch on; callers
    check that (``GridMG._v`` by ``level_kernels_apply``, the module's
    ``grid_mg_*`` functions one by one)."""

    def __init__(self, layers, offsets2d, dtype):
        K, m = len(offsets2d), layers.shape[-1]
        if not layers.is_cuda or tuple(layers.shape) != (K, m, m) \
                or not layers.is_contiguous() or layers.dtype not in _LAYER_CODES \
                or dtype not in (torch.float32, torch.float64) or not _within_window(offsets2d) \
                or m % 2 != 1:
            raise ValueError(
                f"the stage kernels take contiguous CUDA ({K}, m, m) layers, m odd, stored in "
                f"float32, float64 or bfloat16, offsets within the 9-point window and a float32 "
                f"or float64 vector dtype; got layers {layers.dtype} {tuple(layers.shape)} on "
                f"{layers.device} (contiguous: {layers.is_contiguous()}), offsets {offsets2d}, "
                f"vectors {dtype}")
        from .._build import library

        lib = library()
        sfx = "f32" if dtype == torch.float32 else "f64"
        self.layers, self.m, self.mc, self.dtype = layers, m, (m + 1) // 2, dtype
        self.has_diagonal = (0, 0) in offsets2d
        self._smooth = getattr(lib, f"grid_mg_smooth_{sfx}")
        self._residual = getattr(lib, f"grid_mg_residual_{sfx}")
        self._restrict = getattr(lib, f"grid_mg_restrict_{sfx}")
        self._prolong = getattr(lib, f"grid_mg_prolong_add_{sfx}")
        self._lay = (layers.data_ptr(), _LAYER_CODES[layers.dtype])
        self._grid = (K, m, _offset_code(offsets2d))

    def smooth(self, b, x, omega: float, nu: int, stream: int):
        """``GridMG._smooth``: nu Jacobi sweeps on b, one launch each, from
        x, or from x = 0 where x is None (that sweep reads no x). x, when
        given, is the V-cycle's own temporary and is overwritten."""
        global grid_mg_level_launches
        if not self.has_diagonal:
            raise ValueError("a Jacobi sweep needs the (0, 0) offset")
        if nu == 0:
            return torch.zeros_like(b) if x is None else x
        # sweep s writes x1 for even s and x0 for odd s, reading the other
        x1 = torch.empty_like(b)
        x0 = x if x is not None else (torch.empty_like(b) if nu > 1 else x1)
        _launched(self._smooth(*self._lay, b.data_ptr(), x0.data_ptr(), x1.data_ptr(),
                               *self._grid, omega, nu, x is None, stream), "smooth")
        grid_mg_level_launches += nu
        return x1 if nu % 2 else x0

    def residual(self, b, x, stream: int):
        """b - A x, one launch."""
        global grid_mg_level_launches
        r = torch.empty_like(b)
        _launched(self._residual(*self._lay, b.data_ptr(), x.data_ptr(), r.data_ptr(),
                                 *self._grid, stream), "residual")
        grid_mg_level_launches += 1
        return r

    def restrict(self, r, stream: int):
        """``_restrict(r, (m + 1) // 2)``, one launch."""
        global grid_mg_level_launches
        rc = torch.empty((self.mc, self.mc), dtype=r.dtype, device=r.device)
        _launched(self._restrict(r.data_ptr(), rc.data_ptr(), self.m, stream), "restrict")
        grid_mg_level_launches += 1
        return rc

    def prolong_add(self, e, x, stream: int):
        """x + ``_prolong(e, m)``, one launch, written into x (the V-cycle's
        own temporary); returns x."""
        global grid_mg_level_launches
        _launched(self._prolong(e.data_ptr(), x.data_ptr(), self.m, stream), "prolong")
        grid_mg_level_launches += 1
        return x


def _stage_call(layers, offsets2d, vectors, shapes, stage, *args):
    """Check a ``grid_mg_*`` call's vectors (CUDA, float32 or float64, one
    dtype, contiguous, each of its shape, on the layers' device), then run
    the stage on a ``LevelKernels`` of the layers with that device current,
    on its current stream."""
    b = vectors[0]
    for v, shape in zip(vectors, shapes):
        if (not v.is_cuda or v.dtype != b.dtype or tuple(v.shape) != shape
                or not v.is_contiguous() or v.device != layers.device):
            raise ValueError(
                f"the stage kernels take contiguous CUDA float32 or float64 vectors of one dtype "
                f"on the layers' device ({layers.device}); expected {shape}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device} (contiguous: {v.is_contiguous()})")
    with torch.cuda.device(b.device):
        ops = LevelKernels(layers, offsets2d, b.dtype)
        return getattr(ops, stage)(*vectors, *args, torch.cuda.current_stream().cuda_stream)


def grid_mg_smooth(layers, offsets2d, b, x, omega: float, nu: int):
    """``GridMG._smooth``'s nu sweeps on the stage kernels (x None: from
    x = 0; a given x is overwritten). layers (K, m, m) as ``LevelKernels``
    takes them."""
    m = layers.shape[-1]
    if x is None:
        return _stage_call(layers, offsets2d, (b,), ((m, m),), "smooth", None, omega, nu)
    return _stage_call(layers, offsets2d, (b, x), ((m, m),) * 2, "smooth", omega, nu)


def grid_mg_residual(layers, offsets2d, b, x):
    """b - ``_stencil(layers, offsets2d, x, m)`` in one launch."""
    m = layers.shape[-1]
    return _stage_call(layers, offsets2d, (b, x), ((m, m),) * 2, "residual")


def grid_mg_restrict(r):
    """``_restrict(r, (m + 1) // 2)`` in one launch; r (m, m), m odd."""
    m = r.shape[-1]
    return _stage_call(_no_layers(r), (), (r,), ((m, m),), "restrict")


def grid_mg_prolong_add(e, x):
    """x + ``_prolong(e, m)`` in one launch, written into x; e (mc, mc),
    x (m, m), m = 2 mc - 1."""
    m = x.shape[-1]
    return _stage_call(_no_layers(x), (), (e, x), (((m + 1) // 2,) * 2, (m, m)), "prolong_add")


def _no_layers(v):
    """An empty (0, m, m) layer stack on v's device, for the stages that
    read no layers."""
    m = v.shape[-1]
    return torch.empty((0, m, m), dtype=torch.float32, device=v.device)


@dataclass
class GridMG:
    """V-cycle hierarchy over a GridDIAMatrix (boundary treatment folded).

    Usage: mg = GridMG.build(G); z = mg.v_cycle(r): an SPD operation
    approximating A^{-1} r (a CG preconditioner).
    """

    datas: list  # (K_l, m_l, m_l) per level
    offsets: tuple  # offset tuple per level
    shapes: tuple  # m_l per level
    omega: float
    nu: int
    coarse_iters: int
    # the coarsest level's layers in a vector dtype, for the kernel
    _coarse_cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)
    # (level, vector dtype) -> that level's LevelKernels; a level's layers
    # are not replaced after the hierarchy is built
    _level_cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def build(cls, G: GridDIAMatrix, coarse_n: int = 32, omega: float = 0.8,
              nu: int = 2, coarse_iters: int = 64):
        """Coarsen while the cell count n = m-1 is even and n // 2 >= coarse_n."""
        datas = [G.data]
        offsets = [G.offsets2d]
        shapes = [G.shape2d[0]]
        lvl = G
        while True:
            n = shapes[-1] - 1
            if n % 2 != 0 or n // 2 < coarse_n:
                break
            lvl = galerkin_coarsen(lvl)
            datas.append(lvl.data)
            offsets.append(lvl.offsets2d)
            shapes.append(lvl.shape2d[0])
        return cls(datas, tuple(offsets), tuple(shapes), omega, nu, coarse_iters)

    @property
    def n_levels(self):
        return len(self.shapes)

    def astype(self, dtype):
        """Hierarchy with stencil data stored in ``dtype`` (typically
        bfloat16); vector arithmetic keeps the caller's precision. Sound
        because the V-cycle is only a preconditioner."""
        return GridMG(
            [d.to(dtype) for d in self.datas], self.offsets, self.shapes,
            self.omega, self.nu, self.coarse_iters,
        )

    def _smooth(self, lvl, x, b):
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        inv_diag = 1.0 / data[offs.index((0, 0))].to(b.dtype)
        for _ in range(self.nu):
            x = x + self.omega * inv_diag * (b - _stencil(data, offs, x, m))
        return x

    def _coarse_layers(self, dtype):
        """The coarsest level's layers cast to ``dtype`` once, contiguous
        (the plain loop casts them in each product)."""
        layers = self._coarse_cache.get(dtype)
        if layers is None:
            layers = self._coarse_cache[dtype] = self.datas[-1].to(dtype).contiguous()
        return layers

    def _coarse_solve(self, b):
        lvl = self.n_levels - 1
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        with span("mg.coarse", lvl):
            if coarse_kernel_applies(b, offs, m):
                with span("mg.coarse.kernel", lvl):
                    return grid_coarse_cg(self._coarse_layers(b.dtype), offs, b,
                                          self.coarse_iters)
            return _coarse_cg(data, offs, m, b, self.coarse_iters)

    def _level_kernels(self, lvl, dtype):
        """The level's ``LevelKernels`` for vectors of ``dtype``, built
        once (the layers made contiguous once, as they are stored)."""
        ops = self._level_cache.get((lvl, dtype))
        if ops is None:
            if self.shapes[lvl + 1] != (self.shapes[lvl] + 1) // 2:
                raise ValueError(f"level {lvl + 1} has {self.shapes[lvl + 1]} nodes a side; "
                                 f"coarsening {self.shapes[lvl]} gives {(self.shapes[lvl] + 1) // 2}")
            ops = self._level_cache[(lvl, dtype)] = LevelKernels(
                self.datas[lvl].contiguous(), self.offsets[lvl], dtype)
        return ops

    def _v_kernels(self, lvl, b, stream):
        """``_v`` on the stage kernels: seven launches a level at nu = 2,
        bitwise the plain stages. stream: b's device's current stream, or
        None to look it up (once a V-cycle: the lookup costs ~7 host us)."""
        if stream is None:
            if b.get_device() != torch.cuda.current_device():
                with torch.cuda.device(b.device):
                    return self._v_kernels(lvl, b, None)
            stream = torch.cuda.current_stream().cuda_stream
        ops = self._level_kernels(lvl, b.dtype)
        b = b.contiguous()
        with span("mg.smooth", lvl), span("mg.kernel", lvl):
            x = ops.smooth(b, None, self.omega, self.nu, stream)
        with span("mg.residual", lvl), span("mg.kernel", lvl):
            r = ops.residual(b, x, stream)
        with span("mg.restrict", lvl), span("mg.kernel", lvl):
            rc = ops.restrict(r, stream)
        e = self._v(lvl + 1, rc, stream)
        with span("mg.prolong", lvl), span("mg.kernel", lvl):
            x = ops.prolong_add(e, x, stream)
        with span("mg.smooth", lvl), span("mg.kernel", lvl):
            return ops.smooth(b, x, self.omega, self.nu, stream)

    def _v(self, lvl, b, stream=None):
        """The V-cycle from level ``lvl`` down on b (m_lvl, m_lvl).
        stream: where the stage kernels take the level, the current stream
        of b's device, which the level above passes down (None: looked up
        here)."""
        if lvl == self.n_levels - 1:
            return self._coarse_solve(b)
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        if level_kernels_apply(b, data, offs):
            return self._v_kernels(lvl, b, stream)
        with span("mg.smooth", lvl):
            x = self._smooth(lvl, torch.zeros_like(b), b)
        with span("mg.residual", lvl):
            r = b - _stencil(data, offs, x, m)
        with span("mg.restrict", lvl):
            rc = _restrict(r, self.shapes[lvl + 1])
        e = self._v(lvl + 1, rc)
        with span("mg.prolong", lvl):
            x = x + _prolong(e, m)
        with span("mg.smooth", lvl):
            return self._smooth(lvl, x, b)

    def v_cycle(self, r):
        """One V-cycle on a flat or (m, m) residual; returns the same shape
        and dtype (vector arithmetic in r's dtype)."""
        m = self.shapes[0]
        z = self._v(0, r.reshape(m, m))
        return z.reshape(-1) if r.dim() == 1 else z


def mg_preconditioned_cg(G: GridDIAMatrix, b, rtol=1e-6, maxiter=100,
                         mg: GridMG | None = None, prec_dtype=None,
                         **build_kwargs):
    """CG on G with a V-cycle preconditioner; returns (x, rel_res, iters).

    G must carry its boundary treatment (with_dirichlet_identity). The
    loop's stop test reads one scalar per iteration; the rz-recurrence stop
    is backed by a true-residual evaluation at the end (rel_res is a 0-dim
    tensor, iters a Python int).

    prec_dtype: run the V-cycle in a lower precision than the CG vectors
    (typically f32 under f64): the f32 rounding perturbs the preconditioner,
    not the f64 Krylov recurrence.
    """
    if mg is None:
        mg = GridMG.build(G, **build_kwargs)
    m = G.shape2d[0]
    data, offs = G.data, G.offsets2d
    b = b.reshape(m, m)
    bn2 = torch.sum(b * b)
    tol2 = (rtol * rtol) * bn2

    if prec_dtype is not None:
        vdt = b.dtype

        def prec(r):
            return mg.v_cycle(r.to(prec_dtype)).to(vdt)
    else:
        prec = mg.v_cycle

    z0 = prec(b)
    x, r, p, rz, rr = torch.zeros_like(b), b, z0, torch.sum(b * z0), bn2
    k = 0
    while k < maxiter and bool((rr > tol2) & torch.isfinite(rr)):
        Ap = _stencil(data, offs, p, m)
        pAp = torch.sum(p * Ap)
        alpha = _safe_div(rz, pAp, pAp > 0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p = z + beta * p
        rz, rr = rz_new, torch.sum(r * r)
        k += 1
    true_r = b - _stencil(data, offs, x, m)
    rel = torch.sqrt(torch.sum(true_r * true_r) / bn2)
    return x.reshape(-1), rel, k
