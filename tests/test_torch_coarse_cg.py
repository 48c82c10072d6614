"""The V-cycle's coarse solve: the CUDA kernel ``grid_mg.grid_coarse_cg``
against the plain loop ``grid_mg._coarse_cg``, and the rule by which
``GridMG._coarse_solve`` takes the kernel.

On the CPU: the dispatch rule, the cast layers the kernel reads, and a CPU
V-cycle that never takes the kernel. On the card (marked ``cuda``, skipped
without one): the kernel against the plain loop on the same hierarchy over
grid sizes, stencil widths, storage and vector dtypes, a zero right-hand
side and one or 64 iterations, and whole solves that keep their iteration
counts. No JAX.
"""

from types import SimpleNamespace

import pytest
import torch

from fdapde_core_tpu_torch.ops import grid_mg
from fdapde_core_tpu_torch.ops.auxgrid import _grid_stencil
from fdapde_core_tpu_torch.ops.grid_mg import (
    COARSE_KERNEL_CAP,
    GridMG,
    coarse_kernel_applies,
    grid_coarse_cg,
    mg_preconditioned_cg,
)
from fdapde_core_tpu_torch.utils import profiling

NINE = grid_mg._NINE_POINT
FIVE = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
CAP_M = max(m for m in range(1, COARSE_KERNEL_CAP) if m % 2 == 1 and m * m <= COARSE_KERNEL_CAP)
TOL = {torch.float32: 1e-4, torch.float64: 1e-9}


def _hierarchy(m: int, K: int, device="cpu", dtype=torch.float64):
    """A GridMG whose coarsest level is (m, m): the 5-point Dirichlet
    Laplacian on one level (K = 5), or the Galerkin coarsening of the one
    on 2 (m - 1) + 1 nodes (K = 9)."""
    fine = m if K == 5 else 2 * (m - 1) + 1
    free1d = torch.zeros(fine, dtype=dtype, device=device)
    free1d[1:-1] = 1.0
    G = _grid_stencil(free1d[:, None] * free1d[None, :])
    mg = GridMG.build(G, coarse_n=fine if K == 5 else (m - 1) // 2 + 1)
    assert mg.shapes[-1] == m and len(mg.offsets[-1]) == K
    return mg


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("b, offsets, m, takes", [
    (torch.zeros(51, 51), NINE, 51, False),                                  # a CPU tensor
    (SimpleNamespace(is_cuda=True, dtype=torch.float32), NINE, 51, True),
    (SimpleNamespace(is_cuda=True, dtype=torch.float64), FIVE, CAP_M, True),
    (SimpleNamespace(is_cuda=True, dtype=torch.float64), NINE, CAP_M + 2, False),   # over the cap
    (SimpleNamespace(is_cuda=True, dtype=torch.float32), NINE + ((2, 0),), 51, False),
    (SimpleNamespace(is_cuda=True, dtype=torch.float32), ((0, 0), (0, -2)), 51, False),
    (SimpleNamespace(is_cuda=True, dtype=torch.bfloat16), NINE, 51, False),  # no bf16 vectors
], ids=["cpu", "f32", "f64-cap", "over-cap", "ten-offsets", "wide-offset", "bf16"])
def test_dispatch_rule(b, offsets, m, takes):
    """The kernel takes a CUDA f32 or f64 vector on a stencil within the
    9-point window with m^2 up to the cap, and nothing else."""
    assert coarse_kernel_applies(b, offsets, m) is takes


def test_cpu_vcycle_takes_the_plain_loop():
    """On the CPU the coarse solve is the plain loop: no ``mg.coarse.kernel``
    span, no launch, and the result of ``_coarse_cg`` itself."""
    mg = _hierarchy(17, 9)
    m0 = mg.shapes[0]
    r = torch.rand(m0 * m0, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    before = grid_mg.grid_coarse_cg_launches
    with profiling.recording() as recs:
        mg.v_cycle(r)
    names = [rec.name for rec in recs]
    assert names.count("mg.coarse") == 1 and "mg.coarse.kernel" not in names
    assert grid_mg.grid_coarse_cg_launches == before
    b = torch.rand(17, 17, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    assert torch.equal(mg._coarse_solve(b),
                       grid_mg._coarse_cg(mg.datas[-1], mg.offsets[-1], 17, b, mg.coarse_iters))


def test_coarse_layers_cast_once():
    """The kernel's layers: the coarsest level cast to the vector dtype,
    contiguous, kept per dtype on the hierarchy (bf16 storage casts
    exactly, as the plain loop's cast in each product does)."""
    mg = _hierarchy(9, 9).astype(torch.bfloat16)
    for dtype in (torch.float32, torch.float64):
        layers = mg._coarse_layers(dtype)
        assert layers.dtype == dtype and layers.is_contiguous()
        assert torch.equal(layers, mg.datas[-1].to(dtype))
        assert mg._coarse_layers(dtype) is layers
    assert mg._coarse_layers(torch.float32) is not mg._coarse_layers(torch.float64)
    assert not mg.astype(torch.float32)._coarse_cache  # a new hierarchy starts empty


def test_kernel_wrapper_refuses_cpu_tensors():
    mg = _hierarchy(5, 9)
    b = torch.ones(5, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        grid_coarse_cg(mg._coarse_layers(torch.float64), mg.offsets[-1], b, 4)


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_loop_on_card(card):
    """The kernel == the plain loop on the same hierarchy to 1e-9 (f64) or
    1e-4 (f32) relative, over m up to the cap's largest odd m, 5- and
    9-point stencils, bf16 / f32 / f64 storage under f32 / f64 vectors, a
    zero right-hand side (both guards: x stays exactly 0) and 1 or 64
    iterations; bitwise the same from run to run, one launch a call; and
    the V-cycle takes it inside an ``mg.coarse.kernel`` span."""
    gen = torch.Generator().manual_seed(3)
    for m in (3, 5, 17, 51, 65, CAP_M):
        for K in (5, 9):
            base = _hierarchy(m, K, device=card)
            for storage in (torch.bfloat16, torch.float32, torch.float64):
                mg = base.astype(storage)
                for vdt in (torch.float32, torch.float64):
                    layers = mg._coarse_layers(vdt)
                    for zero in (False, True):
                        b = torch.zeros(m, m, dtype=vdt) if zero else torch.randn(
                            m, m, generator=gen, dtype=torch.float64).to(vdt)
                        b = b.to(card)
                        for n_iter in (1, 64):
                            where = f"m={m} K={K} {storage} under {vdt} zero={zero} it={n_iter}"
                            before = grid_mg.grid_coarse_cg_launches
                            got = grid_coarse_cg(layers, mg.offsets[-1], b, n_iter)
                            torch.cuda.synchronize()
                            assert grid_mg.grid_coarse_cg_launches == before + 1, where
                            want = grid_mg._coarse_cg(mg.datas[-1], mg.offsets[-1], m, b, n_iter)
                            if zero:
                                assert not got.any() and not want.any(), where
                                continue
                            gap = float((got - want).norm() / want.norm())
                            assert gap <= TOL[vdt], f"{where}: relative gap {gap:.3e}"
                            assert torch.equal(got, grid_coarse_cg(layers, mg.offsets[-1], b,
                                                                   n_iter)), where
    mg = _hierarchy(51, 9, device=card).astype(torch.float32)
    m0 = mg.shapes[0]
    r = torch.randn(m0 * m0, generator=gen).to(card)
    with profiling.recording() as recs:
        mg.v_cycle(r)
    kernel = [rec for rec in recs if rec.name == "mg.coarse.kernel"]
    assert len(kernel) == 1 and recs[kernel[0].parent].name == "mg.coarse"


@pytest.mark.cuda
def test_solves_keep_their_iterations_on_card(card, monkeypatch):
    """Whole solves take the kernel and keep the plain loop's iteration
    counts within one: ``mg_preconditioned_cg`` (f64, and f32 V-cycles under
    f64 CG) and an aux-grid preconditioned solve on an irregular mesh."""
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device_soa
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic

    free1d = torch.zeros(401, dtype=torch.float64, device=card)
    free1d[1:-1] = 1.0
    G = _grid_stencil(free1d[:, None] * free1d[None, :])
    mg = GridMG.build(G)  # 401 -> 201 -> 101 -> 51 nodes a side
    assert mg.shapes[-1] == 51
    b = torch.randn(401 * 401, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    b = b.to(card)
    x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(200, 0.2, device=card)
    model = MatrixFreeElliptic((x, y), torch.stack([c0, c1, c2], 1), bnd, K=1.0,
                               gather_kernel="lane", preconditioner="auxgrid", device=card)
    assert model.aux.mg.shapes[-1] == 51
    load = model.load_vector(torch.ones(c0.shape[0], dtype=torch.float64, device=card))

    def solves():
        before = grid_mg.grid_coarse_cg_launches
        out = [mg_preconditioned_cg(G, b, rtol=1e-10, mg=mg)[2],
               mg_preconditioned_cg(G, b, rtol=1e-8, mg=mg, prec_dtype=torch.float32)[2],
               model.solve(load, rtol=1e-8)[1]]
        torch.cuda.synchronize()
        return out, grid_mg.grid_coarse_cg_launches - before

    kernel, launches = solves()
    monkeypatch.setattr(grid_mg, "coarse_kernel_applies", lambda *a: False)
    plain, none = solves()
    assert launches > 0 and none == 0
    assert all(abs(k - p) <= 1 for k, p in zip(kernel, plain)), (kernel, plain)

