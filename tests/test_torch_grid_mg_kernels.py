"""The V-cycle's finer-level stages on the card: the CUDA kernels of
``csrc/grid_mg_levels.cu`` (``grid_mg.LevelKernels`` and the module's
``grid_mg_smooth``, ``grid_mg_residual``, ``grid_mg_restrict``,
``grid_mg_prolong_add``) against the plain functions ``GridMG._smooth``,
``_stencil``, ``_restrict`` and ``_prolong``.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode); on the card: ``python3 -m pytest -o addopts=
tests/test_torch_grid_mg_kernels.py -q``. The stages and whole V-cycles are
held bitwise (the bits of every entry, signed zeros included) to the plain
ones on the same input; the launch count to at most 8 a finer level; and
inputs outside the kernels' domain raise instead of falling back. The CPU
side of the dispatch rule is tested in ``tests/test_torch_grid.py``. No
JAX.
"""

import pytest
import torch

from fdapde_core_tpu_torch.ops import grid_mg
from fdapde_core_tpu_torch.ops.auxgrid import _grid_stencil
from fdapde_core_tpu_torch.ops.grid_mg import (
    GridMG,
    _prolong,
    _restrict,
    _stencil,
    grid_mg_prolong_add,
    grid_mg_residual,
    grid_mg_restrict,
    grid_mg_smooth,
    mg_preconditioned_cg,
)
from fdapde_core_tpu_torch.utils import profiling

NINE = grid_mg._NINE_POINT
FIVE = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
SEVEN = FIVE + ((-1, 1), (1, -1))  # a P1 triangle stencil: the kernels' any-K path
STORAGE = (torch.float32, torch.float64, torch.bfloat16)
VECTORS = (torch.float32, torch.float64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the stage kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(got, want, where):
    assert got.dtype == want.dtype and got.shape == want.shape, where
    assert torch.equal(_bits(got), _bits(want)), (
        f"{where}: {int((_bits(got) != _bits(want)).sum())} entries differ, "
        f"largest gap {float((got - want).abs().max()):.3e}")


def _layers(m, offsets, gen):
    """(K, m, m) f64 stencil layers of variable coefficients: a dominant
    positive (0, 0) layer, small negative others."""
    lay = -0.25 * torch.rand((len(offsets), m, m), generator=gen, dtype=torch.float64)
    lay[offsets.index((0, 0))] = 2.0 + torch.rand((m, m), generator=gen, dtype=torch.float64)
    return lay


def _free_grid(m, dtype, device):
    free1d = torch.zeros(m, dtype=dtype, device=device)
    free1d[1:-1] = 1.0
    return _grid_stencil(free1d[:, None] * free1d[None, :])


def _plain(monkeypatch):
    monkeypatch.setattr(grid_mg, "level_kernels_apply", lambda *a: False)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 5, 51, 101, 721])
def test_stages_match_plain_functions_on_card(card, m):
    """Each stage kernel is bitwise its plain function, for f32 and f64
    vectors, f32 / f64 / bf16 layers, K = 5, 7 and 9: the sweeps from x = 0
    and from x (nu = 1, 2, 3), the residual, the restriction and the
    prolongation with its correction; one launch a sweep and a stage."""
    gen = torch.Generator().manual_seed(m)
    mc = (m + 1) // 2
    for offsets in (FIVE, SEVEN, NINE):
        base = _layers(m, offsets, gen)
        for storage in STORAGE:
            layers = base.to(storage).to(card)
            for vdt in VECTORS:
                where = f"m={m} K={len(offsets)} {storage} under {vdt}"
                b = torch.randn((m, m), generator=gen, dtype=torch.float64).to(vdt).to(card)
                x = torch.randn((m, m), generator=gen, dtype=torch.float64).to(vdt).to(card)
                e = torch.randn((mc, mc), generator=gen, dtype=torch.float64).to(vdt).to(card)
                b[0, :2] = 0.0  # zero entries of b: the zero-start sweep's signed zeros
                for nu in (1, 2, 3):
                    plain = GridMG([layers], (offsets,), (m,), 0.8, nu, 64)
                    before = grid_mg.grid_mg_level_launches
                    got = grid_mg_smooth(layers, offsets, b, None, 0.8, nu)
                    assert grid_mg.grid_mg_level_launches == before + nu, where
                    _same(got, plain._smooth(0, torch.zeros_like(b), b), f"{where} zero nu={nu}")
                    _same(grid_mg_smooth(layers, offsets, b, x.clone(), 0.8, nu),
                          plain._smooth(0, x, b), f"{where} from x nu={nu}")
                _same(grid_mg_residual(layers, offsets, b, x), b - _stencil(layers, offsets, x, m),
                      f"{where} residual")
                _same(grid_mg_restrict(x), _restrict(x, mc), f"{where} restrict")
                _same(grid_mg_prolong_add(e, x.clone()), x + _prolong(e, m), f"{where} prolong")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_vcycles_match_plain_on_card(card, monkeypatch):
    """Whole V-cycles on the kernels are bitwise the plain V-cycle: the
    aux-grid hierarchy (f32, m = 801 -> 51, 5-point finest level), a banded
    one (``MatrixFreePoisson``'s "auto" on a lattice mesh: 9-point f32
    layers) under f32 and f64 vectors, the same with bf16 storage, and a
    ``pde``-like f64 aux grid at m = 181 (181 -> 91 -> 46); at most 8
    launches a finer level, each finer-level stage span holding one
    ``mg.kernel`` span."""
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device
    from fdapde_core_tpu_torch.models import MatrixFreePoisson

    nodes, cells, bnd = irregular_mesh_device(400, 0.2, device=card)
    banded = MatrixFreePoisson(nodes, cells, bnd, device=card).aux.mg
    aux = GridMG.build(_free_grid(801, torch.float32, card))
    pde = GridMG.build(_free_grid(181, torch.float64, card))
    assert aux.shapes == (801, 401, 201, 101, 51) and pde.shapes == (181, 91, 46)
    assert len(banded.offsets[0]) == 9 and banded.datas[0].dtype == torch.float32
    gen = torch.Generator().manual_seed(5)
    cases = [("aux", aux, torch.float32), ("banded", banded, torch.float32),
             ("banded", banded, torch.float64), ("banded bf16", banded.astype(torch.bfloat16),
                                                  torch.float32), ("pde", pde, torch.float64)]
    for name, mg, vdt in cases:
        m0 = mg.shapes[0]
        r = torch.randn(m0 * m0, generator=gen, dtype=torch.float64).to(vdt).to(card)
        before = grid_mg.grid_mg_level_launches
        with profiling.recording() as recs:
            got = mg.v_cycle(r)
        torch.cuda.synchronize()
        launches = grid_mg.grid_mg_level_launches - before
        finer = mg.n_levels - 1
        assert 0 < launches <= 8 * finer, (name, launches)
        stages = {i for i, rec in enumerate(recs) if rec.name in
                  ("mg.smooth", "mg.residual", "mg.restrict", "mg.prolong")}
        kernel = [rec.parent for rec in recs if rec.name == "mg.kernel"]
        assert len(stages) == 5 * finer and sorted(kernel) == sorted(stages), name
        with monkeypatch.context() as mp:
            _plain(mp)
            with profiling.recording() as plain_recs:
                want = mg.v_cycle(r)
            assert grid_mg.grid_mg_level_launches == before + launches, name
            assert "mg.kernel" not in {rec.name for rec in plain_recs}, name
        _same(got, want, f"{name} V-cycle {mg.shapes} under {vdt}")


@pytest.mark.cuda
def test_solves_keep_iterations_on_card(card, monkeypatch):
    """A V-cycle preconditioned CG on the kernels takes the plain run's
    iterations and gives its iterate bitwise (f64, and f32 V-cycles under
    f64 CG)."""
    G = _free_grid(401, torch.float64, card)
    mg = GridMG.build(G)
    b = torch.randn(401 * 401, generator=torch.Generator().manual_seed(6),
                    dtype=torch.float64).to(card)

    def solves():
        before = grid_mg.grid_mg_level_launches
        out = [mg_preconditioned_cg(G, b, rtol=1e-10, mg=mg),
               mg_preconditioned_cg(G, b, rtol=1e-8, mg=mg, prec_dtype=torch.float32)]
        torch.cuda.synchronize()
        return out, grid_mg.grid_mg_level_launches - before

    kernel, launches = solves()
    _plain(monkeypatch)
    plain, none = solves()
    assert launches > 0 and none == 0
    for (xk, _, kk), (xp, _, kp) in zip(kernel, plain):
        assert kk == kp
        _same(xk, xp, "MG-CG iterate")


@pytest.mark.cuda
def test_refused_inputs_raise_on_card(card):
    """Outside the kernels' domain the wrappers raise, never fall back:
    vectors on the CPU under CUDA layers, non-contiguous layers or vectors,
    a wide offset, an even grid, a sweep without the (0, 0) offset."""
    gen = torch.Generator().manual_seed(7)
    layers = _layers(9, NINE, gen).to(card)
    b = torch.randn((9, 9), generator=gen, dtype=torch.float64).to(card)
    with pytest.raises(ValueError, match="CUDA"):
        grid_mg_residual(layers, NINE, b.cpu(), b.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        grid_mg_residual(layers.transpose(1, 2), NINE, b, b)
    with pytest.raises(ValueError, match="contiguous"):
        grid_mg_residual(layers, NINE, b, b.t())
    with pytest.raises(ValueError, match="window"):
        grid_mg_residual(layers, NINE[:8] + ((2, 0),), b, b)
    with pytest.raises(ValueError, match="odd"):
        grid_mg_restrict(b[:8, :8].contiguous())
    no_diag = tuple(o for o in NINE if o != (0, 0))
    with pytest.raises(ValueError, match=r"\(0, 0\)"):
        grid_mg_smooth(layers[:8].contiguous(), no_diag, b, None, 0.8, 2)
