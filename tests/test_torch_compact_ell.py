"""K2's compact form behind ``gather_spmv.ELLSoA`` on the card: its faces
take the kernel's widening entry for float32 values on a float64 operand,
one launch a product and no converted table. No JAX; the test is marked
``cuda`` and skips without a card (the CPU cases of the same rule sit in
tests/test_torch_matfree.py)."""

import pytest
import torch

from fdapde_core_tpu_torch.geometry import irregular_mesh_device_soa
from fdapde_core_tpu_torch.ops import WindowedELL
from fdapde_core_tpu_torch.ops import gather_spmv as gs
from fdapde_core_tpu_torch.ops.matfree_soa import MatrixFreeSoA


@pytest.mark.cuda
def test_windowed_f32_table_on_f64_operand_widens_in_one_launch():
    """WindowedELL with a float32 table on a float64 x: one K2 launch
    through the widening entry, bitwise equal to the product on the table
    converted to float64 (the product before the widening entry served
    it), and to the plain ELLSoA's product on the same table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    x, y, c0, c1, c2, _ = irregular_mesh_device_soa(256, 0.2, device="cuda")
    E, over = MatrixFreeSoA.build(x, y, c0, c1, c2, x.shape[0], 8)[0].to_ell(9)
    assert not bool(over)
    E32 = E.astype(torch.float32)
    W = WindowedELL.from_ell(E32, block_rows=4096)
    v = torch.randn(E.shape[0], dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    launches, widened = gs.ell_spmv_launches, gs.ell_spmv_widened_launches
    got = W @ v
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    assert (gs.ell_spmv_launches, gs.ell_spmv_widened_launches) == (launches + 1, widened + 1)
    k2 = W._k2
    wins = torch.nn.functional.pad(v, (W.B, W.nb * W.R + W.B - W.n)).unfold(0, W.wwin, W.R)
    converted = gs.ell_spmv(k2.vals.double(), k2.cols, wins.reshape(-1))[: W.n]
    assert torch.equal(got, converted), "the widening entry differs from the converted table"
    assert torch.equal(got, E32 @ v), "WindowedELL differs from its ELLSoA"
