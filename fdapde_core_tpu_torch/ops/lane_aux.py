"""The aux-grid preconditioner of the ``aux_kernel="lane"`` path.

Port of ``fdapde_core_tpu/ops/lane_aux.py``. It computes what
``AuxGridPreconditioner`` computes,

    z = omega * D^{-1} r + P V(P^T r),

and with the same code: both interpolation stages are K2 products there
already (P, the (4, n) bilinear table read as a rectangular (n, m^2) ELL,
on K2's compact form; P^T the aux grid's sliced ELL, in a fixed order). What
the lane path adds is its grid, ``lane_friendly_grid_n`` cells a side.

On the TPU both stages had to be lane-routed: the grid's flat index was
transposed to y-major so that its band lined up with strip-ordered mesh
numberings, two (m, m) transposes per apply bridged that to the x-major
V-cycle, per-chunk loads set the routing budgets, and the transpose's rows
were capped at ``k_cap`` entries with a COO overflow. A GPU thread gathers
from anywhere, so all of that is dropped: the grid stays x-major, no
numbering is rejected, and every entry of P^T is in its ELL. ``from_aux``'s
``rounds``, ``max_k``, ``perm`` and ``k_cap`` are accepted and ignored
(``LaneRoutedELL.from_ell`` ignores its routing arguments the same way).
"""

from __future__ import annotations

from .auxgrid import AuxGridPreconditioner, interp_transpose_ell

__all__ = ["LaneAuxGrid", "interp_transpose_ell", "lane_friendly_grid_n"]


def lane_friendly_grid_n(n: int) -> int:
    """Largest even grid_n with (grid_n + 1)^2 <= n: the aux grid JAX's
    ``aux_kernel="lane"`` path takes (on the TPU it keeps the y-major grid
    index inside the routing window of a strip-ordered mesh numbering)."""
    g = int(n ** 0.5) - 1
    g -= g % 2
    while g > 2 and (g + 1) * (g + 1) > n:
        g -= 2
    return max(2, g)


class LaneAuxGrid(AuxGridPreconditioner):
    """The aux grid under JAX's lane name: its apply is the parent's.
    ``split_stages`` are the apply's three stages, each called as
    stage(v, r), which JAX runs as separate programs."""

    @property
    def split_stages(self):
        return (lambda v, r: self.PT @ r,
                lambda v, r: self.mg.v_cycle(v),
                lambda v, r: self.omega * self.dinv * r + self.interpolate(v))

    @classmethod
    def from_aux(cls, aux, rounds: int = 16, max_k: int = 30, perm=None, k_cap: int = 8):
        """The same preconditioner over aux's tables (no copy, P^T not
        rebuilt). ``rounds``, ``max_k``, ``perm`` and ``k_cap`` tune or
        reorder JAX's lane routing and are ignored."""
        la = cls.__new__(cls)
        la.__dict__.update(aux.__dict__)
        return la
