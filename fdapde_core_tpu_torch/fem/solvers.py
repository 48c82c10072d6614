"""Dirichlet conditions by symmetric masking.

Port of ``fdapde_core_tpu/fem/solvers.py`` ``DirichletSystem``: boundary
rows and columns are masked and the boundary coupling moves to the
right-hand side,

    A~ v = mask(v) + free(A @ free(v));   b~ = free(b - A (g . mask)) + g . mask

whose solution equals g on the boundary dofs and leaves the interior
equations unchanged. Masking keeps an SPD operator SPD, so CG applies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["DirichletSystem"]


class DirichletSystem(NamedTuple):
    """A linear operator (anything with ``@`` and ``diagonal()``) with the
    Dirichlet dofs in ``mask`` ((n,) bool) pinned by masking."""

    A: object
    mask: torch.Tensor

    def __call__(self, v):
        free = ~self.mask
        if v.dim() == 2:
            fm = free[:, None]
            return (self.A @ (v * fm)) * fm + v * (~free)[:, None]
        w = (self.A @ (v * free)) * free
        return w + v * self.mask

    def rhs(self, b, g):
        """Move the boundary data g to the right-hand side b."""
        gm = torch.where(self.mask, g, 0.0)
        b2 = (b - self.A @ gm) * (~self.mask)
        return b2 + gm

    def diagonal(self):
        d = self.A.diagonal()
        return torch.where(self.mask, 1.0, d)
