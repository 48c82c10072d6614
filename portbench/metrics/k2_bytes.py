"""K2's byte model: the bytes one launch of the ELL gather SpMV must move,
counted from the matrix it multiplies, and the peak they are held to.

Each stored entry is read once (its value and a 4-byte int32 column), the
operand X once and the result Y written once. Padded slots are not
counted, so a layout that pads more cannot raise the count. This is
``chip_smoke.py``'s arithmetic for K2's bound (``ell_nnz``, ``k2_ell_table``
and ``ell_spmv_vs_bound``, after the correction that counts stored entries
and not slots), copied here so that the program cannot change it.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM (80 GB HBM3) data sheet: HBM bandwidth at the full 700 W
HBM_BYTES_PER_S = 3.35e12
COL_BYTES = 4  # int32 column index


def ell_nnz(vals, cols):
    """Stored entries of a square compact (K, n) table, as a 0-d tensor (no
    host read): its padding carries col = row after the row's entries, and
    every row holds its diagonal (``chip_smoke.py``'s ``ell_nnz``)."""
    K, n = vals.shape
    rows = torch.arange(n, dtype=cols.dtype, device=cols.device)
    return K * n - ((cols == rows[None, :]).sum() - n)


def compact_entries(vals, cols, n_src):
    """Stored entries of a compact (K, n) table with an operand of length
    n_src, as a 0-d tensor: ``ell_nnz`` on a square table; a rectangular one
    (the aux grid's P) has no diagonal to pad with, so its entries are its
    nonzero values."""
    if vals.shape[1] == n_src:
        return ell_nnz(vals, cols)
    return (vals != 0).sum()


def launch_bytes(entries, value_bytes, n, n_src, x_bytes, y_bytes, k=1):
    """Bytes one launch must move: every stored entry once, X (n_src, k)
    read once, Y (n, k) written once."""
    return entries * (value_bytes + COL_BYTES) + n_src * k * x_bytes + n * k * y_bytes
