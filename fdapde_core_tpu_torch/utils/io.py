"""Host-side IO: CSV tables, MatrixMarket matrices, reference mesh loading.

Port of ``fdapde_core_tpu/utils/io.py`` (counterpart of fdaPDE-core's
`fdaPDE/utils/IO/csv_reader.h` and the test fixture
`test/src/utils/mesh_loader.h`). Parsing is host-side NumPy: ``read_csv``,
``read_mtx`` and ``load_mesh_csv`` return NumPy arrays, as the JAX
package's do; ``read_csv_sparse`` returns a ``SparseMatrix`` on
``device``. ``read_mtx`` reads its file once (the JAX package's reads it
two or three times).
"""

from __future__ import annotations

import csv
import os

import numpy as np

__all__ = ["read_csv", "read_csv_sparse", "read_mtx", "load_mesh_csv"]


def read_csv(path: str, dtype=np.float64) -> np.ndarray:
    """Parse a CSV table into a dense array.

    Handles the R-style quoting of the reference fixtures (csv_reader.h:32):
    a quoted header row and a quoted row-name first column, both discarded;
    NA/NaN tokens map to nan.
    """
    rows = []
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        # a row-name column: the header's first field is empty in R dumps
        has_rownames = header[0].strip('"') == ""
        for rec in reader:
            if not rec:
                continue
            fields = rec[1:] if has_rownames else rec
            rows.append([np.nan if f.strip().strip('"') in ("NA", "NaN", "nan", "")
                         else float(f.strip().strip('"')) for f in fields])
    return np.asarray(rows, dtype=np.float64).astype(dtype)


def read_csv_sparse(path: str, shape=None, device="cuda"):
    """Parse a COO-triplet CSV (row, col, value; 1-indexed) into a
    ``SparseMatrix`` on ``device``: the reference's
    `parse_file<Eigen::Sparse>` format used for network neighbor matrices
    (csv_reader.h, mesh_loader.h:82). Duplicates are summed."""
    import torch

    from ..linear_algebra.sparse import SparseMatrix

    raw = read_csv(path)
    rows = raw[:, 0].astype(np.int64) - 1
    cols = raw[:, 1].astype(np.int64) - 1
    if shape is None:
        shape = (int(rows.max()) + 1, int(cols.max()) + 1)
    return SparseMatrix.from_coo(rows, cols, torch.as_tensor(raw[:, 2], device=device), shape)


def read_mtx(path: str) -> np.ndarray:
    """Load a MatrixMarket file as a dense float64 array (the reference's
    golden matrices, test/data/mtx/*.mtx, written by Eigen::saveMarket)."""
    from scipy.io import mmread

    m = mmread(path)
    return np.asarray(m.todense() if hasattr(m, "todense") else m, dtype=np.float64)


def load_mesh_csv(mesh_dir: str):
    """Load a reference mesh CSV triple (points/elements/boundary).

    Mirrors the reference test fixture (test/src/utils/mesh_loader.h:62-84):
    element indices are 1-based in the files and realigned to 0.

    Returns (points f64[N,d], elements i32[C,k], boundary i32[N]).
    """
    points = read_csv(os.path.join(mesh_dir, "points.csv"))
    elements = read_csv(os.path.join(mesh_dir, "elements.csv")).astype(np.int64) - 1
    boundary = read_csv(os.path.join(mesh_dir, "boundary.csv")).astype(np.int32).reshape(-1)
    return points, elements.astype(np.int32), boundary
