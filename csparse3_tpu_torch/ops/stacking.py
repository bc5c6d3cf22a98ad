"""Block composition, as the JAX package's ``csparse3_tpu/ops/
stacking.py``: ``block`` over a 2-D grid of CSC blocks (None = zero
block), ``hstack``, ``vstack`` and ``pack_4_by_4``.

Stacking is triplet relabelling on the host: each block's (row, col) ids
are shifted by its block origin, the streams concatenated (values promote
as ``np.concatenate`` promotes them) and one ``from_triplets`` builds the
result, placed on the first block's device."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..types import CSC
from . import construct

__all__ = ["hstack", "vstack", "block", "pack_4_by_4"]


def _dims(grid):
    """Heights of the block rows and widths of the block columns, checked
    against every block."""
    row_h = [-1] * len(grid)
    col_w = [-1] * len(grid[0])
    for i, r in enumerate(grid):
        for j, b in enumerate(r):
            if b is None:
                continue
            if row_h[i] == -1:
                row_h[i] = b.m
            elif row_h[i] != b.m:
                raise ValueError(f"block ({i},{j}) height {b.m} != {row_h[i]}")
            if col_w[j] == -1:
                col_w[j] = b.n
            elif col_w[j] != b.n:
                raise ValueError(f"block ({i},{j}) width {b.n} != {col_w[j]}")
    if -1 in row_h or -1 in col_w:
        raise ValueError("a full block row/column is None; dims unknown")
    return row_h, col_w


def block(grid: Sequence[Sequence[Optional[CSC]]]) -> CSC:
    """Assemble a block matrix from a 2-D grid of CSC blocks (None = zero
    block).  Row / column dims are inferred per block row / column and
    checked."""
    ncols = len(grid[0])
    if any(len(r) != ncols for r in grid):
        raise ValueError("ragged block grid")
    row_h, col_w = _dims(grid)
    row_off = np.concatenate([[0], np.cumsum(row_h)])
    col_off = np.concatenate([[0], np.cumsum(col_w)])
    device = next(b._device for r in grid for b in r if b is not None)
    rows_l, cols_l, vals_l = [], [], []
    for i, r in enumerate(grid):
        for j, b in enumerate(r):
            if b is None or b.nnz == 0:
                continue
            ip, rows, vals = b.np_arrays()
            rows_l.append(rows.astype(np.int64) + row_off[i])
            cols_l.append(construct.expand_indptr_np(ip).astype(np.int64)
                          + col_off[j])
            vals_l.append(vals)
    shape = (int(row_off[-1]), int(col_off[-1]))
    if not rows_l:
        return construct.from_triplets(np.zeros(0, np.int32),
                                       np.zeros(0, np.int32), np.zeros(0),
                                       shape, device=device)
    return construct.from_triplets(np.concatenate(rows_l),
                                   np.concatenate(cols_l),
                                   np.concatenate(vals_l), shape,
                                   device=device)


def hstack(mats: Sequence[CSC]) -> CSC:
    return block([list(mats)])


def vstack(mats: Sequence[CSC]) -> CSC:
    return block([[m] for m in mats])


def pack_4_by_4(a11: CSC, a12: CSC, a21: CSC, a22: CSC) -> CSC:
    """[[A11, A12], [A21, A22]]."""
    return block([[a11, a12], [a21, a22]])
