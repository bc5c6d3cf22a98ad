"""Reductions and structural cleanups, as the JAX package's
``csparse3_tpu/ops/reductions.py``: the main diagonal and ``sum`` (segment
sums on the matrix's device, ``index_add_`` here) and ``sum_duplicates``
(a canonicalization on the host)."""

from __future__ import annotations

import torch

from ..types import CSC
from . import construct

__all__ = ["diagonal", "sum", "sum_duplicates"]


def diagonal(a: CSC):
    """Main diagonal as a dense vector on the matrix's device, length
    min(m, n); duplicate diagonal entries add up."""
    rows, cols = a.entry_streams()
    data = a.data[: a.nnz]
    d = min(a.m, a.n)
    on = rows == cols
    out = torch.zeros(d, dtype=data.dtype, device=data.device)
    return out.index_add_(0, rows[on], data[on])


def sum(a: CSC, axis=None):
    """Sum of the stored values (a 0-d tensor), of each column (axis=0,
    shape (n,)) or of each row (axis=1, shape (m,)), on the matrix's
    device."""
    data = a.data[: a.nnz]
    if axis is None:
        return data.sum()
    if axis not in (0, 1):
        raise ValueError(f"bad axis {axis}")
    rows, cols = a.entry_streams()
    size, ids = (a.n, cols) if axis == 0 else (a.m, rows)
    return data.new_zeros(size).index_add_(0, ids, data)


def sum_duplicates(a: CSC) -> CSC:
    return construct.canonicalize(a, sum_duplicates=True)
