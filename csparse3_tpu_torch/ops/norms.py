"""Matrix norms on the matrix's device, as the JAX package's
``csparse3_tpu/ops/norms.py``: the 1-norm (max abs column sum), the
inf-norm (max abs row sum) and the Frobenius norm.  The column or row sums
are one ``index_add_`` of |data| over the entries' column or row ids."""

from __future__ import annotations

import math

import torch

from ..types import CSC

__all__ = ["norm"]


def _max_abs_sum(absdata, ids, size):
    if size == 0:
        return absdata.new_zeros(())
    sums = absdata.new_zeros(size).index_add_(0, ids, absdata)
    return sums.max()


def norm(a: CSC, ord=1):
    """ord=1 (max abs column sum), inf (max abs row sum), or 'fro' (also
    'f' and 2, as in the JAX package).  A 0-d tensor on the matrix's
    device, real for complex values; an empty dimension gives zero."""
    rows, cols = a.entry_streams()
    absdata = a.data[: a.nnz].abs()
    if ord == 1:
        return _max_abs_sum(absdata, cols, a.n)
    if ord in (math.inf, "inf"):
        return _max_abs_sum(absdata, rows, a.m)
    if ord in ("fro", "f", 2):
        return absdata.square().sum().sqrt()
    raise ValueError(f"unsupported norm ord={ord!r}")
