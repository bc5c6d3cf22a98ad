"""Structure validation, as the JAX package's ``csparse3_tpu/ops/
validate.py``: sorted and canonical checks of a compressed container and
``validate``, the index-bounds check with that package's messages.  Host
numpy over ``np_arrays()``."""

from __future__ import annotations

import numpy as np

from ..types import COO, CSC, CSR

__all__ = ["has_sorted_indices", "has_canonical_format", "validate"]


def _streams(a):
    ip, ix, _ = a.np_arrays()
    return np.asarray(ip), np.asarray(ix)


def _ascending(a, strict: bool) -> bool:
    """Minor indices ascending within each major segment (strictly: no
    duplicates either)."""
    ip, ix = _streams(a)
    if len(ix) == 0:
        return True
    ok = np.ones(len(ix), dtype=bool)
    ok[1:] = (ix[1:] > ix[:-1]) if strict else (ix[1:] >= ix[:-1])
    starts = ip[1:-1]
    ok[starts[starts < len(ix)]] = True  # each segment starts afresh
    return bool(ok.all())


def has_sorted_indices(a) -> bool:
    """True if minor indices ascend within each segment (duplicates
    allowed)."""
    return _ascending(a, strict=False)


def has_canonical_format(a) -> bool:
    """Sorted and duplicate-free."""
    return _ascending(a, strict=True)


def validate(a, *, check_sorted: bool = False):
    """Raise ValueError on any structural invariant violation: indptr
    monotone and spanning, indices within bounds, shape/nnz consistency.
    With check_sorted also requires canonical form.  Returns ``a``."""
    if isinstance(a, (CSC, CSR)):
        ip, ix, dt = a.np_arrays()
        nseg = a.n if isinstance(a, CSC) else a.m
        minor_dim = a.m if isinstance(a, CSC) else a.n
        if len(ip) != nseg + 1:
            raise ValueError(f"indptr length {len(ip)} != {nseg + 1}")
        if ip[0] != 0:
            raise ValueError("indptr[0] != 0")
        if (np.diff(ip) < 0).any():
            raise ValueError("indptr is not monotone non-decreasing")
        if ip[-1] != a.nnz:
            raise ValueError(f"indptr[-1]={ip[-1]} != nnz={a.nnz}")
        if len(ix) != len(dt):
            raise ValueError("indices/data length mismatch")
        if len(ix) and (ix.min() < 0 or ix.max() >= minor_dim):
            raise ValueError(
                f"index out of bounds [0, {minor_dim}): "
                f"[{ix.min()}, {ix.max()}]")
        if check_sorted and not has_canonical_format(a):
            raise ValueError("matrix is not in canonical form")
        return a
    if isinstance(a, COO):
        r, c, d = a.np_arrays()
        if not (len(r) == len(c) == len(d)):
            raise ValueError("rows/cols/data length mismatch")
        if len(r) and (r.min() < 0 or r.max() >= a.m):
            raise ValueError("row index out of bounds")
        if len(c) and (c.min() < 0 or c.max() >= a.n):
            raise ValueError("col index out of bounds")
        return a
    raise TypeError(f"cannot validate {type(a).__name__}")
