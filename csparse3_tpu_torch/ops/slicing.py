"""Slicing and submatrix extraction: the ``CSC.__getitem__`` cases of the
JAX package (``csparse3_tpu/ops/slicing.py``).

  A[i, j]          -> scalar value
  A[i, :]          -> 1 x n CSC        A[:, j]        -> m x 1 CSC
  A[i0:i1, :]      -> row slice        A[:, j0:j1]    -> column slice
  A[i0:i1, j0:j1]  -> window           A[:, :]        -> copy
  A[rows, cols]    (int arrays, lists or boolean masks) -> the cross-product
                     submatrix A[np.ix_(rows, cols)]

Structural selection is host work (the output size depends on the data):
numpy on the trimmed arrays, then a CSC on the input's device.  The value
dtype is kept; row and column selections may repeat or permute indices.
"""

from __future__ import annotations

import numpy as np

from ..types import CSC
from . import construct

__all__ = ["getitem", "submatrix", "sample_offsets", "sample_values"]


def _slice_to_range(sl: slice, dim: int) -> np.ndarray:
    start, stop, step = sl.indices(dim)
    return np.arange(start, stop, step, dtype=np.int64)


def _norm_key(key, dim):
    """Normalize one axis key to ('int', i) | ('range', np.ndarray)."""
    if isinstance(key, (int, np.integer)):
        i = int(key)
        if i < 0:
            i += dim
        if not 0 <= i < dim:
            raise IndexError(f"index {key} out of range [0, {dim})")
        return "int", i
    if isinstance(key, slice):
        return "range", _slice_to_range(key, dim)
    arr = np.asarray(key)
    if arr.dtype == bool:
        arr = np.flatnonzero(arr)
    return "range", arr.astype(np.int64)


def getitem(a: CSC, key):
    if not isinstance(key, tuple):
        key = (key, slice(None))
    if len(key) != 2:
        raise IndexError("CSC supports 2-D indexing only")
    kr, rows = _norm_key(key[0], a.m)
    kc, cols = _norm_key(key[1], a.n)
    if kr == "int" and kc == "int":
        return _get_scalar(a, rows, cols)
    r = np.asarray([rows]) if kr == "int" else rows
    c = np.asarray([cols]) if kc == "int" else cols
    return submatrix(a, r, c)


def _get_scalar(a: CSC, i: int, j: int):
    ip, ix, dt = a.np_arrays()
    lo, hi = ip[j], ip[j + 1]
    seg = ix[lo:hi]
    if a.canonical:
        p = np.searchsorted(seg, i)
        if p < len(seg) and seg[p] == i:
            return dt[lo + p]
    else:
        hits = np.flatnonzero(seg == i)
        if hits.size:
            return dt[lo:hi][hits].sum()
    return dt.dtype.type(0)


def submatrix(a: CSC, rows: np.ndarray, cols: np.ndarray) -> CSC:
    """A[np.ix_(rows, cols)]; rows and cols may repeat and permute."""
    ip, ix, dt = a.np_arrays()
    # select columns first (cheap in CSC: contiguous segments)
    counts = np.diff(ip)
    sel_starts = ip[cols]
    sel_counts = counts[cols]
    total = int(sel_counts.sum())
    out_cols = np.repeat(np.arange(len(cols)), sel_counts)
    # positions of selected entries in the original arrays
    offs = np.concatenate([[0], np.cumsum(sel_counts)])
    pos = np.arange(total) + np.repeat(sel_starts - offs[:-1], sel_counts)
    sub_rows = ix[pos]
    sub_vals = dt[pos]
    # row selection: map original row id -> output row id(s).  Repeated row
    # indices need one output entry per occurrence.
    order = np.argsort(rows, kind="stable")
    rows_sorted = rows[order]
    left = np.searchsorted(rows_sorted, sub_rows, side="left")
    right = np.searchsorted(rows_sorted, sub_rows, side="right")
    reps = right - left
    keep = np.repeat(np.arange(total), reps)
    # for each kept entry, which occurrence slot of its row id
    occ = np.arange(len(keep)) - np.repeat(
        np.concatenate([[0], np.cumsum(reps)])[:-1], reps
    )
    new_rows = order[left[keep] + occ]
    return construct.from_triplets(
        new_rows, out_cols[keep], sub_vals[keep], (len(rows), len(cols)),
        device=a._device)


def sample_offsets(a: CSC, rows, cols):
    """Position of each queried entry in ``a.data`` (-1 where absent).
    Requires a canonical matrix (unique sorted entries)."""
    if not a.canonical:
        raise ValueError("sample_offsets requires a canonical matrix; "
                         "call canonicalize() first")
    rows = np.asarray(rows).ravel()
    cols = np.asarray(cols).ravel()
    ip, ix, _ = a.np_arrays()
    ecols = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(ip))
    keys = ecols * a.m + ix.astype(np.int64)
    q = cols.astype(np.int64) * a.m + rows.astype(np.int64)
    pos = np.searchsorted(keys, q, side="left")
    pos_c = np.clip(pos, 0, max(len(keys) - 1, 0))
    hit = (keys[pos_c] == q) if len(keys) else np.zeros(len(q), bool)
    return np.where(hit, pos_c, -1).astype(np.int64)


def sample_values(a: CSC, rows, cols):
    """Vectorized point lookup A[rows[i], cols[i]] -> values (0 where the
    entry is absent; duplicates summed for non-canonical matrices)."""
    rows = np.asarray(rows).ravel()
    cols = np.asarray(cols).ravel()
    ip, ix, dt = a.np_arrays()
    ecols = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(ip))
    keys = ecols * a.m + ix.astype(np.int64)
    if not a.canonical:
        order = np.argsort(keys, kind="stable")
        keys, dt = keys[order], dt[order]
    q = cols.astype(np.int64) * a.m + rows.astype(np.int64)
    lo = np.searchsorted(keys, q, side="left")
    hi = np.searchsorted(keys, q, side="right")
    out = np.zeros(len(q), dtype=dt.dtype)
    for t in np.flatnonzero(hi > lo):
        out[t] = dt[lo[t]:hi[t]].sum()
    return out
