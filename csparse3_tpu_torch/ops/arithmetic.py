"""Elementwise sparse arithmetic on CSC matrices.

The logic is the JAX package's (``csparse3_tpu/ops/arithmetic.py``).  An
operation whose output pattern depends on the data (a union or an
intersection of two patterns, dropped zeros) is host work: a merge is a
sort, the union pattern is ``union1d`` of fused column-major keys, and a
value lookup on a pattern is a vectorized ``searchsorted``.  Canonical
float and complex operands of ``axpby`` go through the native two-pointer
column merge.  The result keeps its numpy arrays as host cache and lands on
the first operand's device.  Operations that keep the pattern (``scale``,
``scale_rows``, ``scale_columns``) work on the host arrays of a matrix
built on the host and on the device tensors otherwise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import get_config
from ..types import CSC
from . import construct

__all__ = [
    "add",
    "sub",
    "axpby",
    "scale",
    "elmul",
    "eldiv",
    "maximum",
    "minimum",
    "compare",
    "equal",
    "eliminate_zeros",
    "scale_rows",
    "scale_columns",
]


def _check_shapes(a: CSC, b: CSC):
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")


def _canonical(a: CSC) -> CSC:
    return a if a.canonical else construct.canonicalize(a)


def _keys_np(a: CSC):
    """Per-entry fused int64 key, col * m + row (ascending when canonical)."""
    ip, rows, _ = a.np_arrays()
    cols = construct.expand_indptr_np(ip).astype(np.int64)
    return cols * a.m + rows.astype(np.int64)


def axpby(alpha, a: CSC, beta, b: CSC) -> CSC:
    """alpha*A + beta*B on the exact union pattern (host; the output nnz
    depends on the data).  Canonical float and complex operands take the
    native column merge, the others the triplet path."""
    _check_shapes(a, b)
    ipa, rowsa, va = a.np_arrays()
    ipb, rowsb, vb = b.np_arrays()
    res_dt = np.result_type(va, vb, np.asarray(alpha), np.asarray(beta))
    if a.canonical and b.canonical and np.issubdtype(res_dt, np.inexact):
        from ..native import host_ext

        Cp, Ci, Cx = host_ext.csc_axpby(
            a.n, ipa, rowsa, va, alpha, ipb, rowsb, vb, beta, res_dt=res_dt)
        idx = np.dtype(get_config().index_dtype)
        return CSC(a.m, a.n, Cp.astype(idx, copy=False),
                   Ci.astype(idx, copy=False), Cx.astype(res_dt, copy=False),
                   canonical=True, device=a._device)
    rows = np.concatenate([rowsa, rowsb])
    cols = np.concatenate(
        [construct.expand_indptr_np(ipa), construct.expand_indptr_np(ipb)])
    dtype = np.result_type(va.dtype, vb.dtype)
    vals = np.concatenate(
        [np.asarray(alpha, dtype) * va, np.asarray(beta, dtype) * vb])
    return construct.from_triplets(rows, cols, vals, a.shape,
                                   device=a._device)


def add(a: CSC, b: CSC) -> CSC:
    return axpby(1, a, 1, b)


def sub(a: CSC, b: CSC) -> CSC:
    return axpby(1, a, -1, b)


def _revalued(a: CSC, data) -> CSC:
    """``a`` with new values on the same pattern: host arrays for numpy
    ``data`` (no device is touched), the device tensors otherwise."""
    if isinstance(data, np.ndarray):
        ip, ix, _ = a.np_arrays()
        return CSC(a.m, a.n, ip, ix, data, canonical=a.canonical,
                   device=a._device)
    return CSC(a.m, a.n, a.indptr, a.indices, data, nnz=a.nnz,
               canonical=a.canonical, device=a._device)


def scale(a: CSC, alpha) -> CSC:
    """alpha * A on the same pattern."""
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.item()
    data = a.np_arrays()[2] if a._np is not None else a.data
    return _revalued(a, data * alpha)


def _lookup_np(keys_sorted, data, query_keys):
    """Value of each query key in a sorted (keys, data) stream, 0 if absent."""
    if keys_sorted.shape[0] == 0:
        return (np.zeros(query_keys.shape, dtype=data.dtype),
                np.zeros(query_keys.shape, dtype=bool))
    pos = np.searchsorted(keys_sorted, query_keys)
    pos_c = np.clip(pos, 0, keys_sorted.shape[0] - 1)
    hit = keys_sorted[pos_c] == query_keys
    return np.where(hit, data[pos_c], data.dtype.type(0)), hit


def _union_binop(a: CSC, b: CSC, op: Callable, drop_zeros: bool) -> CSC:
    """Binary operation over the union pattern (host merge of the sorted
    key streams); an entry missing from one operand counts as zero."""
    _check_shapes(a, b)
    a, b = _canonical(a), _canonical(b)
    keys_a, keys_b = _keys_np(a), _keys_np(b)
    ukeys = np.union1d(keys_a, keys_b)
    va, _ = _lookup_np(keys_a, a.np_arrays()[2], ukeys)
    vb, _ = _lookup_np(keys_b, b.np_arrays()[2], ukeys)
    idx = np.dtype(get_config().index_dtype)
    out = construct.from_triplets(
        (ukeys % a.m).astype(idx), (ukeys // a.m).astype(idx), op(va, vb),
        a.shape, device=a._device)
    return eliminate_zeros(out) if drop_zeros else out


def _intersect_binop(a: CSC, b: CSC, op: Callable) -> CSC:
    """Binary operation over the intersection pattern (elmul, eldiv)."""
    _check_shapes(a, b)
    a, b = _canonical(a), _canonical(b)
    ipb, rowsb, vb = b.np_arrays()
    va, hit = _lookup_np(_keys_np(a), a.np_arrays()[2], _keys_np(b))
    keep = np.flatnonzero(hit)
    return construct.from_triplets(
        rowsb[keep], construct.expand_indptr_np(ipb)[keep],
        op(va, vb)[keep], a.shape, device=a._device)


def elmul(a: CSC, b: CSC) -> CSC:
    return _intersect_binop(a, b, np.multiply)


def eldiv(a: CSC, b: CSC) -> CSC:
    return _intersect_binop(a, b, np.divide)


def maximum(a: CSC, b: CSC) -> CSC:
    return _union_binop(a, b, np.maximum, drop_zeros=False)


def minimum(a: CSC, b: CSC) -> CSC:
    return _union_binop(a, b, np.minimum, drop_zeros=False)


_CMP = {"ne": np.not_equal, "lt": np.less, "gt": np.greater,
        "le": np.less_equal, "ge": np.greater_equal}


def compare(a: CSC, b: CSC, op: str) -> CSC:
    """Sparse comparison ('ne', 'lt', 'gt', 'le', 'ge') with bool data on
    the pattern where the result is true.  Like scipy, only the union
    pattern is looked at: 'le' and 'ge' over the region where both are
    zero would be dense."""
    if op not in _CMP:
        raise ValueError(f"unknown comparison {op!r}")
    return _union_binop(a, b, _CMP[op], drop_zeros=True)


def equal(a: CSC, b: CSC) -> bool:
    """Exact equality of shape, pattern and values."""
    if a.shape != b.shape:
        return False
    a, b = _canonical(a), _canonical(b)
    return a.nnz == b.nnz and all(
        np.array_equal(x, y) for x, y in zip(a.np_arrays(), b.np_arrays()))


def eliminate_zeros(a: CSC) -> CSC:
    """Drop the explicit zeros."""
    ip, rows, vals = a.np_arrays()
    keep = np.flatnonzero(vals != 0)
    cols = construct.expand_indptr_np(ip)
    return construct.from_triplets(rows[keep], cols[keep], vals[keep],
                                   a.shape, device=a._device)


def _per_entry(a: CSC, d, index) -> CSC:
    """``a`` with every value multiplied by ``d[index]`` (``index``: the
    host per-entry row or column), in the values' dtype."""
    if a._np is not None and not isinstance(d, torch.Tensor):
        v = a.np_arrays()[2]
        return _revalued(a, (v * np.asarray(d)[index]).astype(v.dtype))
    d = torch.as_tensor(d, device=a.device)
    idx = torch.as_tensor(index, device=a.device).long()
    return _revalued(a, (a.data * d[idx]).to(a.data.dtype))


def scale_rows(a: CSC, d) -> CSC:
    """diag(d) @ A: the pattern stays, each value meets d[row]."""
    return _per_entry(a, d, a.np_arrays()[1])


def scale_columns(a: CSC, d) -> CSC:
    """A @ diag(d): the pattern stays, each value meets d[column]."""
    return _per_entry(a, d, construct.expand_indptr_np(a.np_arrays()[0]))
