"""Construction and format conversion.

Every conversion whose output size depends on the data (triplet dedup,
canonicalize) or whose work is a sort (csc <-> csr, transpose) runs on the
host in numpy, as the JAX package runs it when called eagerly; the logic
is that package's (``csparse3_tpu/ops/construct.py``).  The result keeps
its numpy arrays as host cache and lands on the input's device.  Only the
densifications build a device tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import get_config
from ..types import BSR, COO, CSC, CSR, DIA

__all__ = [
    "expand_indptr_np",
    "from_triplets",
    "coo_to_csc",
    "csc_to_coo",
    "csc_to_csr",
    "csr_to_csc",
    "transpose",
    "canonicalize",
    "csc_to_dia",
    "dia_to_csc",
    "csc_to_bsr",
    "bsr_to_dense",
    "csc_to_dense",
    "coo_to_dense",
    "to_scipy",
]


def expand_indptr_np(indptr, nnz: int | None = None):
    """indptr -> per-entry segment ids (host)."""
    indptr = np.asarray(indptr)
    n = indptr.shape[0] - 1
    reps = np.diff(indptr)
    out = np.repeat(np.arange(n, dtype=indptr.dtype), reps)
    return out if nnz is None else out[:nnz]


def from_triplets(rows, cols, vals, shape, *, sum_duplicates=True,
                  device=None) -> CSC:
    """Canonical CSC from COO triplets; duplicates are summed by default
    (scipy-style, what Ybus assembly needs).  Host numpy; the result is
    placed on ``device`` (None: ``config.default_device()``, resolved when
    a tensor of the result is first read)."""
    m, n = shape
    np_idx = np.dtype(get_config().index_dtype)
    rows = np.asarray(rows).astype(np_idx, copy=False)
    cols = np.asarray(cols).astype(np_idx, copy=False)
    vals = np.asarray(vals)
    if rows.shape[0] == 0:
        return _empty_csc(m, n, vals.dtype, device)
    # fused int64 key + stable argsort: numpy's stable integer sort is
    # radix, much faster than np.lexsort at 1M entries
    fused = cols.astype(np.int64) * m + rows
    order = np.argsort(fused, kind="stable")  # by col (major), then row
    r_s, c_s, v_s = rows[order], cols[order], vals[order]
    nnz = r_s.shape[0]
    new = np.empty(nnz, dtype=bool)
    new[0] = True
    new[1:] = (c_s[1:] != c_s[:-1]) | (r_s[1:] != r_s[:-1])
    if sum_duplicates:
        gid = np.cumsum(new) - 1
        k = int(gid[-1]) + 1
        r_u, c_u = r_s[new], c_s[new]
        v_u = np.zeros(k, dtype=v_s.dtype)
        np.add.at(v_u, gid, v_s)
        canonical = True
    else:
        r_u, c_u, v_u = r_s, c_s, v_s
        # sorted, but canonical also means duplicate-free
        canonical = bool(new.all())
    indptr = np.zeros(n + 1, dtype=np_idx)
    counts = np.bincount(c_u, minlength=n)
    indptr[1:] = np.cumsum(counts)
    return CSC(m, n, indptr, np.ascontiguousarray(r_u),
               np.ascontiguousarray(v_u), canonical=canonical, device=device)


def coo_to_csc(coo: COO, sum_duplicates: bool = True) -> CSC:
    r, c, d = coo.np_arrays()
    return from_triplets(r, c, d, coo.shape, sum_duplicates=sum_duplicates,
                         device=coo._device)


def _empty_csc(m, n, dtype, device) -> CSC:
    idx = np.dtype(get_config().index_dtype)
    return CSC(m, n, np.zeros(n + 1, dtype=idx), np.zeros(0, dtype=idx),
               np.zeros(0, dtype=dtype), device=device)


def csc_to_coo(a: CSC) -> COO:
    ip, rows, vals = a.np_arrays()
    return COO(a.m, a.n, rows, expand_indptr_np(ip), vals, device=a._device)


def _resort_np(n_major, major, minor, vals, idx_dtype):
    """Host re-sort of entry streams by (major, minor); returns
    (indptr over major, minor_sorted, vals_sorted)."""
    nm = minor.max() + 1 if minor.size else 1
    order = np.argsort(major.astype(np.int64) * nm + minor, kind="stable")
    mj, mn, vv = major[order], minor[order], vals[order]
    indptr = np.zeros(n_major + 1, dtype=idx_dtype)
    indptr[1:] = np.cumsum(np.bincount(mj, minlength=n_major))
    return indptr, mn.astype(idx_dtype, copy=False), vv


def csc_to_csr(a: CSC) -> CSR:
    ip, rows, vals = a.np_arrays()
    cols = expand_indptr_np(ip)
    indptr, c_s, v_s = _resort_np(
        a.m, rows.astype(np.int64), cols.astype(np.int64), vals,
        np.dtype(get_config().index_dtype))
    return CSR(a.m, a.n, indptr, np.ascontiguousarray(c_s),
               np.ascontiguousarray(v_s), canonical=a.canonical,
               device=a._device)


def csr_to_csc(a: CSR) -> CSC:
    ip, cols, vals = a.np_arrays()
    rows = expand_indptr_np(ip)
    indptr, r_s, v_s = _resort_np(
        a.n, cols.astype(np.int64), rows.astype(np.int64), vals,
        np.dtype(get_config().index_dtype))
    return CSC(a.m, a.n, indptr, np.ascontiguousarray(r_s),
               np.ascontiguousarray(v_s), canonical=a.canonical,
               device=a._device)


def transpose(a: CSC) -> CSC:
    """A^T.  Float and complex values go through the native count-and-
    scatter transpose, the others through one stable sort of the entries by
    old row; both give the same CSC."""
    ip, old_rows, vals = a.np_arrays()
    if np.issubdtype(vals.dtype, np.inexact):
        from ..native import host_ext

        idx = np.dtype(get_config().index_dtype)
        Tp, Ti, Tx = host_ext.csc_transpose(a.m, a.n, ip, old_rows, vals)
        return CSC(a.n, a.m, Tp.astype(idx, copy=False),
                   Ti.astype(idx, copy=False),
                   Tx.astype(vals.dtype, copy=False), canonical=a.canonical,
                   device=a._device)
    old_cols = expand_indptr_np(ip)
    indptr, r_s, v_s = _resort_np(
        a.m, old_rows.astype(np.int64), old_cols.astype(np.int64), vals,
        np.dtype(get_config().index_dtype))
    return CSC(a.n, a.m, indptr, np.ascontiguousarray(r_s),
               np.ascontiguousarray(v_s), canonical=a.canonical,
               device=a._device)


def canonicalize(a: CSC, *, sum_duplicates=True) -> CSC:
    """Sort rows within columns and merge duplicates."""
    return coo_to_csc(csc_to_coo(a), sum_duplicates=sum_duplicates)


def csc_to_dia(a: CSC) -> DIA:
    """CSC -> DIA (host; the diagonal count is data-dependent)."""
    ip, rows, vals = a.np_arrays()
    cols = expand_indptr_np(ip).astype(np.int64)
    offs_all = cols - rows.astype(np.int64)
    offsets = np.unique(offs_all)
    data = np.zeros((len(offsets), a.n), dtype=vals.dtype)
    di = np.searchsorted(offsets, offs_all)
    data[di, cols] = vals
    return DIA(a.m, a.n, offsets.astype(np.int32), data, device=a._device)


def dia_to_csc(a: DIA) -> CSC:
    """DIA -> CSC (host); stored zeros of a diagonal are dropped."""
    offs, dat = a.np_arrays()
    rows_l, cols_l, vals_l = [], [], []
    for i, off in enumerate(offs):
        off = int(off)
        j_lo, j_hi = max(0, off), min(a.n, a.m + off)
        if j_hi <= j_lo:
            continue
        j = np.arange(j_lo, j_hi)
        v = dat[i, j_lo:j_hi]
        nz = v != 0
        rows_l.append(j[nz] - off)
        cols_l.append(j[nz])
        vals_l.append(v[nz])
    if not rows_l:
        return _empty_csc(a.m, a.n, dat.dtype, a._device)
    return from_triplets(
        np.concatenate(rows_l), np.concatenate(cols_l),
        np.concatenate(vals_l), (a.m, a.n), device=a._device)


def csc_to_bsr(a: CSC, block=None) -> BSR:
    """Pack into dense (R, C) blocks (host); ``block`` defaults to
    ``config.bsr_block``.  Only blocks that hold an entry are stored."""
    cfg = get_config()
    R, C = block if block is not None else cfg.bsr_block
    ip, rows, vals = a.np_arrays()
    cols = expand_indptr_np(ip)
    mb, nb = -(-a.m // R), -(-a.n // C)
    key = (rows // R).astype(np.int64) * nb + cols // C
    uniq = np.unique(key)
    nblocks = uniq.shape[0]
    data = np.zeros((max(nblocks, 1), R, C), dtype=vals.dtype)
    np.add.at(data, (np.searchsorted(uniq, key), rows % R, cols % C), vals)
    indptr = np.zeros(mb + 1, dtype=cfg.index_dtype)
    indptr[1:] = np.cumsum(np.bincount(uniq // nb, minlength=mb))
    return BSR(a.m, a.n, R, C, indptr, (uniq % nb).astype(cfg.index_dtype),
               data, nnz_blocks=nblocks, device=a._device)


def bsr_to_dense(a: BSR):
    """Dense (m, n) tensor on the matrix's device: one scatter of the
    block stack into a (mb, R, nb, C) view."""
    mb, nb, R, C, k = a.mb, a.nb, a.R, a.C, a.nnz_blocks
    ip, bcols, _ = a.np_arrays()
    flat = (np.repeat(np.arange(mb, dtype=np.int64), np.diff(ip)) * nb
            + bcols)
    out = torch.zeros((mb * nb, R, C), dtype=a.dtype, device=a.device)
    out.index_add_(0, torch.as_tensor(flat, device=a.device), a.data[:k])
    return (out.view(mb, nb, R, C).permute(0, 2, 1, 3)
            .reshape(mb * R, nb * C)[: a.m, : a.n])


def _dense(m, n, rows, cols, data):
    """Dense (m, n) tensor on ``data``'s device; duplicates sum (bool
    duplicates OR)."""
    rows, cols = rows.long(), cols.long()
    if data.dtype == torch.bool:
        out = torch.zeros((m, n), dtype=torch.int32, device=data.device)
        out.index_put_((rows, cols), data.to(torch.int32), accumulate=True)
        return out > 0
    out = torch.zeros((m, n), dtype=data.dtype, device=data.device)
    return out.index_put_((rows, cols), data, accumulate=True)


def csc_to_dense(a: CSC):
    k = a.nnz
    cols = torch.as_tensor(expand_indptr_np(a.np_arrays()[0]),
                           device=a.device)
    return _dense(a.m, a.n, a.indices[:k], cols, a.data[:k])


def coo_to_dense(a: COO):
    k = a.nnz
    return _dense(a.m, a.n, a.rows[:k], a.cols[:k], a.data[:k])


def to_scipy(a):
    """scipy.sparse matrix of a CSC / CSR / COO container."""
    return a.to_scipy()
