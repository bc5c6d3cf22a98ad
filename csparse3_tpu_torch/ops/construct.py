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
from .matvec import _wants_grad

__all__ = [
    "expand_indptr",
    "expand_indptr_np",
    "compress_indptr",
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
    "dense_to_csc",
    "eye",
    "diag",
    "diags",
    "random_csc",
    "real_equivalent",
    "complex_rhs_to_real",
    "real_x_to_complex",
    "complex_embed_block_size",
]


def expand_indptr_np(indptr, nnz: int | None = None):
    """indptr -> per-entry segment ids (host)."""
    indptr = np.asarray(indptr)
    n = indptr.shape[0] - 1
    reps = np.diff(indptr)
    out = np.repeat(np.arange(n, dtype=indptr.dtype), reps)
    return out if nnz is None else out[:nnz]


def expand_indptr(indptr, nnz: int):
    """indptr -> per-entry segment ids on the index's device: entry k
    belongs to the number of segment boundaries <= k, less one."""
    indptr = torch.as_tensor(indptr)
    k = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, k, right=True) - 1).to(indptr.dtype)


def compress_indptr(seg_ids, nseg: int, nnz: int | None = None):
    """Sorted per-entry segment ids -> indptr of length nseg + 1, in the
    configured index dtype, on the ids' device; ids >= nseg are not
    counted."""
    seg_ids = torch.as_tensor(seg_ids)
    counts = torch.bincount(seg_ids.long(), minlength=nseg)[:nseg]
    indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return indptr.to(_torch_dtype(get_config().index_dtype))


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


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


def _live_values(a):
    """``a``'s value tensor, trimmed to nnz, when autograd records a call
    on it (a tensor that requires a gradient, grad mode on), else None.
    The format conversions below work on host copies of the arrays; they
    carry such values through the same reordering as a gather, so the
    gradient flows back as in the JAX package's conversions."""
    v = a._arrays[2]
    if isinstance(v, torch.Tensor) and _wants_grad(v):
        return v[: a.nnz]
    return None


def csc_to_coo(a: CSC) -> COO:
    ip, rows, vals = a.np_arrays()
    live = _live_values(a)
    return COO(a.m, a.n, rows, expand_indptr_np(ip),
               vals if live is None else live, device=a._device)


def _resort_np(n_major, major, minor, vals, idx_dtype):
    """Host re-sort of entry streams by (major, minor); returns
    (indptr over major, minor_sorted, vals_sorted, order)."""
    nm = minor.max() + 1 if minor.size else 1
    order = np.argsort(major.astype(np.int64) * nm + minor, kind="stable")
    mj, mn, vv = major[order], minor[order], vals[order]
    indptr = np.zeros(n_major + 1, dtype=idx_dtype)
    indptr[1:] = np.cumsum(np.bincount(mj, minlength=n_major))
    return indptr, mn.astype(idx_dtype, copy=False), vv, order


def _reordered(vals, live, order):
    """The re-sorted values: the host array, or the live tensor gathered
    in the same order."""
    if live is None:
        return np.ascontiguousarray(vals)
    return live[torch.as_tensor(order, device=live.device)]


def csc_to_csr(a: CSC) -> CSR:
    ip, rows, vals = a.np_arrays()
    cols = expand_indptr_np(ip)
    indptr, c_s, v_s, order = _resort_np(
        a.m, rows.astype(np.int64), cols.astype(np.int64), vals,
        np.dtype(get_config().index_dtype))
    return CSR(a.m, a.n, indptr, np.ascontiguousarray(c_s),
               _reordered(v_s, _live_values(a), order),
               canonical=a.canonical, device=a._device)


def csr_to_csc(a: CSR) -> CSC:
    ip, cols, vals = a.np_arrays()
    rows = expand_indptr_np(ip)
    indptr, r_s, v_s, order = _resort_np(
        a.n, cols.astype(np.int64), rows.astype(np.int64), vals,
        np.dtype(get_config().index_dtype))
    return CSC(a.m, a.n, indptr, np.ascontiguousarray(r_s),
               _reordered(v_s, _live_values(a), order),
               canonical=a.canonical, device=a._device)


def transpose(a: CSC) -> CSC:
    """A^T.  Float and complex values go through the native count-and-
    scatter transpose, the others through one stable sort of the entries by
    old row; both give the same CSC.  Values that require a gradient take
    the sort, whose order gathers them."""
    ip, old_rows, vals = a.np_arrays()
    live = _live_values(a)
    if live is None and np.issubdtype(vals.dtype, np.inexact):
        from ..native import host_ext

        idx = np.dtype(get_config().index_dtype)
        Tp, Ti, Tx = host_ext.csc_transpose(a.m, a.n, ip, old_rows, vals)
        return CSC(a.n, a.m, Tp.astype(idx, copy=False),
                   Ti.astype(idx, copy=False),
                   Tx.astype(vals.dtype, copy=False), canonical=a.canonical,
                   device=a._device)
    old_cols = expand_indptr_np(ip)
    indptr, r_s, v_s, order = _resort_np(
        a.m, old_rows.astype(np.int64), old_cols.astype(np.int64), vals,
        np.dtype(get_config().index_dtype))
    return CSC(a.n, a.m, indptr, np.ascontiguousarray(r_s),
               _reordered(v_s, live, order), canonical=a.canonical,
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


def dense_to_csc(arr, device=None) -> CSC:
    """CSC of the nonzeros of a dense array (numpy or a tensor); a tensor's
    device is the result's unless ``device`` names another."""
    if isinstance(arr, torch.Tensor):
        device = arr.device if device is None else device
        arr = arr.detach().cpu().numpy()
    arr_np = np.asarray(arr)
    rows, cols = np.nonzero(arr_np)
    return from_triplets(rows, cols, arr_np[rows, cols], arr_np.shape,
                         device=device)


def eye(n, dtype=None, k: int = 0, device=None) -> CSC:
    """n x n identity, or ones on diagonal ``k`` (k > 0 above the main
    one)."""
    dtype = dtype or get_config().value_dtype
    if k >= 0:
        rows = np.arange(0, n - k)
        cols = rows + k
    else:
        cols = np.arange(0, n + k)
        rows = cols - k
    return from_triplets(rows, cols, np.ones(len(rows), dtype=dtype), (n, n),
                         device=device)


def diag(m, n, value, device=None) -> CSC:
    """m x n matrix with ``value`` on the main diagonal."""
    d = min(m, n)
    idx = np.arange(d)
    vals = np.full(d, value, dtype=get_config().value_dtype)
    return from_triplets(idx, idx, vals, (m, n), device=device)


def diags(array, device=None) -> CSC:
    """Square diagonal matrix from a vector (numpy or a tensor, placed on
    the tensor's device)."""
    if isinstance(array, torch.Tensor):
        device = array.device if device is None else device
        array = array.detach().cpu().numpy()
    array = np.asarray(array)
    d = array.shape[0]
    idx = np.arange(d)
    return from_triplets(idx, idx, array, (d, d), device=device)


def random_csc(m, n, density=0.01, seed=0, dtype=None, device=None) -> CSC:
    """Random test matrix: ``int(m n density)`` triplets from numpy's
    ``default_rng(seed)`` (the JAX package's draws, so the same matrix),
    duplicates summed."""
    dtype = dtype or get_config().value_dtype
    rng = np.random.default_rng(seed)
    k = int(m * n * density)
    rows = rng.integers(0, m, size=k)
    cols = rng.integers(0, n, size=k)
    vals = rng.standard_normal(k).astype(dtype)
    return from_triplets(rows, cols, vals, (m, n), device=device)


def real_equivalent(a: CSC, interleave: bool = True) -> CSC:
    """Split-complex real doubling of a complex matrix: each entry p + iq
    stamps the real block [[p, -q], [q, p]].  Interleaved (the default),
    the variables are (re z0, im z0, re z1, ...) and bandwidth bw becomes
    2 bw + 1, so a complex banded system rides the real banded solvers;
    ``interleave=False`` stacks them as [[Re, -Im], [Im, Re]].  Real input
    comes back unchanged.  Host numpy; the result keeps ``a``'s device."""
    ip, ix, dt = a.np_arrays()
    dt = np.asarray(dt)
    if not np.iscomplexobj(dt):
        return a
    rows = np.asarray(ix, dtype=np.int64)
    cols = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(np.asarray(ip)))
    p, q = np.ascontiguousarray(dt.real), np.ascontiguousarray(dt.imag)
    if interleave:
        r2 = np.concatenate([2 * rows, 2 * rows, 2 * rows + 1, 2 * rows + 1])
        c2 = np.concatenate([2 * cols, 2 * cols + 1, 2 * cols, 2 * cols + 1])
    else:
        r2 = np.concatenate([rows, rows, rows + a.m, rows + a.m])
        c2 = np.concatenate([cols, cols + a.n, cols, cols + a.n])
    v2 = np.concatenate([p, -q, q, p])
    return from_triplets(r2, c2, v2, (2 * a.m, 2 * a.n), device=a._device)


def complex_rhs_to_real(b, perm):
    """Inbound half of the interleaved embedding (host): apply the
    complex-level ordering ``perm`` and interleave re / im into a real
    (2n, B) array.  Returns (b2, squeeze); pair with ``real_x_to_complex``."""
    b = np.asarray(b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    bp = b[perm]
    b2 = np.empty((2 * b.shape[0], b.shape[1]),
                  dtype=np.float64 if b.real.dtype == np.float64
                  else np.float32)
    b2[0::2] = bp.real
    b2[1::2] = bp.imag
    return b2, squeeze


def real_x_to_complex(x2, perm, squeeze):
    """Outbound half of ``complex_rhs_to_real``."""
    x2 = np.asarray(x2)
    xp = x2[0::2] + 1j * x2[1::2]
    x = np.empty_like(xp)
    x[perm] = xp
    return x[:, 0] if squeeze else x


def complex_embed_block_size(s):
    """Block size for the interleaved embedding: bandwidth bw maps to
    2 bw + 1, so a block size legal for the complex system (s >= bw) maps
    to 2 s + 8 (>= 2 s + 1, and a multiple of 8 stays one)."""
    return None if s is None else 2 * s + 8
