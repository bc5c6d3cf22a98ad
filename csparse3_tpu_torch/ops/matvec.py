"""SpMV and SpMM.

``spmv`` is the entry-stream product y[row] += val * x[col] with
``index_add_``; ``spmm`` is the same for a dense (n, k) X, or, when the
caller names a block shape, the BSR product: the matrix is packed to BSR
once (cached on the CSC) and multiplied by ``bsr_spmm``, which on a CPU
tensor runs the plain version of ``kernels.bsr_spmm`` and on a CUDA tensor
launches that module's CUDA kernel, or raises.  ``SpMVPlan`` precomputes the layout once for repeated
products with a fixed pattern (power-flow iterations), as the JAX package's
plan does (``csparse3_tpu/ops/matvec.py``):

* ``'ell'`` (default when rows are boundedly dense): padded row-major
  (m, W) ``cols`` / ``vals`` slabs; a product is one gather and a row sum.
  Power-grid Ybus rows have degree <= the largest bus fanout, so W stays
  small and the padding waste is low.
* ``'stream'``: per-entry (row, col, val) streams and one ``index_add_``,
  for matrices whose longest row is an outlier (W * m >> nnz).

``SplitSpMV`` is the split-complex form, (xr, xi) -> (yr, yi), the
interface every Ybus plan of the power-flow solvers shares.

The DIA family is the gather-free form for banded matrices (an RCM-ordered
grid Ybus, ``models.grids.rcm_grid``): ``DIAPlan`` densifies the offset
range [omin, omax] into row-aligned slabs, ``SymDIAPlan`` stores only the
diagonals d >= 0 of a symmetric matrix, ``SplitDIA`` / ``SplitSymDIA`` are
their split-complex forms.  They keep the matrix's dtype.  Beside its slabs
a plan holds their occupancy index (``kernels.dia.run_index``, built once on
the host with the slabs: which runs of ``RUN_ROWS`` consecutive slab values
hold a nonzero) and the values of those runs packed in index order
(``kernels.dia.pack_runs``, ~1% of the slabs, for the kernel to stream),
unless the band is dense enough that walking all of it is faster.  The
split-complex forms give their two real plans one shared index and make one
kernel launch per product.  A product on a CPU tensor runs a plain version
of ``kernels.dia``; on a CUDA tensor it launches one of that module's CUDA
kernels (the one that walks the index when the plan has one), or raises.  ``chunk=`` (the JAX
plans' diagonals per scan step) is accepted and has no effect.

Every plan is placed on ``device``; None is the device its matrix was
placed on explicitly, else ``config.default_device()``, the CUDA card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..kernels import bsr_spmm as bsr_kernel
from ..kernels import dia as dia_kernel
from ..types import BSR, CSC, DIA
from . import construct

__all__ = ["spmv", "spmm", "bsr_spmm", "SpMVPlan", "SplitSpMV", "dia_spmv",
           "DIAPlan", "SymDIAPlan", "SplitDIA", "SplitSymDIA"]


def _check(m, n, x):
    if x.shape[0] != n:
        raise ValueError(f"dimension mismatch: matrix is ({m}, {n}), "
                         f"x has leading dimension {x.shape[0]}")


def _stream_product(rows, cols, vals, m, x):
    """y[rows] += vals * x[cols] for x of shape (n,) or (n, k)."""
    v = vals if x.ndim == 1 else vals[:, None]
    prod = v * x[cols]
    y = torch.zeros((m,) + tuple(x.shape[1:]), dtype=prod.dtype,
                    device=x.device)
    return y.index_add_(0, rows, prod)


@torch.inference_mode()
def spmv(a: CSC, x):
    """y = A @ x on x's device.  A is placed there at the first call (the
    placed copy and its entry streams are kept on ``a``)."""
    _check(a.m, a.n, x)
    a = a.to(x.device)
    rows, cols = a.entry_streams()
    return _stream_product(rows, cols, a.data[: a.nnz], a.m, x)


@torch.inference_mode()
def spmm(a: CSC, X, *, block=None, device=None):
    """Y = A @ X for dense X of shape (n, k), on ``device`` (None: X's
    device for a tensor; for numpy where ``a`` was placed, else the CUDA
    card).  ``block=None`` is the entry-stream product.  ``block=(R, C)``
    packs A to BSR blocks of that shape once, cached on ``a``, and calls
    ``bsr_spmm``: the CUDA kernel on a card."""
    if isinstance(X, torch.Tensor) and device is None:
        device = X.device
    device = resolve_device(device, a)
    X = torch.as_tensor(X, device=device)
    _check(a.m, a.n, X)
    if block is None:
        return spmv(a, X)
    bsr = getattr(a, "_bsr_cache", None)
    if bsr is None or (bsr.R, bsr.C) != tuple(block):
        bsr = a.to_bsr(block=block)
    bsr = a._bsr_cache = bsr.to(device)  # the placed one: uploaded once
    return bsr_spmm(bsr, X)


def bsr_spmm(a: BSR, X):
    """Y = A @ X with A in BSR blocks, on X's device (A is placed there):
    every stored (R, C) block meets the rows of X of its occupied columns
    (``BSR.column_lists``, built at the container's first product), and the
    products add up by block row.  X is (n, k) or (n,)."""
    a = a.to(X.device)
    k = a.nnz_blocks
    return bsr_kernel.bsr_spmm(a.m, a.n, a.indptr, a.indices[:k],
                               a.data[:k], X, a.column_lists())


class SpMVPlan(nn.Module):
    """Precomputed structure for repeated y = A x with a fixed pattern,
    placed on ``device``; ``forward(x)`` takes (n,) or (n, k)."""

    def __init__(self, a: CSC, layout: str | None = None,
                 max_waste: float = 4.0, device=None):
        super().__init__()
        device = resolve_device(device, a)
        self.m, self.n = a.shape
        ip, rows_np, vals_np = a.np_arrays()
        rows_np = rows_np.astype(np.int64)
        cols_np = construct.expand_indptr_np(ip).astype(np.int64)
        counts = np.bincount(rows_np, minlength=self.m)
        W = int(counts.max()) if counts.size else 0
        if layout is None:
            layout = ("ell" if W and W * self.m <= max_waste * max(
                len(rows_np), 1) else "stream")
        if layout not in ("ell", "stream"):
            raise ValueError(f"unknown SpMVPlan layout {layout!r}")
        self.layout = layout

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), device=device))

        if layout == "stream":
            buf("rows", rows_np)
            buf("cols", cols_np)
            buf("vals", vals_np)
            return
        # ELL: row-major resort, pad each row to W
        W = max(W, 1)
        order = np.argsort(rows_np * self.n + cols_np, kind="stable")
        r_s, c_s, v_s = rows_np[order], cols_np[order], vals_np[order]
        slot = np.arange(len(r_s)) - np.concatenate(
            [[0], np.cumsum(counts)])[r_s]
        ell_cols = np.zeros((self.m, W), dtype=np.int64)
        ell_vals = np.zeros((self.m, W), dtype=v_s.dtype)
        ell_cols[r_s, slot] = c_s
        ell_vals[r_s, slot] = v_s
        self.rows = None
        buf("cols", ell_cols)
        buf("vals", ell_vals)

    @property
    def W(self) -> int:
        return self.cols.shape[1] if self.layout == "ell" else 0

    @torch.inference_mode()
    def forward(self, x):
        _check(self.m, self.n, x)
        if self.layout == "stream":
            return _stream_product(self.rows, self.cols, self.vals, self.m,
                                   x)
        if x.ndim == 1:
            # (m, W) gather + dense row reduction, scatter-free
            return (self.vals * x[self.cols]).sum(dim=1)
        # multi-RHS: one ELL slot at a time keeps the gather at (m, k)
        dtype = torch.promote_types(self.vals.dtype, x.dtype)
        y = torch.zeros((self.m, x.shape[1]), dtype=dtype, device=x.device)
        for w in range(self.cols.shape[1]):
            y += self.vals[:, w, None] * x[self.cols[:, w]]
        return y


class SplitSpMV(nn.Module):
    """Split-complex SpMV: a complex matrix held as two real plans,

        y_r = A_r x_r - A_i x_i        y_i = A_r x_i + A_i x_r

    ``forward(xr, xi) -> (yr, yi)``, parts (n,) or a batch (K, n) of one
    vector per scenario.  For a real matrix A_i is dropped and the two
    products collapse to one.
    """

    def __init__(self, a: CSC, layout: str | None = None, device=None):
        super().__init__()
        device = resolve_device(device, a)
        self.iscomplex, re, im = _split_real(a)
        self.re = SpMVPlan(re, layout=layout, device=device)
        self.im = None if im is None else SpMVPlan(im, layout=layout,
                                                   device=device)

    @torch.inference_mode()
    def forward(self, xr, xi):
        if xr.ndim == 2:
            # a batch (K, n): the plans take (n, K) right-hand sides
            yr, yi = self._apply(xr.T, xi.T)
            return yr.T, yi.T
        return self._apply(xr, xi)

    def _apply(self, xr, xi):
        if self.im is None:
            return self.re(xr), self.re(xi)
        return (self.re(xr) - self.im(xi), self.re(xi) + self.im(xr))


# ---------------------------------------------------------------------------
# DIA family: gather-free banded SpMV
# ---------------------------------------------------------------------------

@torch.inference_mode()
def dia_spmv(a: DIA, x):
    """y = A @ x for a DIA container, on x's device: per diagonal ``off``,
    y[j - off] += data[i, j] * x[j] over the valid j range (a shifted dense
    multiply-add, no gather and no scatter)."""
    if not isinstance(a, DIA):
        raise TypeError(f"dia_spmv takes a DIA matrix, got {type(a).__name__}")
    _check(a.m, a.n, x)
    offs, data = a.np_arrays()
    data = torch.as_tensor(data, device=x.device)
    y = torch.zeros((a.m,) + tuple(x.shape[1:]), device=x.device,
                    dtype=torch.promote_types(data.dtype, x.dtype))
    for i, off in enumerate(offs):
        off = int(off)
        j_lo, j_hi = max(0, off), min(a.n, a.m + off)
        if j_hi > j_lo:
            seg = data[i, j_lo:j_hi]
            y[j_lo - off: j_hi - off] += (
                seg if x.ndim == 1 else seg[:, None]) * x[j_lo:j_hi]
    return y


def _as_dia(a):
    return a if isinstance(a, DIA) else construct.csc_to_dia(a)


def _split_real(a):
    """(iscomplex, real-part CSC, imaginary-part CSC or None) of a CSC."""
    ip, rows, vals = a.np_arrays()
    iscomplex = np.iscomplexobj(vals)
    re = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.real),
             canonical=a.canonical)
    im = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.imag),
             canonical=a.canonical) if iscomplex else None
    return iscomplex, re, im


class _BandPlan(nn.Module):
    """What the two banded plans share: (D, m) slabs on the device, their
    occupancy index (or none, for a dense band), and a forward that carries
    (n,) or (n, B) input as (B, n) to ``kernels.dia``; ``apply_bn`` takes
    and returns that layout directly."""

    symmetric = False
    omin = 0
    _RUN_BUFFERS = ("run_ptr", "run_diag", "mir_ptr", "mir_diag")
    _VAL_BUFFERS = ("run_vals", "mir_vals")

    def _place(self, ra, device):
        """Register the host slabs ``ra`` on ``device``, and their occupancy
        index as int32 buffers when the listed runs are at most
        ``RUN_SHARE_MAX`` of the runs the dense kernel walks.  The rule is
        fixed here, at build: a cast of the values (``float()``) leaves the
        index alone, and cannot turn a zero into a nonzero."""
        self.register_buffer("slabs", torch.as_tensor(ra, device=device))
        self.has_runs = False
        self._set_runs(dia_kernel.run_index(ra, self.symmetric))

    def _set_runs(self, index) -> bool:
        """Take ``index`` (numpy arrays, as ``kernels.dia.run_index`` gives
        them) for the plan's occupancy index if it passes the rule; returns
        whether it did.  An index that fails leaves the plan as it was."""
        listed = sum(len(diag) for diag in index[1::2])
        D, m = self.slabs.shape
        walked = -(-m // dia_kernel.RUN_ROWS) * (
            2 * D - 1 if self.symmetric else D)
        share = listed / walked if walked > 0 else 1.0
        if not self.has_runs:
            #: listed runs over the runs of the dense walk
            self.run_share = share
        if share > dia_kernel.RUN_SHARE_MAX:
            return False
        self.run_share, self.has_runs = share, True
        for name, arr in zip(self._RUN_BUFFERS, index):
            self.register_buffer(
                name, torch.as_tensor(arr, device=self.slabs.device))
        # the listed runs' values, packed in index order for the kernels to
        # stream: a copy of ~1% of the slabs (float buffers: a cast of the
        # plan casts them with the slabs)
        for name, vals in zip(self._VAL_BUFFERS, dia_kernel.pack_runs(
                self.slabs, self.n, self.omin, self.symmetric, self.runs)):
            self.register_buffer(name, vals)
        return True

    @property
    def runs(self):
        """The occupancy index as ``kernels.dia`` takes it, or None."""
        if not self.has_runs:
            return None
        return tuple(getattr(self, name) for name in
                     self._RUN_BUFFERS[: 4 if self.symmetric else 2])

    @property
    def run_values(self):
        """The packed values of the listed runs (``kernels.dia.pack_runs``),
        or None."""
        if not self.has_runs:
            return None
        return tuple(getattr(self, name) for name in
                     self._VAL_BUFFERS[: 2 if self.symmetric else 1])

    def call_buffers(self):
        """The buffers one product reads (``utils.roofline.plan_bytes``):
        the index and the packed run values, or all of the slabs."""
        return self.runs + self.run_values if self.has_runs \
            else (self.slabs,)

    @property
    def ndiag(self) -> int:
        return self.slabs.shape[0]

    def apply_bn(self, xbn, plain: bool = False):
        """y (B, m) for x given as (B, n), the kernel's own layout, in the
        plan's working dtype; ``plain`` asks for the plain PyTorch version
        of the same route (through the index when the plan has one).
        The kernel takes one dtype: an input wider than the slabs is
        refused on a CUDA device rather than casting the slabs on every
        call."""
        if xbn.shape[-1] != self.n:
            raise ValueError(f"dimension mismatch: matrix is ({self.m}, "
                             f"{self.n}), x has {xbn.shape[-1]} rows")
        dtype = torch.promote_types(self.slabs.dtype, xbn.dtype)
        if xbn.device.type != "cpu" and dtype != self.slabs.dtype:
            raise TypeError(
                f"{type(self).__name__} holds {self.slabs.dtype} slabs and "
                f"got {xbn.dtype} input: cast x, or build the plan from a "
                f"matrix of the wider dtype")
        args = (self.slabs, xbn.to(dtype), self.omin, self.symmetric)
        if not plain:
            return dia_kernel.band_spmv(*args, self.runs, self.run_values)
        if self.runs is None:
            return dia_kernel.dia_spmv_plain(*args)
        return dia_kernel.dia_spmv_runs_plain(*args, self.runs)

    def _call(self, x, plain):
        _check(self.m, self.n, x)
        if x.ndim == 1:
            return self.apply_bn(x[None, :], plain)[0]
        return self.apply_bn(x.T, plain).T

    @torch.inference_mode()
    def plain(self, x):
        """The plain PyTorch version, on any device."""
        return self._call(x, True)

    @torch.inference_mode()
    def forward(self, x):
        return self._call(x, False)


class DIAPlan(_BandPlan):
    """Gather-free banded SpMV over row-aligned diagonal slabs.

    The matrix (a CSC or a DIA) is stored as a DENSE range of diagonals
    [omin, omax]: ``slabs[o - omin, i] = A[i, i + o]``, missing offsets
    hold zero slabs.  The plan lists which runs of the slabs hold
    nonzeros (``runs``), and a product reads only those; a band that is
    dense keeps no list, and a product reads all D * m values.
    ``forward(x)`` takes (n,) or (n, B).
    """

    def __init__(self, a, chunk: int = 8, device=None):
        super().__init__()
        device = resolve_device(device, a)
        d = _as_dia(a)
        self.m, self.n = m, n = d.shape
        offs, data = d.np_arrays()
        offs = offs.astype(np.int64)
        omin, omax = int(offs.min()), int(offs.max())
        ra = np.zeros((omax - omin + 1, m), dtype=data.dtype)
        for t, off in enumerate(offs):
            i_lo, i_hi = max(0, -off), min(m, n - off)
            if i_hi > i_lo:
                ra[off - omin, i_lo:i_hi] = data[t, i_lo + off: i_hi + off]
        self.omin = omin
        self.chunk = int(chunk)
        self._place(ra, device)


class SymDIAPlan(_BandPlan):
    """Symmetric banded SpMV storing only the diagonals d >= 0: half the
    slab traffic of ``DIAPlan`` on symmetric matrices (admittance and
    B'/B'' matrices are symmetric absent phase shifters).  The lower
    triangle is applied as the mirror of the stored one.

    ``check`` verifies A[i + d, i] == A[i, i + d] against the stored
    negative diagonals within ``tol`` (relative and absolute) and raises
    ValueError otherwise.
    """

    symmetric = True

    def __init__(self, a, chunk: int = 64, check: bool = True,
                 tol: float = 0.0, device=None):
        super().__init__()
        device = resolve_device(device, a)
        d = _as_dia(a)
        self.m, self.n = d.shape
        if self.m != self.n:
            raise ValueError("SymDIAPlan requires a square matrix")
        offs, data = d.np_arrays()
        offs = offs.astype(np.int64)
        m = self.m
        omax = int(offs.max(initial=0))
        omin = int(offs.min(initial=0))
        if omin < -omax or -omin < omax:
            raise ValueError("matrix bandwidth is not symmetric")
        # ra[d, i] = A[i, i + d] for d >= 0 (upper triangle + diagonal)
        ra = np.zeros((omax + 1, m), dtype=data.dtype)
        for t, off in enumerate(offs):
            if off >= 0 and m - off > 0:
                ra[off, : m - off] = data[t, off:m]
        if check:
            # data[t, j] = A[j - off, j]: a negative diagonal must equal
            # its mirror
            for t, off in enumerate(offs):
                if off >= 0:
                    continue
                dd = -off
                if not np.allclose(data[t, : m - dd], ra[dd, : m - dd],
                                   rtol=tol, atol=tol):
                    raise ValueError(
                        "matrix values are not symmetric (diagonal "
                        f"{off}); use DIAPlan, or check=False to skip")
        self.omax = omax
        self.chunk = int(chunk)
        self._place(ra, device)


#: the buffers of the batch entries, on the ``re`` plan of a shared index
_ENTRY_BUFFERS = ("batch_eptr", "batch_col", "batch_re", "batch_im")


def _batch_entries(re):
    """The batch entries ``_share_runs`` gave ``re``."""
    return tuple(getattr(re, name) for name in _ENTRY_BUFFERS)


def _share_runs(re, im) -> bool:
    """Give the two real plans of one complex matrix ONE occupancy index, the
    union of theirs (the real and the imaginary part share a pattern, so the
    two are equal unless a stored value has a zero part), held once on the
    device, and ``re`` the batch entries of the pair (``batch_entries``, the
    batched kernel's lists, float buffers cast with the plan).  Returns
    whether they now share one: not when the matrix is real, when either
    band is dense, or when the union fails the plans' rule."""
    if im is None or not (re.has_runs and im.has_runs):
        return False
    if not all(torch.equal(a, b) for a, b in zip(re.runs, im.runs)):
        union = dia_kernel.merge_run_index(
            *([t.cpu().numpy() for t in p.runs] for p in (re, im)), re.ndiag)
        if not re._set_runs(union):
            return False
        im._set_runs(union)  # the same rule on the same count: it passes
    for name in re._RUN_BUFFERS[: len(re.runs)]:
        setattr(im, name, getattr(re, name))
    with torch.no_grad():
        for name, t in zip(_ENTRY_BUFFERS, dia_kernel.batch_entries(
                re.runs, (re.run_values, im.run_values), re.m, re.n,
                re.omin, re.symmetric)):
            re.register_buffer(name, t)
    return True


def _split_apply(re, im, shared, xr, xi, plain=False):
    """(yr, yi) of the complex band held as the real plans ``re`` / ``im``
    (``im`` None for a real matrix).  With a shared index (``_share_runs``)
    one walk of it serves both slab sets: on CUDA tensors a single launch
    of the split-complex kernel (for a batch, over the batch entries that
    ``re`` holds).  Else each plan is applied once, to the stacked (2, n)
    input."""
    if xr.shape[-1] != re.n:
        raise ValueError(f"dimension mismatch: matrix is ({re.m}, {re.n}), "
                         f"x has {xr.shape[-1]} rows")
    if shared and not plain:
        dtype = torch.promote_types(re.slabs.dtype, xr.dtype)
        return dia_kernel.split_band_spmv(
            re.slabs, im.slabs, xr.to(dtype), xi.to(dtype), re.omin,
            re.symmetric, re.runs, (re.run_values, im.run_values),
            _batch_entries(re))
    return dia_kernel.split_complex_apply(
        functools.partial(re.apply_bn, plain=plain),
        im and functools.partial(im.apply_bn, plain=plain), xr, xi)


class _SplitBand(nn.Module):
    """Split-complex banded SpMV over two real plans ``re`` / ``im``:
    ``forward(xr, xi) -> (yr, yi)`` with the algebra of ``SplitSpMV``, parts
    (n,) or a batch (K, n).  The two plans share one occupancy index where
    they have one (``shared_runs``), and a product then walks it once for
    both: on a CUDA device one launch, for one vector or for the batch
    (whose kernel walks the batch entries of the shared index)."""

    @torch.inference_mode()
    def forward(self, xr, xi):
        return _split_apply(self.re, self.im, self.shared_runs, xr, xi)

    def batch_entries(self):
        """The batched kernel's entries of the shared index
        (``kernels.dia.batch_entries``), built with the plan."""
        return _batch_entries(self.re)

    @torch.inference_mode()
    def plain(self, xr, xi):
        """The plain PyTorch version, on any device: each plan's plain
        walk of its index (or of the whole band), combined."""
        return _split_apply(self.re, self.im, self.shared_runs, xr, xi,
                            plain=True)


class SplitDIA(_SplitBand):
    """Split-complex banded SpMV: a complex matrix as two real DIAPlans."""

    def __init__(self, a, chunk: int = 8, device=None):
        super().__init__()
        device = resolve_device(device, a)
        self.iscomplex, re, im = _split_real(a)
        self.re = DIAPlan(re, chunk=chunk, device=device)
        self.im = None if im is None else DIAPlan(im, chunk=chunk,
                                                  device=device)
        self.shared_runs = _share_runs(self.re, self.im)


class SplitSymDIA(_SplitBand):
    """Split-complex symmetric banded SpMV: a complex-symmetric matrix
    (Ybus is complex symmetric, not hermitian) as two real SymDIAPlans."""

    def __init__(self, a, chunk: int = 64, check: bool = True,
                 tol: float = 0.0, device=None):
        super().__init__()
        device = resolve_device(device, a)
        self.iscomplex, re, im = _split_real(a)
        kw = dict(chunk=chunk, check=check, tol=tol, device=device)
        self.re = SymDIAPlan(re, **kw)
        self.im = None if im is None else SymDIAPlan(im, **kw)
        self.shared_runs = _share_runs(self.re, self.im)
