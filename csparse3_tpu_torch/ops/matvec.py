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

import contextlib
import functools

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..kernels import bsr_spmm as bsr_kernel
from ..kernels import dia as dia_kernel
from ..types import BSR, CSC, DIA
from . import construct

__all__ = ["spmv", "spmm", "bsr_spmm", "bsr_adjoint", "SpMVPlan",
           "SplitSpMV", "dia_spmv", "DIAPlan", "SymDIAPlan", "SplitDIA",
           "SplitSymDIA"]


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


def _wants_grad(*tensors) -> bool:
    """Whether autograd records this call: grad mode on and some input a
    tensor requiring a gradient (None and host arrays require none).
    Every other call runs under inference mode."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _recorded(*tensors):
    """No context when autograd records a call on ``tensors``
    (``_wants_grad``), else inference mode."""
    return (contextlib.nullcontext() if _wants_grad(*tensors)
            else torch.inference_mode())


def _save(ctx, *tensors):
    """Keep ``tensors`` for backward through ``save_for_backward`` (its
    version check raises on an in-place change between forward and
    backward), except inference tensors (plan buffers built under
    inference mode), which cannot be saved and are kept by reference."""
    ctx.save_for_backward(*(None if t.is_inference() else t
                            for t in tensors))
    ctx.kept = [t if t.is_inference() else None for t in tensors]


def _saved(ctx):
    """The tensors ``_save`` kept, in order."""
    return [k if s is None else s for s, k in zip(ctx.saved_tensors,
                                                   ctx.kept)]


def _cast_grad(grad, dtype):
    """``grad`` in an input's ``dtype`` (a real input of a complex product
    takes the real part)."""
    if grad.is_complex() and not dtype.is_complex:
        grad = grad.real
    return grad.to(dtype)


class _StreamSpMV(torch.autograd.Function):
    """y = A x over entry streams (rows, cols, vals), differentiable in the
    values and in x: with g = dL/dy, dL/dx = A^H g and dL/dvals =
    g[rows] conj(x[cols]) (summed over the columns of an (n, k) x), the
    conjugate-Wirtinger convention of torch for complex values."""

    @staticmethod
    def forward(ctx, rows, cols, vals, m, x):
        _save(ctx, rows, cols, vals, x)
        return _stream_product(rows, cols, vals, m, x)

    @staticmethod
    def backward(ctx, g):
        rows, cols, vals, x = _saved(ctx)
        gv = gx = None
        if ctx.needs_input_grad[2]:
            gv = g[rows] * x[cols].conj()
            gv = _cast_grad(gv if gv.ndim == 1 else gv.sum(1), vals.dtype)
        if ctx.needs_input_grad[4]:
            gx = _cast_grad(_stream_product(cols, rows, vals.conj(),
                                            x.shape[0], g), x.dtype)
        return None, None, gv, None, gx


def _stream_spmv(rows, cols, vals, m, x):
    if _wants_grad(vals, x):
        return _StreamSpMV.apply(rows, cols, vals, m, x)
    with torch.inference_mode():
        return _stream_product(rows, cols, vals, m, x)


def spmv(a: CSC, x):
    """y = A @ x on x's device.  A is placed there at the first call (the
    placed copy and its entry streams are kept on ``a``).  Differentiable
    in x and in ``a.data`` when either requires a gradient."""
    _check(a.m, a.n, x)
    a = a.to(x.device)
    rows, cols = a.entry_streams()
    return _stream_spmv(rows, cols, a.data[: a.nnz], a.m, x)


def spmm(a: CSC, X, *, block=None, device=None):
    """Y = A @ X for dense X of shape (n, k), on ``device`` (None: X's
    device for a tensor; for numpy where ``a`` was placed, else the CUDA
    card).  ``block=None`` is the entry-stream product.  ``block=(R, C)``
    packs A to BSR blocks of that shape once, cached on ``a``, and calls
    ``bsr_spmm``: the CUDA kernel on a card, differentiable in X."""
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
    products add up by block row.  X is (n, k) or (n,).  Differentiable in
    X and in the block values ``a.data`` when either requires a gradient
    (``_BSRProduct``); any other call runs under inference mode."""
    a = a.to(X.device)
    data = a.data[: a.nnz_blocks]
    if _wants_grad(data, X):
        return _BSRProduct.apply(a, data, X)
    with torch.inference_mode():
        return _bsr_product(a, data, X)


def _bsr_product(a: BSR, data, X):
    k = a.nnz_blocks
    return bsr_kernel.bsr_spmm(a.m, a.n, a.indptr, a.indices[:k], data, X,
                               a.column_lists())


def bsr_adjoint(a: BSR) -> BSR:
    """A^H in A's own (R, C) blocks, placed where ``a`` is: the stored
    nonzeros gathered on the host, conjugated, transposed and packed again
    (``construct.csc_to_bsr``), so that a product with A^H has the block
    shape, and so the kernel's tiling, of a product with A (the block
    transpose ``ops.bsr_ops.bsr_transpose`` has (C, R) blocks).  Made at the
    first call and kept with ``a``, like its column lists: it holds for the
    values it was made from."""
    if "_adjoint" not in a.__dict__:
        ip, bcols, dat = a.np_arrays()
        p, r, c = np.nonzero(dat)
        brows = np.repeat(np.arange(a.mb, dtype=np.int64), np.diff(ip))
        rows = brows[p] * a.R + r
        cols = bcols[p].astype(np.int64) * a.C + c
        keep = (rows < a.m) & (cols < a.n)
        adj = construct.from_triplets(cols[keep], rows[keep],
                                      np.conj(dat[p, r, c][keep]),
                                      (a.n, a.m))
        a.__dict__["_adjoint"] = construct.csc_to_bsr(
            adj, block=(a.R, a.C)).to(a.device)
    return a.__dict__["_adjoint"]


class _BSRProduct(torch.autograd.Function):
    """Y = A @ X over the BSR ``a`` with block values ``data``,
    differentiable in both: with G = dL/dY, dL/dX = A^H G, one launch of
    the kernel on ``bsr_adjoint(a)`` on a CUDA device, and dL/ddata is
    ``kernels.bsr_spmm.bsr_data_grad`` (every entry of every stored block,
    G's block rows times X's block columns, in plain PyTorch)."""

    @staticmethod
    def forward(ctx, a, data, X):
        ctx.a = a
        _save(ctx, X)
        with torch.inference_mode():
            Y = _bsr_product(a, data, X)
        return Y.clone()

    @staticmethod
    def backward(ctx, G):
        a = ctx.a
        X, = _saved(ctx)
        gd = gx = None
        if ctx.needs_input_grad[1]:
            gd = bsr_kernel.bsr_data_grad(
                a.m, a.n, a.indptr, a.indices[: a.nnz_blocks], a.R, a.C, G,
                X)
            gd = _cast_grad(gd.clone(), a.dtype)
        if ctx.needs_input_grad[2]:
            adj = bsr_adjoint(a)
            with torch.inference_mode():
                gx = _bsr_product(adj, adj.data[: adj.nnz_blocks], G)
            gx = _cast_grad(gx.clone(), X.dtype)
        return None, gd, gx


class _EllSpMV(torch.autograd.Function):
    """y = A x over the ELL slabs (m, W) of ``plan``, differentiable in the
    slab values and in x (as ``_StreamSpMV``); the padded slots get a zero
    gradient."""

    @staticmethod
    def forward(ctx, plan, vals, x):
        ctx.plan = plan
        _save(ctx, vals, x)
        return plan._ell_product(vals, x)

    @staticmethod
    def backward(ctx, g):
        vals, x = _saved(ctx)
        cols = ctx.plan.cols
        gv = gx = None
        if ctx.needs_input_grad[1]:
            xc = x[cols].conj()
            gv = g[:, None] * xc if x.ndim == 1 else (
                g[:, None, :] * xc).sum(-1)
            gv = _cast_grad(gv * ctx.plan.live_slots(), vals.dtype)
        if ctx.needs_input_grad[2]:
            w = vals.conj()
            w = (w * g[:, None]).reshape(-1) if g.ndim == 1 else (
                w[:, :, None] * g[:, None, :]).reshape(-1, g.shape[1])
            gx = torch.zeros((x.shape[0],) + tuple(w.shape[1:]),
                             dtype=w.dtype, device=w.device)
            gx = _cast_grad(gx.index_add_(0, cols.reshape(-1), w), x.dtype)
        return None, gv, gx


class SpMVPlan(nn.Module):
    """Precomputed structure for repeated y = A x with a fixed pattern,
    placed on ``device``; ``forward(x)`` takes (n,) or (n, k).  The values
    ``vals`` are a buffer: set ``plan.vals.requires_grad_()`` (on a plan
    built outside inference mode) and a product is differentiable in them,
    in the plan's layout (the ELL padding gets a zero gradient), as in x."""

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
        self._row_len = counts
        buf("cols", ell_cols)
        buf("vals", ell_vals)

    @property
    def W(self) -> int:
        return self.cols.shape[1] if self.layout == "ell" else 0

    def live_slots(self):
        """(m, W) bool: the ELL slots that hold an entry (made at the first
        call and kept; the gradient of the values reads it)."""
        live = self.__dict__.get("_live")
        if live is None or live.device != self.cols.device:
            row_len = torch.as_tensor(self._row_len, device=self.cols.device)
            self._live = (torch.arange(self.W, device=self.cols.device)
                          < row_len[:, None])
        return self._live

    def _ell_product(self, vals, x):
        if x.ndim == 1:
            # (m, W) gather + dense row reduction, scatter-free
            return (vals * x[self.cols]).sum(dim=1)
        # multi-RHS: one ELL slot at a time keeps the gather at (m, k)
        dtype = torch.promote_types(vals.dtype, x.dtype)
        y = torch.zeros((self.m, x.shape[1]), dtype=dtype, device=x.device)
        for w in range(self.cols.shape[1]):
            y += vals[:, w, None] * x[self.cols[:, w]]
        return y

    def forward(self, x):
        _check(self.m, self.n, x)
        if self.layout == "stream":
            return _stream_spmv(self.rows, self.cols, self.vals, self.m, x)
        if _wants_grad(self.vals, x):
            return _EllSpMV.apply(self, self.vals, x)
        with torch.inference_mode():
            return self._ell_product(self.vals, x)


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

    def forward(self, xr, xi):
        """Differentiable in the parts and in the plans' ``vals`` (through
        ``SpMVPlan``'s own products) when any of them requires a gradient;
        any other call runs under inference mode."""
        with _recorded(xr, xi, self.re.vals, self.im and self.im.vals):
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
        """Register the slabs ``ra`` (host numpy, or a tensor on ``device``)
        there, and their occupancy index as int32 buffers when the listed
        runs are at most ``RUN_SHARE_MAX`` of the runs the dense kernel
        walks.  The rule is
        fixed here, at build: a cast of the values (``float()``) leaves the
        index alone, and cannot turn a zero into a nonzero."""
        self.register_buffer("slabs", torch.as_tensor(ra, device=device))
        self.has_runs = False
        if isinstance(ra, torch.Tensor):
            ra = ra.detach()  # the index of a tensor is built on its device
        self._set_runs(dia_kernel.run_index(ra, self.symmetric))

    @classmethod
    def _from_slabs(cls, slabs, m: int, n: int, omin: int, chunk: int):
        """A plan of this class over (D, m) ``slabs`` (a tensor, on the
        device the plan is to live on) of an (m, n) band whose first offset
        is ``omin`` (0 for the symmetric form), with its own occupancy index
        and packed runs."""
        plan = cls.__new__(cls)
        nn.Module.__init__(plan)
        plan.m, plan.n, plan.chunk = m, n, chunk
        if cls.symmetric:
            plan.omax = slabs.shape[0] - 1
        else:
            plan.omin = omin
        plan._place(slabs, slabs.device)
        return plan

    def transposed(self):
        """The plan of A^T: A itself for the symmetric form, else a
        ``DIAPlan`` over ``kernels.dia.transpose_band`` of the slabs (n rows,
        the offsets negated) with its own occupancy index and packed runs,
        made at the first call and kept.  Like the packed runs it holds for
        the slabs it was made from (a cast or a move of the plan makes it
        again)."""
        if self.symmetric:
            return self
        t = self.__dict__.get("_transposed")
        if _stale(t, self):
            # kept outside the module's children: not part of its state
            t = self.__dict__["_transposed"] = _transposed_plan(
                self, self.slabs.detach())
        return t

    def _set_runs(self, index) -> bool:
        """Take ``index`` (numpy arrays or int32 tensors, as
        ``kernels.dia.run_index`` gives them) for the plan's occupancy index
        if it passes the rule; returns whether it did.  An index that fails
        leaves the plan as it was."""
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
        xbn = x[None, :] if x.ndim == 1 else x.T
        if not plain and _wants_grad(self.slabs, x):
            y = _BandProduct.apply(self, self.slabs, xbn)
        else:
            with torch.inference_mode():
                y = self.apply_bn(xbn, plain)
        return y[0] if x.ndim == 1 else y.T

    def plain(self, x):
        """The plain PyTorch version, on any device."""
        return self._call(x, True)

    def forward(self, x):
        """y = A x for x (n,) or (n, B).  Differentiable in x (through the
        kernel on ``transposed()``) and in ``slabs`` (set
        ``plan.slabs.requires_grad_()`` on a plan built outside inference
        mode: a dense (D, m) gradient, zero where a slab reaches past the
        matrix) when either requires a gradient; any other call runs under
        inference mode."""
        return self._call(x, False)


def _transposed_plan(plan, slabs):
    """A plan over the transpose of the band ``slabs`` laid out as
    ``plan``'s: a ``DIAPlan`` over ``kernels.dia.transpose_band`` of them,
    or, for the symmetric form, a plan over the slabs as they are; with its
    own occupancy index and packed runs."""
    with torch.no_grad():
        if plan.symmetric:
            return type(plan)._from_slabs(slabs, plan.m, plan.n, 0,
                                          plan.chunk)
        slabs, omin = dia_kernel.transpose_band(slabs, plan.m, plan.n,
                                                plan.omin)
        return DIAPlan._from_slabs(slabs, plan.n, plan.m, omin, plan.chunk)


def _stale(made, plan) -> bool:
    """Whether a plan ``made`` from ``plan``'s slabs is missing, or was made
    for another dtype or device (the plan was cast or moved since)."""
    return made is None or made.slabs.dtype != plan.slabs.dtype \
        or made.slabs.device != plan.slabs.device


class _BandProduct(torch.autograd.Function):
    """y (B, m) = A x for x given as (B, n) through the banded ``plan``, the
    layout of ``apply_bn``: the forward reads the packed run values, the
    gradient goes to ``slabs``, whose copy they are.  With g = dL/dy, dL/dx
    = A^H g, one launch of the kernel on ``plan.transposed()`` (A itself
    for the symmetric form) on a CUDA device, and dL/dslabs is
    ``kernels.dia.band_slab_grad`` of g and x, in plain PyTorch."""

    @staticmethod
    def forward(ctx, plan, slabs, xbn):
        ctx.plan = plan
        _save(ctx, xbn)
        with torch.inference_mode():
            y = plan.apply_bn(xbn)
        # a copy made outside inference mode: autograd can return it
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        x, = _saved(ctx)
        gs = gx = None
        if ctx.needs_input_grad[1]:
            gs = _cast_grad(dia_kernel.band_slab_grad(
                g, x, plan.omin, plan.ndiag, plan.symmetric),
                plan.slabs.dtype)
        if ctx.needs_input_grad[2]:
            with torch.inference_mode():
                gx = plan.transposed().apply_bn(g.conj()).conj()
            gx = _cast_grad(gx.clone(), x.dtype)
        return None, gs, gx


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

    def forward(self, xr, xi):
        """Differentiable in the parts and in the two plans' ``slabs`` when
        any of them requires a gradient (``_SplitBandProduct``); any other
        call runs under inference mode."""
        im = self.im and self.im.slabs
        if _wants_grad(xr, xi, self.re.slabs, im):
            return _SplitBandProduct.apply(self, self.re.slabs, im, xr, xi)
        with torch.inference_mode():
            return _split_apply(self.re, self.im, self.shared_runs, xr, xi)

    def adjoint(self):
        """(re, im, shared_runs) of the conjugate transpose A^H = A_r^T -
        1j A_i^T as two real plans over the transposed slabs (the slabs
        themselves for the symmetric form), im's negated once here, with
        one shared index as the plan's own, so that a product with A^H is
        one launch as a product with A is.  Made at the first call and kept,
        like ``_BandPlan.transposed``."""
        if self.im is None:
            return self.re.transposed(), None, False
        adj = self.__dict__.get("_adjoint")
        if _stale(adj and adj[0], self.re):
            re = _transposed_plan(self.re, self.re.slabs.detach())
            im = _transposed_plan(self.im, -self.im.slabs.detach())
            adj = self.__dict__["_adjoint"] = (re, im, _share_runs(re, im))
        return adj

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


class _SplitBandProduct(torch.autograd.Function):
    """(yr, yi) of the split-complex band ``band`` (a ``SplitDIA`` or
    ``SplitSymDIA``) for parts (n,) or (K, n), differentiable in the parts
    and in the two plans' slabs.  With (gr, gi) = dL/d(yr, yi):

      (dxr, dxi) = split(A_r^T, -A_i^T)(gr, gi)   one product with A^H
                                                   (``band.adjoint()``):
                                                   one kernel launch
      dslabs_r   = band_slab_grad of (gr, gi) against (xr, xi)
      dslabs_i   = band_slab_grad of (gr, gi) against (-xi, xr)

    the slab gradients dense, in plain PyTorch, as the JAX package's."""

    @staticmethod
    def forward(ctx, band, re_slabs, im_slabs, xr, xi):
        ctx.band = band
        _save(ctx, xr, xi)
        with torch.inference_mode():
            yr, yi = _split_apply(band.re, band.im, band.shared_runs, xr, xi)
        return yr.clone(), yi.clone()

    @staticmethod
    def backward(ctx, gr, gi):
        band = ctx.band
        xr, xi = _saved(ctx)
        need = ctx.needs_input_grad
        g_re = g_im = dxr = dxi = None
        if need[1] or need[2]:
            m, n = band.re.m, band.re.n
            G = torch.stack([gr, gi]).reshape(-1, m)
            slab_grad = functools.partial(
                dia_kernel.band_slab_grad, omin=band.re.omin,
                ndiag=band.re.ndiag, symmetric=band.re.symmetric)
            if need[1]:
                g_re = _cast_grad(slab_grad(G, torch.stack([xr, xi])
                                            .reshape(-1, n)),
                                  band.re.slabs.dtype)
            if need[2]:
                g_im = _cast_grad(slab_grad(G, torch.stack([-xi, xr])
                                            .reshape(-1, n)),
                                  band.im.slabs.dtype)
        if need[3] or need[4]:
            with torch.inference_mode():
                dxr, dxi = _split_apply(*band.adjoint(), gr, gi)
            dxr = _cast_grad(dxr.clone(), xr.dtype)
            dxi = _cast_grad(dxi.clone(), xi.dtype)
        return None, g_re, g_im, dxr, dxi


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
