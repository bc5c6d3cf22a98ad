"""SpMV.

``spmv`` is the entry-stream product y[row] += val * x[col] with
``index_add_``.  ``SpMVPlan`` precomputes the layout once for repeated
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
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..types import CSC
from . import construct

__all__ = ["spmv", "SpMVPlan", "SplitSpMV"]


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
    """y = A @ x on x's device (A is placed there)."""
    _check(a.m, a.n, x)
    a = a.to(x.device)
    k = a.nnz
    cols = torch.as_tensor(construct.expand_indptr_np(a.np_arrays()[0]),
                           dtype=torch.int64, device=x.device)
    return _stream_product(a.indices[:k].long(), cols, a.data[:k], a.m, x)


class SpMVPlan(nn.Module):
    """Precomputed structure for repeated y = A x with a fixed pattern,
    placed on ``device``; ``forward(x)`` takes (n,) or (n, k)."""

    def __init__(self, a: CSC, layout: str | None = None,
                 max_waste: float = 4.0, device=None):
        super().__init__()
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

    ``forward(xr, xi) -> (yr, yi)``.  For a real matrix A_i is dropped and
    the two products collapse to one.
    """

    def __init__(self, a: CSC, layout: str | None = None, device=None):
        super().__init__()
        ip, rows, vals = a.np_arrays()
        self.iscomplex = np.iscomplexobj(vals)
        re = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.real),
                 canonical=a.canonical)
        self.re = SpMVPlan(re, layout=layout, device=device)
        if self.iscomplex:
            im = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.imag),
                     canonical=a.canonical)
            self.im = SpMVPlan(im, layout=layout, device=device)
        else:
            self.im = None

    @torch.inference_mode()
    def forward(self, xr, xi):
        if self.im is None:
            return self.re(xr), self.re(xi)
        return (self.re(xr) - self.im(xi), self.re(xi) + self.im(xr))
