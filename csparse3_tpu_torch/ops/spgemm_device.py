"""SpGEMM with expand, sort and compress all on the device (ESC).

The JAX package's ``csparse3_tpu/ops/spgemm_device.py`` in torch ops.  Where
``ops.spgemm`` does the symbolic phase on the host, this runs both phases
on the device per call:

  expand    per intermediate product t, its (A entry, B entry) pair by
            ``searchsorted`` over the pointer arrays: gathers, no host loop
  sort      one stable sort of the fused int64 key col * (m + 1) + row
  compress  run boundaries -> ``cumsum`` ids -> one ``index_add_``; the
            row and column of each output by ``scatter_reduce_('amax')``

The one number from the host is the product count ``total``, the capacity
of every buffer.  The output nnz and pattern are computed on the device,
so a plan built with a larger ``capacity=`` serves new values, and new
patterns whose product count stays within it, without being rebuilt.

``ESCSpGEMM(a, b)(a_data, b_data)`` returns capacity-padded output arrays
and the output nnz as a device scalar; ``spgemm_device(a, b)`` trims them
to a canonical CSC.  The output values are differentiable in both value
arrays, as ``jax.grad`` differentiates the JAX package's: autograd
follows the product gather and the segmented sum (the capacity padding
gets no gradient).  A call where neither requires a gradient runs under
inference mode.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import get_config, resolve_device
from ..types import CSC
from .matvec import _recorded
from . import construct

__all__ = ["ESCSpGEMM", "spgemm_device", "gram_device"]


class ESCSpGEMM(nn.Module):
    """Device ESC plan for C = A @ B, placed on ``device`` (None: where
    ``a`` was placed, else the CUDA card).  Fixed at build time: the shapes,
    the patterns (as device buffers) and the product capacity ``total``."""

    def __init__(self, a: CSC, b: CSC, capacity: int | None = None,
                 device=None):
        super().__init__()
        if a.n != b.m:
            raise ValueError(f"dim mismatch for A@B: {a.shape} @ {b.shape}")
        device = resolve_device(device, a)
        ipa, ixa, _ = a.np_arrays()
        ipb, b_rows, _ = b.np_arrays()
        br = b_rows.astype(np.int64)
        total = int((ipa[br + 1] - ipa[br]).astype(np.int64).sum())
        if capacity is not None:
            if capacity < total:
                raise ValueError(
                    f"capacity {capacity} < product count {total}")
            total = int(capacity)
        self.m, self.n, self.k = a.m, b.n, a.n
        self.total = total
        for name, arr in (("ap", ipa), ("ai", ixa), ("bp", ipb),
                          ("bi", b_rows)):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), device=device))

    def forward(self, a_data, b_data):
        """(a_data, b_data) -> (indptr, rows, data, nnz).

        ``rows`` and ``data`` are padded to ``total``; entries past ``nnz``
        are row id ``m`` and value 0.  ``indptr`` is exact (the padding
        lives in a virtual column n that it drops)."""
        with _recorded(a_data, b_data):
            return self._product(a_data, b_data)

    def _product(self, a_data, b_data):
        m, n, total = self.m, self.n, self.total
        dev, idt = self.ap.device, self.ap.dtype
        a_data = torch.as_tensor(a_data, device=dev)
        b_data = torch.as_tensor(b_data, device=dev)
        dtype = torch.promote_types(a_data.dtype, b_data.dtype)
        nnzb = self.bi.shape[0]
        if total == 0 or nnzb == 0:
            return (torch.zeros(n + 1, dtype=idt, device=dev),
                    torch.full((total,), m, dtype=idt, device=dev),
                    torch.zeros(total, dtype=dtype, device=dev),
                    torch.zeros((), dtype=idt, device=dev))
        ap, ai, bp, bi = (t.long() for t in (self.ap, self.ai, self.bp,
                                             self.bi))
        t = torch.arange(total, device=dev)
        # ---- expand: per product, its (A entry, B entry) pair
        bcol = torch.searchsorted(bp[1:], torch.arange(nnzb, device=dev),
                                  right=True)
        cnt = ap[bi + 1] - ap[bi]
        off_incl = torch.cumsum(cnt, 0)
        # B entry of each product: the first whose inclusive offset exceeds t
        e = torch.searchsorted(off_incl, t, right=True).clamp_(max=nnzb - 1)
        live = t < off_incl[-1]  # the rest is capacity padding
        a_pos = ap[bi[e]] + (t - (off_incl[e] - cnt[e]))
        a_pos = torch.where(live, a_pos, 0)
        vals = torch.where(live, a_data[a_pos].to(dtype) * b_data[e], 0)
        # padding products get an out-of-range key, so they sort last
        rows = torch.where(live, ai[a_pos], m)
        cols = torch.where(live, bcol[e], n)
        # ---- sort
        key_s, order = torch.sort(cols * (m + 1) + rows, stable=True)
        v_s = vals[order]
        r_s, c_s = key_s % (m + 1), key_s // (m + 1)
        # ---- compress
        pad_s = (r_s == m) | (c_s == n)
        new = torch.ones(total, dtype=torch.bool, device=dev)
        new[1:] = key_s[1:] != key_s[:-1]
        new &= ~pad_s
        gid = torch.cumsum(new, 0) - 1
        nnz = gid[-1] + 1
        seg = gid.clamp(min=0)
        data = torch.zeros(total, dtype=dtype, device=dev).index_add_(
            0, seg, torch.where(pad_s, 0, v_s))

        def seg_max(x):
            out = torch.full((total,), -1, dtype=torch.int64, device=dev)
            return out.scatter_reduce_(0, seg, torch.where(pad_s, -1, x),
                                       "amax")

        # segments past nnz are empty: mark them as padding
        pad_out = t >= nnz
        rows_u = torch.where(pad_out, m, seg_max(r_s)).to(idt)
        cols_u = torch.where(pad_out, n, seg_max(c_s))
        data = torch.where(pad_out, 0, data)
        hist = torch.bincount(cols_u, minlength=n + 1)[:n]
        indptr = torch.zeros(n + 1, dtype=idt, device=dev)
        indptr[1:] = torch.cumsum(hist, 0)
        return indptr, rows_u, data, nnz.to(idt)


def spgemm_device(a: CSC, b: CSC, device=None) -> CSC:
    """C = A @ B with expand, sort and compress on the device; the result is
    read back once and trimmed to a canonical CSC.  For repeated products
    hold an ``ESCSpGEMM`` and use its padded output directly."""
    plan = ESCSpGEMM(a, b, device=device)
    dev = plan.ap.device
    indptr, rows, data, nnz = plan(a.to(dev).data[: a.nnz],
                                   b.to(dev).data[: b.nnz])
    nnz = int(nnz)
    idx = np.dtype(get_config().index_dtype)
    return CSC(a.m, b.n, indptr.cpu().numpy().astype(idx, copy=False),
               rows[:nnz].cpu().numpy().astype(idx, copy=False),
               data[:nnz].cpu().numpy(), canonical=True, device=dev)


def gram_device(a: CSC, device=None) -> CSC:
    """A @ A.T on the device (the GridCal connectivity product), by ESC
    with the host-transposed matrix as B."""
    return spgemm_device(a, construct.transpose(a), device=device)
