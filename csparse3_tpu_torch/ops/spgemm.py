"""SpGEMM: C = A @ B, two-phase (symbolic + numeric).

The logic is the JAX package's (``csparse3_tpu/ops/spgemm.py``).  The eager
products ``spgemm`` and ``gram`` are host work (the output nnz depends on
the data): float and complex values go through the native Gustavson
kernels, integers through an exact numpy triplet path.  For repeated
products on a fixed pattern the formulation is expand, sort, compress:

  expand    every entry B[k, j] replicates column A[:, k] scaled by it: a
            stream of (row, col, value) partial products
  sort      stable sort of the stream by (col, row)
  compress  sum the runs of equal (row, col)

``spgemm_symbolic`` does expand and sort once on the host and keeps, per
product in sorted order, the entry of A (``pa_s``) and of B (``pb_s``) it
multiplies and the output it belongs to (``gid``, and ``seg_ptr``, the
start of each output's run).  ``SpGEMMPlan.numeric`` is then one pass on
the plan's device, ``kernels.spgemm.spgemm_numeric``: the CUDA kernel on a
card, its plain version on the CPU.  ``GramPlan`` is the same for C = A @
A.T with the symmetry folded in: products are formed for the lower
triangle of C only (half the stream), the same kernel sums them, and one
``index_select`` through ``sel_full`` mirrors the lower values into the
full pattern.

Both numeric passes are differentiable in the value arrays when one of them
requires a gradient (any other call runs under inference mode).  The
gradient of a numeric pass is a numeric pass too: with g = dL/ddata,

  dL/da_vals[p] = sum over the products t with pa[t] = p of
                  g[gid[t]] conj(b_vals[pb[t]])

the same kernel over the product stream sorted by entry of A (maps made on
the host at the first backward and kept, ``_NumericPlan.grad_maps``), and
dL/db_vals likewise by entry of B.  ``GramPlan`` gets both launches on A's
one array, after ``index_select``'s own backward folded the full output's
gradient into the lower slots.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import get_config, resolve_device
from ..kernels.spgemm import spgemm_numeric
from ..types import CSC
from . import construct
from .matvec import _cast_grad, _save, _saved, _wants_grad

__all__ = ["spgemm", "spgemm_symbolic", "SpGEMMPlan", "gram",
           "gram_symbolic", "GramPlan"]


def _expanded_streams_np(a: CSC, b: CSC):
    """Expansion phase (host): per intermediate product t, indices into A's
    and B's entry arrays.  Returns (a_pos, b_pos, out_cols, total)."""
    ipa, _, _ = a.np_arrays()
    ipb, b_rows, _ = b.np_arrays()
    b_cols = construct.expand_indptr_np(ipb)
    # products contributed by each B entry = nnz of that A column
    counts = (ipa[b_rows + 1] - ipa[b_rows]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return None, None, None, 0
    offsets = np.concatenate([[0], np.cumsum(counts)])
    e = np.repeat(np.arange(len(b_rows), dtype=np.int64), counts)
    local = np.arange(total, dtype=np.int64) - offsets[e]
    a_pos = ipa[b_rows[e]].astype(np.int64) + local
    return a_pos, e, b_cols[e], total


def _inexact(*arrays) -> bool:
    return np.issubdtype(np.result_type(*arrays), np.inexact)


def spgemm(a: CSC, b: CSC) -> CSC:
    """C = A @ B for general dimensions (host; the output nnz depends on the
    data).  For repeated products on a fixed pattern use ``spgemm_symbolic``
    and ``SpGEMMPlan.numeric``.  Float and complex values take the native
    kernel; integer values the numpy triplet path, exact in their dtype."""
    if a.n != b.m:
        raise ValueError(f"dim mismatch for A@B: {a.shape} @ {b.shape}")
    a = a if a.canonical else construct.canonicalize(a)
    b = b if b.canonical else construct.canonicalize(b)
    ipa, ixa, dta = a.np_arrays()
    ipb, ixb, dtb = b.np_arrays()
    if _inexact(dta, dtb):
        from ..native import host_ext

        Cp, Ci, Cx = host_ext.csc_spgemm(a.m, ipa, ixa, dta, b.n, ipb, ixb,
                                         dtb)
        idx = np.dtype(get_config().index_dtype)
        return CSC(a.m, b.n, Cp.astype(idx, copy=False),
                   Ci.astype(idx, copy=False),
                   Cx.astype(np.result_type(dta, dtb), copy=False),
                   canonical=True, device=a._device)
    a_pos, b_pos, out_cols, total = _expanded_streams_np(a, b)
    if total == 0:
        return construct._empty_csc(a.m, b.n, np.result_type(dta, dtb),
                                    a._device)
    return construct.from_triplets(ixa[a_pos], out_cols,
                                   dta[a_pos] * dtb[b_pos], (a.m, b.n),
                                   device=a._device)


def gram(a: CSC) -> CSC:
    """A @ A.T, the GridCal connectivity product (host).

    Float and complex values: one fused native kernel (lower-half Gustavson
    and a sorted mirror), no explicit transpose.  Its symbolic phase (the
    pattern of A^T and of the output) is cached on the container as
    ``_gram_sym``: a repeated gram of the same matrix runs the numeric pass
    alone.  Containers are immutable, so the cache cannot go stale.
    Integer values: ``spgemm(a, a.T)``."""
    a = a if a.canonical else construct.canonicalize(a)
    ip, rows, vals = a.np_arrays()
    if not _inexact(vals):
        return spgemm(a, construct.transpose(a))
    from ..native import host_ext

    idx = np.dtype(get_config().index_dtype)
    sym = getattr(a, "_gram_sym", None)
    if sym is not None and sym["vdt"] == host_ext._host_vdt(
            np.iscomplexobj(vals), vals):
        Cx = host_ext.csc_gram_revalue(ip, rows, vals, sym)
        Cp, Ci, Cx = sym["Cp"], sym["Ci"][:sym["nnz"]], Cx[:sym["nnz"]]
    else:
        Cp, Ci, Cx, a._gram_sym = host_ext.csc_gram_cached(
            a.m, a.n, ip, rows, vals)
    return CSC(a.m, a.m, Cp.astype(idx, copy=False),
               Ci.astype(idx, copy=False), Cx.astype(vals.dtype, copy=False),
               canonical=True, device=a._device)


def _sorted_products(rows, out_cols, m):
    """Sort the product stream by (col, row) and find the runs: returns
    (perm, r_s, c_s, new, gid) with ``new`` the first product of each
    output and ``gid`` each product's output id."""
    # fused-key stable argsort: numpy's stable integer sort is radix
    perm = np.argsort(out_cols.astype(np.int64) * m + rows, kind="stable")
    r_s, c_s = rows[perm], out_cols[perm]
    new = np.empty(len(perm), dtype=bool)
    new[0] = True
    new[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    return perm, r_s, c_s, new, np.cumsum(new) - 1


def _seg_ptr(gid, n_out):
    """Start of each output's run in a sorted id stream, plus the end:
    (n_out + 1,) int32; empty outputs (none arise from a symbolic phase)
    and an empty stream give zero-length runs."""
    return np.searchsorted(gid, np.arange(n_out + 1)).astype(np.int32)


def _template(m, n, u_rows, u_cols, dtype, device) -> CSC:
    idx = np.dtype(get_config().index_dtype)
    indptr = np.zeros(n + 1, dtype=idx)
    indptr[1:] = np.cumsum(np.bincount(u_cols, minlength=n))
    return CSC(m, n, indptr, u_rows.astype(idx),
               np.zeros(len(u_rows), dtype=dtype), device=device)


class _NumericPlan(nn.Module):
    """The product stream of a frozen pattern, on ``device``: int32 maps
    ``pa_s`` / ``pb_s`` (sorted product -> entry of A / of B), ``gid``
    (-> output id) and ``seg_ptr`` (output -> its first product)."""

    def __init__(self, pa_s, pb_s, gid, n_out, template: CSC, device):
        super().__init__()
        if len(gid) >= 2 ** 31:
            raise OverflowError(f"{len(gid)} products exceed the int32 maps")
        self.template = template  # the output's pattern, data zeros
        self.n_products = len(gid)
        for name, arr in (("pa_s", pa_s), ("pb_s", pb_s), ("gid", gid),
                          ("seg_ptr", _seg_ptr(gid, n_out))):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr, dtype=np.int32), device=device))

    @property
    def device(self) -> torch.device:
        return self.seg_ptr.device

    def _values(self, v):
        """A tensor as it is (it must lie on the plan's device), anything
        else as a tensor on the plan's device."""
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.asarray(v), device=self.device)

    def _sums(self, a_vals, b_vals):
        return spgemm_numeric(self.seg_ptr, self.gid, self.pa_s, self.pb_s,
                              a_vals, b_vals)

    def grad_maps(self, side: int, n_vals: int):
        """(seg_ptr, gid, pa, pb) of the numeric pass whose outputs are the
        ``n_vals`` entries of A (``side`` 0) or of B (1): the products
        sorted (stably) by that entry, ``gid`` the entry, ``pa`` the output
        each product adds to and ``pb`` its entry of the other operand.
        Made on the host at the first call and kept, int32 on the plan's
        device."""
        key = (side, n_vals)
        maps = self.__dict__.setdefault("_grad_maps", {})
        if key not in maps:
            own, other = ((self.pa_s, self.pb_s) if side == 0
                          else (self.pb_s, self.pa_s))
            own = own.cpu().numpy()
            order = np.argsort(own, kind="stable")
            gid = own[order]
            host = (_seg_ptr(gid, n_vals), gid,
                    self.gid.cpu().numpy()[order],
                    other.cpu().numpy()[order])
            maps[key] = tuple(torch.as_tensor(
                np.ascontiguousarray(a, dtype=np.int32), device=self.device)
                for a in host)
        return maps[key]

    def _result(self, data) -> CSC:
        t = self.template
        ip, ix, _ = t.np_arrays()
        return CSC(t.m, t.n, ip, ix, data, nnz=t.nnz, canonical=True,
                   device=self.device)


class SpGEMMPlan(_NumericPlan):
    """Reusable plan for C = A @ B with fixed patterns
    (``spgemm_symbolic``).  ``numeric(a_vals, b_vals)`` takes the two value
    arrays (tensors on the plan's device, or numpy) and returns C on that
    device, its pattern ``template``'s."""

    @property
    def out_nnz(self) -> int:
        return self.template.nnz

    def numeric(self, a_vals, b_vals) -> CSC:
        """C's values from A's and B's (differentiable in both)."""
        a_vals, b_vals = self._values(a_vals), self._values(b_vals)
        if _wants_grad(a_vals, b_vals):
            return self._result(_Numeric.apply(self, a_vals, b_vals))
        with torch.inference_mode():
            return self._result(self._sums(a_vals, b_vals))


class _Numeric(torch.autograd.Function):
    """data = the numeric pass of ``plan`` on (a_vals, b_vals),
    differentiable in both: each gradient is one more numeric pass, over
    ``plan.grad_maps`` (see the module docstring), on g and the other
    operand's conjugated values."""

    @staticmethod
    def forward(ctx, plan, a_vals, b_vals):
        ctx.plan = plan
        _save(ctx, a_vals, b_vals)
        with torch.inference_mode():
            data = plan._sums(a_vals, b_vals)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        vals = _saved(ctx)
        grads = [None, None]
        for side in (0, 1):
            if not ctx.needs_input_grad[1 + side]:
                continue
            own, other = vals[side], vals[1 - side]
            seg_ptr, gid, pa, pb = plan.grad_maps(side, own.shape[0])
            with torch.inference_mode():
                d = spgemm_numeric(seg_ptr, gid, pa, pb, g,
                                   other.conj().resolve_conj())
            grads[side] = _cast_grad(d.clone(), own.dtype)
        return None, *grads


def spgemm_symbolic(a: CSC, b: CSC, device=None) -> SpGEMMPlan:
    """Symbolic phase: the exact output pattern and the sorted product
    stream, placed on ``device`` (None: where ``a`` was placed, else the
    CUDA card)."""
    if a.n != b.m:
        raise ValueError(f"dim mismatch for A@B: {a.shape} @ {b.shape}")
    device = resolve_device(device, a)
    a_pos, b_pos, out_cols, total = _expanded_streams_np(a, b)
    dtype = np.result_type(a.np_arrays()[2].dtype, b.np_arrays()[2].dtype)
    z = np.zeros(0, dtype=np.int64)
    if total == 0:
        return SpGEMMPlan(z, z, z, 0, _template(a.m, b.n, z, z, dtype,
                                                device), device)
    rows = a.np_arrays()[1][a_pos]
    perm, r_s, c_s, new, gid = _sorted_products(rows, out_cols, a.m)
    template = _template(a.m, b.n, r_s[new], c_s[new], dtype, device)
    return SpGEMMPlan(a_pos[perm], b_pos[perm], gid, template.nnz, template,
                      device)


class GramPlan(_NumericPlan):
    """Reusable plan for C = A @ A.T that forms products for the lower
    triangle of C only (``gram_symbolic``).  ``numeric(a_vals)`` takes A's
    value array alone: the transpose's values are the same array through
    the host-composed transpose permutation folded into ``pb_s``.  The
    kernel sums the lower-triangle stream; ``sel_full`` (full output slot
    -> lower output) then mirrors it, so each lower value is read twice
    instead of a second product pass."""

    def __init__(self, pa_l, pb_l, gl, n_lower, sel_full, template, device):
        super().__init__(pa_l, pb_l, gl, n_lower, template, device)
        self.register_buffer("sel_full", torch.as_tensor(
            np.ascontiguousarray(sel_full, dtype=np.int32), device=device))

    @property
    def out_nnz(self) -> int:
        return self.template.nnz

    def numeric(self, a_vals) -> CSC:
        """C's values from A's (differentiable in them)."""
        a_vals = self._values(a_vals)
        if _wants_grad(a_vals):
            lower = _Numeric.apply(self, a_vals, a_vals)
            return self._result(lower.index_select(0, self.sel_full))
        with torch.inference_mode():
            lower = self._sums(a_vals, a_vals)
            return self._result(lower.index_select(0, self.sel_full))


def gram_symbolic(a: CSC, device=None) -> GramPlan:
    """Symbolic phase for C = A @ A.T with the symmetry folded into the
    maps (see ``GramPlan``), placed like ``spgemm_symbolic``."""
    device = resolve_device(device, a)
    a = a if a.canonical else construct.canonicalize(a)
    # transpose with value tracking: B.data = A.data[tperm]
    ipa, ixa, dta = a.np_arrays()
    nnz_a = len(ixa)
    bt = construct.transpose(CSC(a.m, a.n, ipa, ixa,
                                 np.arange(nnz_a, dtype=np.float64)))
    ipb, ixb, tpf = bt.np_arrays()
    tperm = np.asarray(tpf, dtype=np.int64)
    b = CSC(a.n, a.m, ipb, ixb, np.zeros(nnz_a, dta.dtype))
    a_pos, b_pos, out_cols, total = _expanded_streams_np(a, b)
    z = np.zeros(0, dtype=np.int64)
    if total == 0:
        return GramPlan(z, z, z, 0, z, _template(a.m, a.m, z, z, dta.dtype,
                                                 device), device)
    m = a.m
    perm, r_s, c_s, new, gid = _sorted_products(ixa[a_pos], out_cols, m)
    u_rows = r_s[new].astype(np.int64)
    u_cols = c_s[new].astype(np.int64)
    template = _template(m, m, u_rows, u_cols, dta.dtype, device)

    # the lower-triangle product stream (whole runs: gid-uniform)
    lower_prod = r_s >= c_s
    lower_out = u_rows >= u_cols
    lower_rank = np.cumsum(lower_out) - 1       # full slot -> lower rank
    pa_l = a_pos[perm][lower_prod]
    pb_l = tperm[b_pos[perm][lower_prod]]       # B.data = A.data[tperm]
    gl = lower_rank[gid[lower_prod]]
    # the mirror: slots are sorted by key col*m + row, and the partner of
    # (r, c) is (c, r)
    key = u_cols * m + u_rows
    partner = np.searchsorted(key, u_rows * m + u_cols)
    src_slot = np.where(lower_out, np.arange(len(key)), partner)
    return GramPlan(pa_l, pb_l, gl, int(lower_out.sum()),
                    lower_rank[src_slot], template, device)
