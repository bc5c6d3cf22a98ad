"""Block operations on BSR matrices, without a round trip through CSC.

The logic is the JAX package's (``csparse3_tpu/ops/bsr_ops.py``).  The block
*pattern* work is O(#blocks) host integer numpy (sorts, merges,
searchsorted: the symbolic phase); the block *value* work is batched torch
ops over the (nblocks, R, C) stacks on the matrix's device:

  transpose  one gather of the block stack and a swap of its block axes
  binop      scatter into stacks aligned to the union pattern, then the
             elementwise operation
  matmat     one batched matrix product over the block pairs (``torch.bmm``,
             in full float32: TF32 off) and one ``index_add_`` into the
             output blocks

``BSRMatMatPlan`` keeps the symbolic result for repeated numeric products
on fixed block patterns.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import get_config, resolve_device
from ..types import BSR
from .matvec import _recorded

__all__ = ["bsr_transpose", "bsr_add", "bsr_binop", "bsr_matmat",
           "BSRMatMatPlan"]


def _block_pattern(a: BSR):
    """(block_rows, block_cols) of the stored blocks, host int64."""
    ip, bc, _ = a.np_arrays()
    br = np.repeat(np.arange(a.mb, dtype=np.int64), np.diff(ip))
    return br, bc.astype(np.int64)


def _indptr_from(rows_sorted, nrows):
    ip = np.zeros(nrows + 1, dtype=get_config().index_dtype)
    ip[1:] = np.cumsum(np.bincount(rows_sorted, minlength=nrows))
    return ip


def _index(arr, device):
    return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.int64),
                           device=device)


def bsr_transpose(a: BSR) -> BSR:
    """Block transpose: the blocks in column-major order, each with its
    axes swapped; one device gather over the stack."""
    br, bc = _block_pattern(a)
    order = np.argsort(bc * a.mb + br, kind="stable")
    data = a.data[: a.nnz_blocks][_index(order, a.device)].transpose(1, 2)
    return BSR(a.n, a.m, a.C, a.R, _indptr_from(bc[order], a.nb),
               br[order].astype(get_config().index_dtype), data.contiguous(),
               nnz_blocks=a.nnz_blocks, device=a.device)


def _union_pattern(a: BSR, b: BSR):
    if a.shape != b.shape or (a.R, a.C) != (b.R, b.C):
        raise ValueError(
            f"BSR binop needs matching shape and block: "
            f"{a.shape}/{a.R}x{a.C} vs {b.shape}/{b.R}x{b.C}")
    bra, bca = _block_pattern(a)
    brb, bcb = _block_pattern(b)
    ka, kb = bra * a.nb + bca, brb * a.nb + bcb
    uni = np.union1d(ka, kb)
    dev = a.device
    return (uni, _index(np.searchsorted(uni, ka), dev),
            _index(np.searchsorted(uni, kb), dev))


def _union_bsr(a: BSR, uni, data) -> BSR:
    # uni is sorted: by block row, then block column
    return BSR(a.m, a.n, a.R, a.C, _indptr_from(uni // a.nb, a.mb),
               (uni % a.nb).astype(get_config().index_dtype), data,
               nnz_blocks=len(uni), device=a.device)


def _aligned(a: BSR, pos, n_union, dtype):
    """a's blocks at their places in the union stack, zeros elsewhere."""
    out = torch.zeros((max(n_union, 1), a.R, a.C), dtype=dtype,
                      device=pos.device)
    out[pos] = a.data[: a.nnz_blocks].to(dtype)
    return out


def bsr_add(a: BSR, b: BSR, alpha=1.0, beta=1.0) -> BSR:
    """alpha*A + beta*B over the union block pattern, on A's device."""
    uni, pa, pb = _union_pattern(a, b)
    b = b.to(a.device)
    dt = torch.promote_types(a.dtype, b.dtype)
    out = alpha * _aligned(a, pa, len(uni), dt)
    out.index_add_(0, pb, beta * b.data[: b.nnz_blocks].to(dt))
    return _union_bsr(a, uni, out)


def bsr_binop(a: BSR, b: BSR, op) -> BSR:
    """Elementwise ``op`` (e.g. ``torch.multiply``, ``torch.maximum``)
    over the union pattern, block by block; a block missing from one
    operand counts as zeros."""
    uni, pa, pb = _union_pattern(a, b)
    b = b.to(a.device)
    dt = torch.promote_types(a.dtype, b.dtype)
    return _union_bsr(a, uni, op(_aligned(a, pa, len(uni), dt),
                                 _aligned(b, pb, len(uni), dt)))


class BSRMatMatPlan(nn.Module):
    """Block-Gustavson C = A @ B on fixed block patterns, placed on
    ``device`` (None: where ``a`` was placed, else the CUDA card).

    Host symbolic: the list of block pairs (which block of A meets which
    block of B) and the output block pattern.  ``numeric(a_data, b_data)``
    on the device: one batched matrix product over the pairs and one sum
    into the output blocks."""

    def __init__(self, a: BSR, b: BSR, device=None):
        super().__init__()
        if a.n != b.m or a.C != b.R:
            raise ValueError(
                f"dim/block mismatch for BSR matmat: {a.shape} "
                f"({a.R}x{a.C}) @ {b.shape} ({b.R}x{b.C})")
        device = resolve_device(device, a)
        bra, bca = _block_pattern(a)
        ipb, bcb, _ = b.np_arrays()
        ipb, bcb = ipb.astype(np.int64), bcb.astype(np.int64)
        counts = ipb[bca + 1] - ipb[bca]
        total = int(counts.sum())
        e = np.repeat(np.arange(len(bca), dtype=np.int64), counts)
        offs = np.concatenate([[0], np.cumsum(counts)])
        bpos = ipb[bca[e]] + (np.arange(total, dtype=np.int64) - offs[e])
        keys = bra[e] * b.nb + bcb[bpos]
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        new = np.ones(total, dtype=bool)
        new[1:] = ks[1:] != ks[:-1]
        uni = ks[new]
        self.m, self.n = a.m, b.n
        self.R, self.Q = a.R, b.C
        self.mb, self.nb = a.mb, b.nb
        self.out_nblocks = len(uni)
        self.indptr = _indptr_from(uni // b.nb, a.mb)
        self.indices = (uni % b.nb).astype(get_config().index_dtype)
        for name, arr in (("pa", e[order]), ("pb", bpos[order]),
                          ("gid", np.cumsum(new) - 1)):
            self.register_buffer(name, _index(arr, device))

    def numeric(self, a_data, b_data) -> BSR:
        """C's blocks from the two block stacks (tensors on the plan's
        device, or numpy).  Differentiable in both stacks when either
        requires a gradient (torch ops, as the JAX package leaves the
        gradient to XLA); any other call runs under inference mode."""
        dev = self.gid.device
        a_data = torch.as_tensor(a_data, device=dev)
        b_data = torch.as_tensor(b_data, device=dev)
        dt = torch.promote_types(a_data.dtype, b_data.dtype)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        with _recorded(a_data, b_data):
            try:
                prod = torch.bmm(a_data[self.pa].to(dt),
                                 b_data[self.pb].to(dt))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            out = torch.zeros((max(self.out_nblocks, 1), self.R, self.Q),
                              dtype=dt, device=dev).index_add_(0, self.gid,
                                                               prod)
        return BSR(self.m, self.n, self.R, self.Q, self.indptr, self.indices,
                   out, nnz_blocks=self.out_nblocks, device=dev)


def bsr_matmat(a: BSR, b: BSR) -> BSR:
    """C = A @ B in block form on A's device: host block-symbolic, batched
    numeric; BSR stays BSR."""
    plan = BSRMatMatPlan(a, b, device=a.device)
    return plan.numeric(a.data[: a.nnz_blocks],
                        b.to(a.device).data[: b.nnz_blocks])
