"""BSR matrix times dense matrix, Y = A @ X: the CUDA kernel, its wrapper
and its plain PyTorch version.

A is block sparse row: ``data`` (nblocks, R, C) dense blocks, ``indptr``
(mb + 1) and ``indices`` (block columns) their block-CSR pattern, for an
(m, n) matrix zero-padded to (mb*R, nb*C).  X is (n, k), or (n,) for one
vector; Y has X's form.

On an H100 a matrix that has blocks is bound by float32 operations, and a
matrix without them (a power-grid matrix in (8, 128) blocks is 99% padding)
by the rows of X its zero columns make it read.  So a product may be given
**column lists** (``column_lists``: for each stored block the sorted columns
c that hold a nonzero in any of its R rows, ``col_ptr`` (nblocks + 1) and
``col_idx``, both int32): the kernel and the plain version then visit a
block's listed columns only, and a block whose list is full is walked
densely with no list read.  The lists are structure derived from values:
they hold for the ``data`` they were built from and go stale if that is
changed in place, which nothing in this package does (``ops.bsr_ops`` and
the container's operators return new containers).  ``types.BSR`` builds
them once and keeps them with the placed container.

``bsr_spmm_cuda`` launches the hand-written kernel ``csrc/bsr_spmm.cu``
(built with nvcc at first use), which stands for the Pallas kernel of the
JAX package's ``csparse3_tpu/kernels/bsr_spmm_pallas.py``.
``bsr_spmm_plain`` is the same function in plain PyTorch: gather the rows
of X each block meets, one batched ``einsum('brc,bck->brk')`` (with lists:
one product per listed column), and ``index_add_`` by block row; it walks
the blocks in chunks, so that the gathered rows stay within
``PLAIN_GATHER_BYTES`` however many blocks there are.  ``bsr_spmm`` picks
between them by where its input lies: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel or raises.  Float32 and float64 on the
card; the result has the promoted dtype of ``data`` and X.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.build import build_cuda_library

__all__ = ["bsr_spmm", "bsr_spmm_cuda", "bsr_spmm_plain", "bsr_data_grad",
           "column_lists", "load_cuda_library", "LAUNCHES",
           "PLAIN_GATHER_BYTES"]

#: kernel launches made by ``bsr_spmm_cuda`` since import (or since a caller
#: set it to 0): one per launch, nowhere else
LAUNCHES = {"bsr_spmm": 0}

#: most bytes of X rows the plain version gathers at a time
PLAIN_GATHER_BYTES = 1 << 30

_DTYPES = (torch.float32, torch.float64)
_INDEX_DTYPES = (torch.int32, torch.int64)


@functools.cache
def load_cuda_library():
    """Build ``csrc/bsr_spmm.cu`` with nvcc for sm_90a (first use) and load
    it.  Returns the ctypes library; raises BuildError when nvcc is missing
    or refuses the source."""
    lib = ctypes.CDLL(build_cuda_library("bsr_spmm"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bsr_spmm.restype = ci
    lib.bsr_spmm.argtypes = [ci] * 7 + [vp] * 8
    lib.bsr_spmm_error_string.restype = ctypes.c_char_p
    lib.bsr_spmm_error_string.argtypes = [ci]
    return lib


def column_lists(data):
    """The occupied columns of (nblocks, R, C) block values given as a numpy
    array, on the host: ``(col_ptr, col_idx)`` int32 numpy arrays, where
    ``col_idx[col_ptr[p]:col_ptr[p + 1]]`` are, ascending, the columns c of
    block p with a nonzero in ``data[p, :, c]``."""
    occupied = (data != 0).any(axis=1)
    if occupied.sum() >= 2 ** 31:
        raise ValueError("the occupied block columns do not fit the int32 "
                         "lists of the BSR kernel")
    col_ptr = np.zeros(len(data) + 1, dtype=np.int32)
    np.cumsum(occupied.sum(axis=1), out=col_ptr[1:])
    return col_ptr, np.nonzero(occupied)[1].astype(np.int32)


def _check(m, n, indptr, indices, data, X, cols=None):
    if data.ndim != 3 or indptr.ndim != 1 or indices.ndim != 1 \
            or X.ndim not in (1, 2):
        raise ValueError(
            "bsr_spmm takes data (nblocks, R, C), 1-D indptr and indices "
            f"and X (n,) or (n, k); got {tuple(data.shape)}, "
            f"{tuple(indptr.shape)}, {tuple(indices.shape)}, "
            f"{tuple(X.shape)}")
    R, C = data.shape[1:]
    if X.shape[0] != n:
        raise ValueError(f"dimension mismatch: matrix is ({m}, {n}), "
                         f"X has leading dimension {X.shape[0]}")
    if indptr.shape[0] != -(-m // R) + 1 or \
            data.shape[0] < indices.shape[0]:
        raise ValueError(
            f"BSR arrays do not fit: m={m}, R={R}, indptr "
            f"{tuple(indptr.shape)}, indices {tuple(indices.shape)}, data "
            f"{tuple(data.shape)}")
    if cols is not None and (
            len(cols) != 2 or any(t.dtype != torch.int32 or t.ndim != 1
                                  for t in cols)
            or cols[0].shape[0] != indices.shape[0] + 1):
        raise ValueError(
            "the column lists are (col_ptr, col_idx), int32, with one "
            f"pointer more than the {indices.shape[0]} stored blocks")


@torch.inference_mode()
def bsr_spmm_plain(m, n, indptr, indices, data, X, cols=None):
    """The plain PyTorch version, on any device: Y (m, k), or (m,) for X
    (n,), in the promoted dtype of ``data`` and X.  With ``cols`` (the
    column lists) only the listed columns of each block and the rows of X
    they meet are gathered."""
    _check(m, n, indptr, indices, data, X, cols)
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    nbk = indices.shape[0]
    R, C = data.shape[1:]
    mb, nb, k = indptr.shape[0] - 1, -(-n // C), X.shape[1]
    dtype = torch.promote_types(data.dtype, X.dtype)
    Xb = torch.zeros((nb * C, k), dtype=dtype, device=X.device)
    Xb[:n] = X
    brows = torch.repeat_interleave(
        torch.arange(mb, device=X.device), indptr.long().diff(),
        output_size=nbk)  # the size given: no wait for the device
    Yb = torch.zeros((mb, R, k), dtype=dtype, device=X.device)
    if cols is None:
        Xb = Xb.view(nb, C, k)
        step = max(1, PLAIN_GATHER_BYTES // max(1, C * k * Xb.element_size()))
        for p0 in range(0, nbk, step):
            p1 = min(nbk, p0 + step)
            # (b, R, C) @ (b, C, k) -> (b, R, k), summed by block row
            prod = torch.einsum("brc,bck->brk", data[p0:p1].to(dtype),
                                Xb[indices[p0:p1].long()])
            Yb.index_add_(0, brows[p0:p1], prod)
    else:
        col_ptr, col_idx = cols
        nlist = col_idx.shape[0]
        blk = torch.repeat_interleave(
            torch.arange(nbk, device=X.device), col_ptr.long().diff(),
            output_size=nlist)  # the block of each listed column
        c = col_idx.long()
        xrow = indices.long()[blk] * C + c
        step = max(1, PLAIN_GATHER_BYTES // max(1, R * k * Xb.element_size()))
        for e0 in range(0, nlist, step):
            e = slice(e0, min(nlist, e0 + step))
            # (e, R, 1) * (e, 1, k): one listed column times its row of X
            prod = data[blk[e], :, c[e]].to(dtype)[:, :, None] \
                * Xb[xrow[e]][:, None, :]
            Yb.index_add_(0, brows[blk[e]], prod)
    Y = Yb.view(mb * R, k)[:m]
    return Y[:, 0] if squeeze else Y


@torch.inference_mode()
def bsr_spmm_cuda(m, n, indptr, indices, data, X, cols=None):
    """The CUDA kernel: Y (m, k), or (m,) for X (n,), for float32 or
    float64 ``data`` and X (promoted to their common dtype) and int32 or
    int64 ``indptr`` and ``indices`` of one dtype, all on one CUDA device.
    With ``cols`` (the int32 column lists, on that device) a block is
    walked through its listed columns.  One launch; Y is written whole,
    zeros included."""
    _check(m, n, indptr, indices, data, X, cols)
    dev = data.device
    tensors = (indptr, indices, data, X) + tuple(cols or ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("bsr_spmm_cuda needs the BSR arrays, the column "
                         "lists and X on one CUDA device; got "
                         + ", ".join(str(t.device) for t in tensors))
    if data.dtype not in _DTYPES or X.dtype not in _DTYPES:
        raise TypeError("bsr_spmm_cuda takes float32 or float64 data and X; "
                        f"got {data.dtype} and {X.dtype}")
    if indptr.dtype not in _INDEX_DTYPES or indices.dtype != indptr.dtype:
        raise TypeError("bsr_spmm_cuda takes int32 or int64 indptr and "
                        f"indices of one dtype; got {indptr.dtype} and "
                        f"{indices.dtype}")
    lib = load_cuda_library()
    dtype = torch.promote_types(data.dtype, X.dtype)
    squeeze = X.ndim == 1
    x = (X[:, None] if squeeze else X).to(dtype).contiguous()
    data = data.to(dtype).contiguous()
    indptr, indices = indptr.contiguous(), indices.contiguous()
    lists = [None, None] if cols is None else [t.contiguous() for t in cols]
    R, C = data.shape[1:]
    k = x.shape[1]
    y = torch.empty((m, k), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.bsr_spmm(
            data.element_size(), indptr.element_size(), m, n, k, R, C,
            indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
            *(t if t is None else t.data_ptr() for t in lists),
            x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("bsr_spmm launch failed: "
                           f"{lib.bsr_spmm_error_string(err).decode()}")
    if m and k:
        LAUNCHES["bsr_spmm"] += 1
    return y[:, 0] if squeeze else y


@torch.inference_mode()
def bsr_data_grad(m, n, indptr, indices, R, C, G, X):
    """The gradient of the (nblocks, R, C) block values of Y = A @ X, in
    plain PyTorch, for dL/dY = G (m, k) and X (n, k) (or (m,) and (n,)):
    each stored block p at (block row br, block column bc) gets

        G[br*R : br*R + R] @ conj(X[bc*C : bc*C + C])^T

    (rows past m and columns past n count as zeros), every entry of the
    block, zeros included, as ``jax.grad`` of the JAX package's block
    product gives it.  A batched product (``torch.bmm``, TF32 off) over the
    blocks in chunks, the gathered rows within ``PLAIN_GATHER_BYTES``."""
    if G.ndim == 1:
        G, X = G[:, None], X[:, None]
    nbk = indices.shape[0]
    mb, nb, k = indptr.shape[0] - 1, -(-n // C), G.shape[1]
    dtype = torch.promote_types(G.dtype, X.dtype)
    Gb = torch.zeros((mb * R, k), dtype=dtype, device=G.device)
    Gb[:m] = G
    Xb = torch.zeros((nb * C, k), dtype=dtype, device=G.device)
    Xb[:n] = X.conj()
    Gb, Xb = Gb.view(mb, R, k), Xb.view(nb, C, k)
    brows = torch.repeat_interleave(
        torch.arange(mb, device=G.device), indptr.long().diff(),
        output_size=nbk)
    bcols = indices.long()
    out = torch.empty((nbk, R, C), dtype=dtype, device=G.device)
    step = max(1, PLAIN_GATHER_BYTES // max(1, (R + C) * k
                                               * Gb.element_size()))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for p0 in range(0, nbk, step):
            p = slice(p0, min(nbk, p0 + step))
            torch.bmm(Gb[brows[p]], Xb[bcols[p]].mT, out=out[p])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def bsr_spmm(m, n, indptr, indices, data, X, cols=None):
    """Y = A @ X for A (m, n) given by its BSR arrays, and by its column
    lists where the caller has them: the plain version for CPU tensors, the
    CUDA kernel otherwise."""
    if data.device.type == "cpu" and X.device.type == "cpu":
        return bsr_spmm_plain(m, n, indptr, indices, data, X, cols)
    return bsr_spmm_cuda(m, n, indptr, indices, data, X, cols)
