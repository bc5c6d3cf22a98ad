"""Banded (DIA-slab) SpMV: the CUDA kernels, their wrapper and their plain
PyTorch versions.

The matrix is a dense range of D diagonals, row aligned (the layout of
``ops.matvec.DIAPlan``): ``slabs[d, i] = A[i, i + omin + d]``.  Vectors
are carried as (B, m): batch first, rows last.

    general:    y[b, i] = sum_d slabs[d, i] * x[b, i + omin + d]
    symmetric:  only the diagonals d >= 0 of a symmetric matrix are stored
                (omin = 0) and the strict lower triangle is their mirror,
                y[b, i] += sum_{d > 0} slabs[d, i - d] * x[b, i - d]

On an H100 the product is bound by the bytes of the slabs, and the band of
an RCM-ordered power grid is almost all zeros (0.3% nonzeros at 200k buses).
So a plan carries an **occupancy index**, built once on the host
(``run_index``): rows are cut into groups of ``RUN_ROWS`` consecutive rows,
and for each group the index lists, ascending, the diagonals whose run of
``RUN_ROWS`` slab values holds a nonzero (``run_ptr``, ``run_diag``: a CSR
over groups; the symmetric form has a second pair for the mirror reads).
The run kernel of ``csrc/dia_spmv.cu`` walks only the listed runs; the dense
kernels of the same source walk every diagonal and stay for bands that are
dense and for raw slabs without an index.  Both stand for the Pallas kernel
of the JAX package's ``csparse3_tpu/kernels/dia_pallas.py``.

The listed runs lie scattered over the slabs (one short read per run, 1.5 GB
apart at 200k buses), and scattered reads are what the card does worst.  So
a plan also keeps the **packed run values** (``pack_runs``): the values the
listed runs read, copied once in index order, about 1% of the slabs.  The
run kernels stream them and never read the slabs, so an index goes to a
kernel together with the values packed for it.  The slabs keep their (D, m)
layout and stay the truth: the dense kernel and both plain versions read
only them, and ``pack_runs`` is held to them on the CPU.

A complex matrix is two real slab sets, and a product with it four real
products.  The split-complex plans give both sets ONE index (the union of
theirs, ``merge_run_index``), and ``dia_split_cuda`` launches the kernel that
walks it once over both sets, with the real and the imaginary part of x side
by side: one launch and one read of the index and of x where two launches
on the stacked input made two.

A batch of K vectors (the studies' scenarios, x as (K, n) parts) is one
launch of the split-complex kernel's batched form: x copied once into a
scenario-minor (n, K, 2) layout (``kernels.bandpoints.scenario_minor_pairs``,
one launch of its copy kernel), the lanes of a warp over the scenarios of
one row, and the plan's **batch entries** in place of the index
(``batch_entries``: each row's nonzero slots, by the lane-set of the
one-vector launch that adds them, in its order), so that each row of the
batch has the bits of its own one-vector launch.

``dia_spmv_cuda`` launches a kernel (built with nvcc at first use): the run
kernel when it is given an index and its packed values, else the dense one.  ``dia_spmv_plain`` is
the dense product in plain PyTorch, a loop over diagonals of ``slab *
shifted window``, and the truth every other version is held to;
``dia_spmv_runs_plain`` walks an index in plain PyTorch (gather the listed
runs, multiply, ``index_add_``), so that an index is tested without a card.
``band_spmv`` picks by where its input lies: a CPU tensor runs a plain
version, a CUDA tensor launches a kernel or raises.  Float32 and float64.

Gradients (``ops.matvec``): the product with A^T that x's gradient needs is
a product with another band, A^T's slabs, which ``transpose_band`` makes
(``transpose_band_plain`` is the same entry by entry); a plan over them has
its own index and packed runs, so the backward launches the same kernels.
The slabs' own gradient, dense as the JAX package's, is ``band_slab_grad``
in plain PyTorch.

``CudaDIA`` and ``SplitCudaDIA`` are the float32 casting wrappers of the
JAX module (``PallasDIA`` / ``SplitPallasDIA``, kept as aliases).  Their
``tile=`` and ``dchunk=`` are accepted and have no effect: the TPU kernel's
lane tile and diagonal chunk grid have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.build import build_cuda_library
from .bandpoints import _shifted, scenario_lanes, scenario_minor_pairs

__all__ = ["band_spmv", "dia_spmv_cuda", "dia_spmv_plain",
           "dia_spmv_runs_plain", "dia_split_cuda", "split_band_spmv",
           "run_index", "merge_run_index", "pack_runs", "run_parts",
           "transpose_band", "transpose_band_plain", "band_slab_grad",
           "batch_entries", "load_cuda_library",
           "BATCH_LAUNCHES",
           "LAUNCHES", "RUN_ROWS", "RUN_SHARE_MAX", "split_complex_apply",
           "CudaDIA", "SplitCudaDIA", "PallasDIA", "SplitPallasDIA"]

#: kernel launches made by ``dia_spmv_cuda`` and ``dia_split_cuda`` since
#: import (or since a caller set them to 0), one per launch and nowhere else:
#: ``dia_spmv`` counts every launch, ``dia_spmv_runs`` those of them that
#: walked an occupancy index, ``dia_spmv_split`` those of these that walked
#: it over two slab sets at once
LAUNCHES = {"dia_spmv": 0, "dia_spmv_runs": 0, "dia_spmv_split": 0}

#: launches of the batched split-complex kernel (a batch of K >= 2 vectors,
#: over the batch entries), one per launch and nowhere else; each is counted
#: in every key of ``LAUNCHES`` too
BATCH_LAUNCHES = {"dia_spmv_split_batched": 0}

#: rows per group of the occupancy index: the value ``csrc/dia_spmv.cu`` is
#: built for (its kRunRows), chosen among 4, 8, 16, 32 by measurement on an
#: H100 (``tune_dia_spmv.py`` at the repository root builds the source for
#: each and times it).  Split-complex launch, RCM Ybus: 200k buses float32,
#: general / symmetric form, 12.0 / 11.2 us at 4 rows, 19.6 / 19.9 at 8,
#: 36.4 / 37.6 at 16, 55.0 / 54.9 at 32; 10k buses float64, general form,
#: 3.5 us at 4, 4.5 at 8, 6.9 at 16, 19.9 at 32
RUN_ROWS = 4

#: a plan keeps its index (and the packed values of its runs) when the listed
#: runs are at most this share of the runs the dense kernel walks; above it
#: the dense kernel is used.  Measured on an H100 on bands of 200,000 rows
#: and 256 diagonals in float32 whose runs are occupied at random
#: (``tune_dia_spmv.py``): the dense kernel takes 0.082 ms whatever the
#: share, the run kernel 0.034 ms at 20%, 0.051 at 30%, 0.064 at 40%, 0.079
#: at 50%, 0.116 at 75%: they cross just above 50%.  At 40% the run kernel
#: is still a fifth faster, and the packed copy stays well under half the
#: size of the slabs
RUN_SHARE_MAX = 0.4

_DTYPES = (torch.float32, torch.float64)


@functools.cache
def load_cuda_library():
    """Build ``csrc/dia_spmv.cu`` with nvcc for sm_90a (first use) and load
    it.  Returns the ctypes library; raises BuildError when nvcc is missing
    or refuses the source."""
    lib = ctypes.CDLL(build_cuda_library("dia_spmv"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dia_spmv.restype = ci
    lib.dia_spmv.argtypes = [ci] * 7 + [vp, vp, vp, vp]
    lib.dia_spmv_runs.restype = ci
    lib.dia_spmv_runs.argtypes = [ci] * 8 + [vp] * 9
    lib.dia_spmv_runs_split.restype = ci
    lib.dia_spmv_runs_split.argtypes = [ci] * 7 + [vp] * 11
    lib.dia_spmv_split_batched.restype = ci
    lib.dia_spmv_split_batched.argtypes = [ci] * 5 + [vp] * 7
    lib.dia_spmv_error_string.restype = ctypes.c_char_p
    lib.dia_spmv_error_string.argtypes = [ci]
    return lib


def _check(slabs, xbm, omin, symmetric, runs=None, vals=None):
    if slabs.ndim != 2 or xbm.ndim != 2:
        raise ValueError(f"slabs must be (D, m) and x (B, n); got "
                         f"{tuple(slabs.shape)} and {tuple(xbm.shape)}")
    if symmetric and (omin != 0 or xbm.shape[1] != slabs.shape[1]):
        raise ValueError("the symmetric form needs omin == 0 and a square "
                         f"matrix; got omin={omin}, m={slabs.shape[1]}, "
                         f"n={xbm.shape[1]}")
    if runs is None:
        if vals is not None:
            raise ValueError("packed run values need the occupancy index "
                             "they were packed for")
        return
    groups = -(-slabs.shape[1] // RUN_ROWS)
    if len(runs) != (4 if symmetric else 2) or any(
            t.dtype != torch.int32 or t.ndim != 1 for t in runs) or any(
            p.shape[0] != groups + 1 for p in runs[::2]):
        raise ValueError(
            "the occupancy index is (run_ptr, run_diag), and (mir_ptr, "
            f"mir_diag) after them for the symmetric form: int32, with "
            f"{groups + 1} pointers for {slabs.shape[1]} rows in groups of "
            f"{RUN_ROWS}")
    if vals is not None and (
            len(vals) != len(runs) // 2 or any(
                v.shape != (d.shape[0], RUN_ROWS) or v.dtype != slabs.dtype
                for v, d in zip(vals, runs[1::2]))):
        raise ValueError(
            "the packed run values are one (listed runs, "
            f"{RUN_ROWS}) tensor of the slabs' dtype for each list of the "
            f"index; got {[tuple(v.shape) for v in vals]} {vals[0].dtype} "
            f"for {[d.shape[0] for d in runs[1::2]]} runs of {slabs.dtype}")


def run_index(slabs, symmetric: bool = False):
    """The occupancy index of (D, m) slabs: ``(run_ptr, run_diag)``, and
    ``(mir_ptr, mir_diag)`` after them for the symmetric form; int32 numpy
    arrays for numpy slabs (built on the host), int32 tensors on the slabs'
    device for a tensor.

    Rows are cut into groups of ``RUN_ROWS``; ``run_diag[run_ptr[g]:
    run_ptr[g + 1]]`` lists, ascending, the diagonals d with a nonzero in
    ``slabs[d, g*RUN_ROWS:(g+1)*RUN_ROWS]``.  The mirror lists name, for the
    rows of group g, the diagonals d >= 1 with a nonzero among ``slabs[d, i
    - d]``, the values those rows read from below the diagonal.  Every
    nonzero of ``slabs`` lies in a listed run."""
    t = slabs if isinstance(slabs, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(slabs))
    D, m = t.shape
    groups = -(-m // RUN_ROWS)

    def lists(first, shift):
        d, i = (t[first:] != 0).nonzero(as_tuple=True)
        d = d + first
        i = i + shift * d
        # (group, diagonal) keys, unique and sorted: by group, then
        # ascending diagonal
        key = torch.unique(((i // RUN_ROWS) * D + d)[i < m])
        if key.numel() >= 2 ** 31:
            raise ValueError(f"{key.numel()} occupied runs do not fit the "
                             "int32 index of the banded kernel")
        ptr = torch.zeros(groups + 1, dtype=torch.int64, device=t.device)
        torch.cumsum(torch.bincount(key // max(D, 1), minlength=groups), 0,
                     out=ptr[1:])
        return ptr.int(), (key % max(D, 1)).int()

    index = lists(0, 0) + (lists(1, 1) if symmetric else ())
    if isinstance(slabs, torch.Tensor):
        return index
    return tuple(a.numpy() for a in index)


def merge_run_index(a, b, ndiag: int):
    """The union of two occupancy indices of (ndiag, m) slabs, as numpy
    arrays in the form of ``run_index``: a run either of them lists.  It is
    an index of both slab sets: a superset of each one's own."""
    out = ()
    for k in range(0, len(a), 2):
        keys = []
        for ptr, diag in (a[k:k + 2], b[k:k + 2]):
            g = np.repeat(np.arange(len(ptr) - 1, dtype=np.int64),
                          np.diff(ptr))
            keys.append(g * ndiag + diag)  # sorted by group, then diagonal
        both = np.union1d(*keys)
        ptr = np.zeros(len(a[k]), dtype=np.int64)
        np.cumsum(np.bincount(both // max(ndiag, 1),
                              minlength=len(ptr) - 1), out=ptr[1:])
        out += (ptr.astype(np.int32), (both % max(ndiag, 1)).astype(np.int32))
    return out


@torch.inference_mode()
def dia_spmv_plain(slabs, xbm, omin: int, symmetric: bool = False):
    """The dense product in plain PyTorch, on any device: y (B, m) for
    slabs (D, m) and x (B, n), in the promoted dtype of the two."""
    _check(slabs, xbm, omin, symmetric)
    D, m = slabs.shape
    dtype = torch.promote_types(slabs.dtype, xbm.dtype)
    x = xbm.to(dtype)
    y = torch.zeros((x.shape[0], m), dtype=dtype, device=x.device)
    if D == 0:
        return y
    for d, win in enumerate(_shifted(x, range(omin, omin + D), m)):
        y += slabs[d] * win
    if symmetric:
        for d in range(1, min(D, m)):
            y[:, d:] += slabs[d, : m - d] * x[:, : m - d]
    return y


def transpose_band(slabs, m: int, n: int, omin: int):
    """The band of A^T: ((D, n) slabs, first offset) for the (D, m) slabs
    of an (m, n) band A whose first offset is ``omin``, on the slabs'
    device.  Diagonal o of A is diagonal -o of A^T, read along its other
    end: ``A^T[j, j - o] = A[j - o, j] = slabs[o - omin, j - o]``, so A^T
    has the offsets -(omin + D - 1) ... -omin and one shifted copy per
    diagonal makes it.  ``transpose_band_plain`` is the same by entries."""
    D = slabs.shape[0]
    out = slabs.new_zeros((D, n))
    for e in range(D):
        o = omin + e
        lo, hi = max(0, o), min(n, m + o)
        if hi > lo:
            out[D - 1 - e, lo:hi] = slabs[e, lo - o: hi - o]
    return out, -(omin + D - 1)


def transpose_band_plain(slabs, m: int, n: int, omin: int):
    """``transpose_band`` entry by entry through the dense (m, n) matrix:
    the plain version it is held to."""
    D = slabs.shape[0]
    dense = slabs.new_zeros((m, n))
    for d in range(D):
        for i in range(m):
            if 0 <= i + omin + d < n:
                dense[i, i + omin + d] = slabs[d, i]
    omin_t = -(omin + D - 1)
    out = slabs.new_zeros((D, n))
    for d in range(D):
        for j in range(n):
            if 0 <= j + omin_t + d < m:
                out[d, j] = dense.T[j, j + omin_t + d]
    return out, omin_t


def band_slab_grad(g, x, omin: int, ndiag: int, symmetric: bool = False):
    """The gradient of a band product's (D, m) slabs in plain PyTorch, for
    the gradient g (B, m) of y = band(slabs, omin) x and the input x (B, n):
    dense, as ``jax.grad`` of the JAX plan's slabs gives it,

        dslabs[d, i] = sum_b g[b, i] conj(x[b, i + omin + d])

    (zero where the column falls outside the matrix), and for the symmetric
    form each stored d > 0 also takes its mirror, sum_b g[b, i + d]
    conj(x[b, i]) for i + d < m.  The shifted windows of x (and of g) are
    one strided (D, m) view of the zero-padded vector, so each row b of the
    batch is one multiply-add over the whole (D, m) output."""
    m, n = g.shape[-1], x.shape[-1]
    dtype = torch.promote_types(g.dtype, x.dtype)
    out = torch.zeros((ndiag, m), dtype=dtype, device=g.device)
    if ndiag == 0 or m == 0:
        return out
    # xp[b, P + j] = x[b, j]; window (d, i) reads xp[b, P + omin + d + i]
    P = max(0, -omin)
    xp = F.pad(x.conj().to(dtype), (P, max(0, omin + ndiag - 1 + m - n)))
    for b in range(g.shape[0]):
        win = xp[b, P + omin:].as_strided((ndiag, m), (1, 1))
        out.addcmul_(win, g[b].to(dtype))
    if symmetric and ndiag > 1:
        # window (d, i) reads gp[b, d + i], zero past m
        gp = F.pad(g.to(dtype), (0, ndiag))
        xc = x.conj().to(dtype)
        for b in range(g.shape[0]):
            win = gp[b, 1:].as_strided((ndiag - 1, m), (1, 1))
            out[1:].addcmul_(win, xc[b])
    return out


def _run_reads(slabs, n, omin, ptr, diag, mirror):
    """Where the listed runs read: (rows, columns, values), each (listed
    runs, RUN_ROWS).  ``rows`` are the rows of y a run adds to (clamped to
    m - 1), ``columns`` the entries of x it meets (clamped to [0, n)), and
    ``values`` the slab values, zero where the run reaches past an edge.
    Forward reads, or the mirror reads of the symmetric form."""
    m, nruns, dev = slabs.shape[1], diag.shape[0], slabs.device
    g = torch.repeat_interleave(
        torch.arange(ptr.shape[0] - 1, device=dev), ptr.long().diff(),
        output_size=nruns)
    d = diag.long()[:, None]
    rows = g[:, None] * RUN_ROWS + torch.arange(RUN_ROWS, device=dev)
    if mirror:  # A[i, i - d] = slabs[d, i - d]
        src = col = rows - d
        ok = (rows < m) & (src >= 0) & (d > 0)
    else:
        src, col = rows, rows + omin + d
        ok = (rows < m) & (col >= 0) & (col < n)
    src = src.clamp(0, max(m - 1, 0))
    vals = torch.where(ok, slabs[d.expand_as(src), src], 0)
    return rows.clamp(max=m - 1), col.clamp(0, max(n - 1, 0)), vals


@torch.inference_mode()
def pack_runs(slabs, n: int, omin: int, symmetric: bool, runs):
    """The values the listed runs read, copied out of the (D, m) slabs in
    the order of the index: one (listed runs, RUN_ROWS) tensor for the
    forward lists and, for the symmetric form, one for the mirror lists, on
    the slabs' device; zero where a run reaches past an edge of the matrix.
    The run kernels stream these and read nothing of the slabs: one
    scattered read per run is what the card does worst.  They are a copy:
    valid for the slabs they were packed from."""
    if slabs.numel() == 0 or n == 0:
        return tuple(slabs.new_zeros((d.shape[0], RUN_ROWS))
                     for d in runs[1::2])
    return tuple(
        _run_reads(slabs, n, omin, runs[k], runs[k + 1], k == 2)[2]
        .contiguous() for k in range(0, len(runs), 2))


def run_parts(m: int) -> int:
    """The lane-sets per group of the one-vector run kernels at m rows
    (``run_parts`` of ``csrc/dia_spmv.cu``, which checks the value it is
    given): a group's list is split while the launch is short of threads,
    8 at 10k rows, 1 at 200k."""
    parts = 1
    while (parts < 8 and RUN_ROWS * parts * 2 <= 32
           and m * parts * 2 <= 132 * 1024):
        parts *= 2
    return parts


def batch_entries(runs, vals, m: int, n: int, omin: int, symmetric: bool):
    """The batch entries of a split-complex band (two slab sets with one
    occupancy index ``runs`` and their packed values ``vals`` = ((re
    forward, [re mirror]), (im forward, [im mirror]))): what the batched
    kernel of ``csrc/dia_spmv.cu`` walks in place of the index.

    The one-vector run kernel deals a group's list round-robin to P =
    ``run_parts(m)`` lane-sets; lane-set j adds the runs j, j + P, ... of
    the forward list, then of the mirror list.  For each row i and
    lane-set j the entries are the slots j adds there that hold a nonzero
    (re or im) and meet a column inside the matrix, in the order it adds
    them.  Returns (eptr (m P + 1), ecol, ere, eim) on the values' device:
    the entries of (i, j) are eptr[i P + j] : eptr[i P + j + 1], ecol their
    columns, ere / eim their values.  A slot left out adds a zero product
    in the one-vector launch."""
    parts = run_parts(m)
    dev = vals[0][0].device
    key_, col_, re_, im_ = [], [], [], []
    for k in range(2 if symmetric else 1):
        ptr, diag = runs[2 * k].long(), runs[2 * k + 1].long()
        rv, iv = vals[0][k], vals[1][k]
        nruns = diag.shape[0]
        if nruns == 0:
            continue
        g = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1,
                                                 device=dev),
                                    ptr.diff(), output_size=nruns)
        j = (torch.arange(nruns, device=dev) - ptr[g]) % parts
        rows = g[:, None] * RUN_ROWS + torch.arange(RUN_ROWS, device=dev)
        d = diag[:, None]
        if k:  # mirror: A[i, i - d] = slabs[d, i - d]
            col = rows - d
            ok = (d > 0) & (col >= 0)
        else:
            col = rows + omin + d
            ok = (col >= 0) & (col < n)
        ok &= (rows < m) & ((rv != 0) | (iv != 0))
        # (row, lane-set), then the forward list before the mirror list
        key_.append(((rows * parts + j[:, None]) * 2 + k)[ok])
        col_.append(col[ok])
        re_.append(rv[ok])
        im_.append(iv[ok])
    eptr = torch.zeros(m * parts + 1, dtype=torch.int64, device=dev)
    if not key_:
        empty = vals[0][0].new_empty(0)
        return (eptr.int(), torch.zeros(0, dtype=torch.int32, device=dev),
                empty, empty)
    key = torch.cat(key_)
    # stable: list order within each (row, lane-set, list)
    order = torch.sort(key, stable=True).indices
    torch.cumsum(torch.bincount(key // 2, minlength=m * parts), 0,
                 out=eptr[1:])
    return (eptr.int(), torch.cat(col_)[order].int(),
            torch.cat(re_)[order].contiguous(),
            torch.cat(im_)[order].contiguous())


def _add_runs(y, slabs, x, omin, ptr, diag, mirror):
    """y[:, rows] += the products of the listed runs (forward reads, or the
    mirror reads of the symmetric form)."""
    if diag.shape[0] == 0:
        return
    rows, col, vals = _run_reads(slabs, x.shape[1], omin, ptr, diag, mirror)
    y.index_add_(1, rows.reshape(-1),
                 (vals * x[:, col]).reshape(x.shape[0], -1))


@torch.inference_mode()
def dia_spmv_runs_plain(slabs, xbm, omin: int, symmetric: bool, runs):
    """The product through an occupancy index in plain PyTorch, on any
    device: gather the listed runs of ``slabs`` and the values of x they
    meet, multiply, and ``index_add_`` by row.  What the index leaves out
    is not read: with the index of ``run_index`` the result is that of
    ``dia_spmv_plain`` up to the order of the sums."""
    _check(slabs, xbm, omin, symmetric, runs)
    dtype = torch.promote_types(slabs.dtype, xbm.dtype)
    x, s = xbm.to(dtype), slabs.to(dtype)
    y = torch.zeros((x.shape[0], slabs.shape[1]), dtype=dtype,
                    device=x.device)
    if slabs.numel() == 0 or x.shape[1] == 0:
        return y
    _add_runs(y, s, x, omin, runs[0], runs[1], False)
    if symmetric:
        _add_runs(y, s, x, omin, runs[2], runs[3], True)
    return y


@torch.inference_mode()
def dia_spmv_cuda(slabs, xbm, omin: int, symmetric: bool = False, runs=None,
                  vals=None):
    """A CUDA kernel: y (B, m) for slabs (D, m) and x (B, n), both on one
    CUDA device, both float32 or both float64.  With ``runs`` (the int32
    occupancy index) and ``vals`` (``pack_runs`` of these slabs and this
    index), both on the same device, the run kernel: it streams ``vals``
    and reads nothing of ``slabs``.  With neither, the dense kernel.  One
    launch per two rows of x (the kernels keep two sums per thread in
    registers)."""
    _check(slabs, xbm, omin, symmetric, runs, vals)
    if runs is not None and vals is None:
        raise ValueError("the run kernel takes the occupancy index together "
                         "with the run values packed for it (pack_runs)")
    dev = slabs.device
    if dev.type != "cuda" or xbm.device != dev or any(
            t.device != dev for t in (*(runs or ()), *(vals or ()))):
        raise ValueError(f"dia_spmv_cuda needs slabs, x and the index on one "
                         f"CUDA device; slabs on {dev}, x on {xbm.device}")
    if slabs.dtype not in _DTYPES or xbm.dtype != slabs.dtype:
        raise TypeError(f"dia_spmv_cuda takes float32 or float64 slabs and "
                        f"x of the same dtype; got {slabs.dtype} and "
                        f"{xbm.dtype}")
    lib = load_cuda_library()
    slabs = slabs.contiguous()
    x = xbm.contiguous()
    (D, m), (B, n) = slabs.shape, x.shape
    y = torch.empty((B, m), dtype=slabs.dtype, device=dev)
    size = slabs.element_size()
    if runs is not None:
        runs = [t.contiguous() for t in runs]
        index = [t.data_ptr() for t in runs] + [None] * (4 - len(runs))
        vals = [t.contiguous() for t in vals]
        index += [t.data_ptr() for t in vals] + [None] * (2 - len(vals))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, 2):
            nb = min(2, B - b0)
            xp = x.data_ptr() + b0 * n * size
            yp = y.data_ptr() + b0 * m * size
            if runs is None:
                err = lib.dia_spmv(size, int(symmetric), m, n, D, omin, nb,
                                   slabs.data_ptr(), xp, yp, stream)
            else:
                err = lib.dia_spmv_runs(
                    size, int(symmetric), m, n, omin, nb, RUN_ROWS,
                    -(-m // RUN_ROWS), *index, xp, yp, stream)
            if err:
                raise RuntimeError(
                    "dia_spmv launch failed: "
                    f"{lib.dia_spmv_error_string(err).decode()}")
            LAUNCHES["dia_spmv"] += 1
            if runs is not None:
                LAUNCHES["dia_spmv_runs"] += 1
    return y


@torch.inference_mode()
def dia_split_cuda(re, im, xn2, omin: int, symmetric: bool, runs, vals,
                   scenario_minor: bool = False, entries=None):
    """The split-complex run kernel: y (2, m) = (yr, yi) for the real slab
    sets ``re`` and ``im`` (both (D, m)) of one complex matrix, their shared
    occupancy index ``runs``, ``vals`` = (``pack_runs`` of re, ``pack_runs``
    of im) for this index, and x given as (n, 2), the real and the imaginary
    part of a column side by side; all on one CUDA device, float32 or
    float64.  The kernel streams ``vals`` and reads nothing of the slabs.
    One launch, in place of ``split_complex_apply`` over two launches of
    ``dia_spmv_cuda`` with this index: the same sums in the same order.

    A batch of K vectors, x (K, n, 2) or, with ``scenario_minor``, (n, K, 2)
    (the K scenarios' pairs of a column side by side, ``kernels.bandpoints.
    scenario_minor_pairs``), gives y (K, 2, m) in one launch: for K >= 2 the
    batched kernel over ``entries``, the ``batch_entries`` of this index and
    these values (the plan holds them), on x in the scenario-minor layout
    (a (K, n, 2) input is copied into it), each row the bits of its own
    one-vector launch; for K = 1 the one-vector launch."""
    if len(vals) != 2 or len(vals[0]) != len(vals[1]) or any(
            a.shape != b.shape or a.dtype != b.dtype for a, b in zip(*vals)):
        raise ValueError("the packed run values of re and of im must be "
                         "alike: one index serves both slab sets")
    if xn2.ndim not in (2, 3) or xn2.shape[-1] != 2 or re.shape != im.shape \
            or (scenario_minor and xn2.ndim != 3):
        raise ValueError(f"re and im must be (D, m) alike and x (n, 2), (K, "
                         f"n, 2) or scenario-minor (n, K, 2); got "
                         f"{tuple(re.shape)}, {tuple(im.shape)} and "
                         f"{tuple(xn2.shape)}")
    n = xn2.shape[0] if scenario_minor else xn2.shape[-2]
    _check(re, xn2.new_empty((0, n)), omin, symmetric, runs, vals[0])
    if xn2.ndim == 3 and xn2.shape[1 if scenario_minor else 0] >= 2 \
            and entries is None:
        raise ValueError("a batch of vectors needs the batch entries of the "
                         "index (batch_entries)")
    dev = re.device
    tensors = (re, im, xn2) + tuple(runs) + tuple(
        t for v in vals for t in v) + tuple(entries or ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("dia_split_cuda needs both slab sets, x and the "
                         "index on one CUDA device; got "
                         + ", ".join(str(t.device) for t in tensors))
    if re.dtype not in _DTYPES or im.dtype != re.dtype \
            or xn2.dtype != re.dtype:
        raise TypeError("dia_split_cuda takes float32 or float64 slab sets "
                        f"and x of one dtype; got {re.dtype}, {im.dtype} and "
                        f"{xn2.dtype}")
    lib = load_cuda_library()
    m, size = re.shape[1], re.element_size()
    if xn2.ndim == 2:
        K, y = 0, torch.empty((2, m), dtype=re.dtype, device=dev)
    else:
        K = xn2.shape[1] if scenario_minor else xn2.shape[0]
        y = torch.empty((K, 2, m), dtype=re.dtype, device=dev)
        if K == 0:
            return y
        if K == 1:  # (1, n, 2) and (n, 1, 2) hold the (n, 2) of one vector
            xn2 = xn2.reshape(n, 2)
        elif not scenario_minor:
            xn2 = xn2.transpose(0, 1)
    x = xn2.contiguous()
    if x.data_ptr() % (2 * size):  # a view that starts between two pairs
        x = x.clone()
    runs = [t.contiguous() for t in runs]
    index = [t.data_ptr() for t in runs] + [None] * (4 - len(runs))
    # re's and im's forward values, then their mirror values
    vals = [[t.contiguous() for t in v] for v in vals]
    index += [v[k].data_ptr() if k < len(v) else None
              for k in range(2) for v in vals]
    head = (size, int(symmetric), m, n, omin, RUN_ROWS, -(-m // RUN_ROWS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if K >= 2:
            err = lib.dia_spmv_split_batched(
                size, m, K, scenario_lanes(K), run_parts(m),
                *(t.data_ptr() for t in entries), x.data_ptr(), y.data_ptr(),
                stream)
        else:
            err = lib.dia_spmv_runs_split(*head, *index, x.data_ptr(),
                                          y.data_ptr(), stream)
    if err:
        raise RuntimeError("dia_spmv_runs_split launch failed: "
                           f"{lib.dia_spmv_error_string(err).decode()}")
    for key in LAUNCHES:
        LAUNCHES[key] += 1
    if K >= 2:
        BATCH_LAUNCHES["dia_spmv_split_batched"] += 1
    return y


def split_band_spmv(re, im, xr, xi, omin: int, symmetric: bool, runs, vals,
                    entries=None):
    """(yr, yi) of the complex band ``re + 1j*im`` (two (D, m) slab sets
    with one occupancy index) times ``xr + 1j*xi``, parts (n,) or a batch
    (K, n): on CPU tensors the plain walk of the index over each set, on
    CUDA tensors one launch of the split-complex kernel on the two sets'
    packed run values ``vals``, whatever K is (a batch of K >= 2 copied
    once into the scenario-minor layout of the batched kernel, which walks
    ``entries``, their ``batch_entries``)."""
    if re.device.type == "cpu" and xr.device.type == "cpu":
        return split_complex_apply(
            *(functools.partial(dia_spmv_runs_plain, s, omin=omin,
                                symmetric=symmetric, runs=runs)
              for s in (re, im)), xr, xi)
    if xr.ndim == 2 and xr.shape[0] >= 2:
        y = dia_split_cuda(
            re, im, scenario_minor_pairs(xr, xi, xr.dtype), omin, symmetric,
            runs, vals, scenario_minor=True, entries=entries)
    else:
        y = dia_split_cuda(re, im, torch.stack([xr, xi], dim=-1), omin,
                           symmetric, runs, vals)
    return y[..., 0, :], y[..., 1, :]


def band_spmv(slabs, xbm, omin: int, symmetric: bool = False, runs=None,
              vals=None):
    """y (B, m) = band(slabs, omin) @ x for x given as (B, n): a plain
    version for CPU tensors, a CUDA kernel otherwise; with ``runs``, the
    occupancy index, the version of either that walks it (the kernel on the
    packed run values ``vals``, which it needs with the index; the plain
    walk gathers from the slabs)."""
    if slabs.device.type == "cpu" and xbm.device.type == "cpu":
        if runs is None:
            return dia_spmv_plain(slabs, xbm, omin, symmetric)
        return dia_spmv_runs_plain(slabs, xbm, omin, symmetric, runs)
    return dia_spmv_cuda(slabs, xbm, omin, symmetric, runs, vals)


def split_complex_apply(re, im, xr, xi):
    """(yr, yi) of a complex matrix held as two real operators ``re`` /
    ``im`` (``im`` None for a real matrix), each mapping (B, n) to (B, m),
    for (n,) vectors xr, xi, or (K, n) batches of them.  Each operator is
    applied ONCE, to the stacked (2, n) or (2K, n) input: separate products
    would stream every diagonal twice."""
    x2 = torch.stack([xr, xi])
    flat = x2.reshape(-1, x2.shape[-1])

    def apply(op):
        y = op(flat)
        return y.view(x2.shape[:-1] + y.shape[-1:])

    r2 = apply(re)
    if im is None:
        return r2[0], r2[1]
    i2 = apply(im)
    return r2[0] - i2[1], r2[1] + i2[0]


class CudaDIA(nn.Module):
    """``ops.matvec.DIAPlan`` in float32 whatever the matrix's dtype: the
    same host construction, slabs and input cast to float32; ``forward``
    takes (n,) or (n, B)."""

    def __init__(self, a, tile: int = 512, dchunk: int = 64, device=None):
        super().__init__()
        from ..ops.matvec import DIAPlan

        self.plan = DIAPlan(a, device=device).float()
        self.m, self.n, self.omin = self.plan.m, self.plan.n, self.plan.omin

    @property
    def slabs(self):
        return self.plan.slabs

    @property
    def ndiag(self) -> int:
        return self.plan.ndiag

    def apply_bn(self, xbn):
        """(B, m) for x given as (B, n): the kernel's own layout."""
        return self.plan.apply_bn(xbn.to(torch.float32))

    @torch.inference_mode()
    def forward(self, x):
        return self.plan(x.to(torch.float32))


class SplitCudaDIA(nn.Module):
    """Split-complex banded SpMV in float32: ``forward(xr, xi) -> (yr,
    yi)``; the two real slab sets share one occupancy index where they have
    one, and a product walks it once for both."""

    def __init__(self, a, tile: int = 512, dchunk: int = 64, device=None):
        super().__init__()
        from ..config import resolve_device
        from ..ops.matvec import _share_runs, _split_real

        device = resolve_device(device, a)
        self.iscomplex, re, im = _split_real(a)
        self.re = CudaDIA(re, device=device)
        self.im = None if im is None else CudaDIA(im, device=device)
        self.shared_runs = _share_runs(self.re.plan,
                                       self.im and self.im.plan)

    @torch.inference_mode()
    def forward(self, xr, xi):
        from ..ops.matvec import _split_apply

        return _split_apply(self.re.plan, self.im and self.im.plan,
                            self.shared_runs, xr.to(torch.float32),
                            xi.to(torch.float32))


# the JAX package exports these names
PallasDIA = CudaDIA
SplitPallasDIA = SplitCudaDIA
