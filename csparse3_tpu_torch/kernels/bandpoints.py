"""Hybrid band + scattered-points split-complex SpMV.

Grid admittance matrices in natural order have two kinds of structure
(see the JAX package's ``csparse3_tpu/kernels/bandpoints.py``):

* a handful of HEAVY diagonals (the lattice offsets {0, +-1, +-side})
  carrying most of the nonzeros at near-full occupancy;
* a sparse WASH of long-line entries spread thinly over a wide band.

``SplitBandPoints`` stores the heavy diagonals as dense slabs and the wash
as per-row point lists, and computes y = A x for split-complex x in one
launch of one hand-written CUDA kernel per matvec (``csrc/bandpoints.cu``),
which stands for the three Pallas kernels of the JAX module.  Beside it, in
this module, is the plain PyTorch version of the same function: the wrapper
runs it for a CPU tensor, and only there.  A CUDA tensor launches the
kernel (built with nvcc at first use) or raises.

On an H100 the kernel is bound by device-memory bytes: one thread per row
reads each slab value, point entry and x value once and writes its row of
y once.  The offset groups of ``group_span`` bound the TPU's VMEM window of
x, one Pallas call per group; Hopper gathers x through its caches with no
window, so here the groups are build-time bookkeeping: the plan joins
their per-row lists in group order into the one set of lists the kernel
walks, which are the lists of the ungrouped plan (asserted at build).

A batch of K scenarios, x given as (K, n) parts, is one launch of the
kernel's batched form: the lanes of a warp take the scenarios of one row
and read its terms once for all of them, from per-row entry lists built at
build (``batch_entries``), with x copied once into a scenario-minor (n, K,
2) layout by a copy kernel (``scenario_minor_pairs``).  Each row has the
bits of its own one-vector launch.

What the TPU needed and Hopper does not is left out: the one-hot "gather"
products (``_dot_onehot`` and its bf16 split), the VMEM window and
supertile modes (``_auto_supertile``).  The arguments ``supertile=`` and
``precision=`` are accepted for API parity and have no effect: without
one-hot products every matvec is exact f32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..utils.build import build_cuda_library

__all__ = ["OffsetsPlan", "SplitBandPoints", "split_offsets",
           "load_cuda_library", "scenario_lanes", "scenario_minor_pairs",
           "PAIR_LAUNCHES"]

#: launches of the copy kernel of ``scenario_minor_pairs``, one per launch
#: and nowhere else
PAIR_LAUNCHES = {"scenario_minor_pairs": 0}


def scenario_lanes(K: int) -> int:
    """Lanes of a warp that the batched band+points kernel gives to the
    scenarios of one row, for a batch of K >= 2 vectors: the least power of
    two >= K, at most 32.  A row's terms are read once for its lanes, so a
    warp holds 32 // lanes rows: K = 16 takes two rows a warp, K = 128 four
    warps of 32 scenarios for each row."""
    if K < 1:
        raise ValueError(f"a batch has at least one vector, got K={K}")
    return min(32, 1 << (K - 1).bit_length())


def scenario_minor_pairs(xr, xi, dtype):
    """(n, K, 2) of ``dtype`` (float32 or float64) for (K, n) parts: the K
    scenarios' (xr, xi) of a column side by side, the input of the batched
    band+points kernel (the DIA split-complex kernel takes it too).  On CUDA
    tensors one launch of the copy kernel of ``csrc/bandpoints.cu`` (counted
    in ``PAIR_LAUNCHES``), after a cast of the parts to ``dtype`` where they
    differ; on CPU tensors its plain version, a stack of the transposed
    parts."""
    if xr.ndim != 2 or xr.shape != xi.shape:
        raise ValueError(f"x parts must be (K, n) alike, got "
                         f"{tuple(xr.shape)} / {tuple(xi.shape)}")
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return torch.stack([xr.T.to(dtype), xi.T.to(dtype)], dim=-1)
    dev = xr.device
    if dev.type != "cuda" or xi.device != dev:
        raise ValueError(f"x parts must be on one CUDA device, got "
                         f"{xr.device} / {xi.device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the copy kernel takes float32 or float64, got "
                        f"{dtype}")
    xr, xi = (t.to(dtype).contiguous() for t in (xr, xi))
    K, n = xr.shape
    out = torch.empty((n, K, 2), dtype=dtype, device=dev)
    lib = load_cuda_library()
    with torch.cuda.device(dev):
        err = lib.scenario_minor_pairs(
            xr.element_size(), K, n, xr.data_ptr(), xi.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("scenario_minor_pairs launch failed: "
                           f"{lib.bandpoints_error_string(err).decode()}")
    PAIR_LAUNCHES["scenario_minor_pairs"] += 1
    return out


def _shifted(x2, offs, m):
    """Windows x2[..., i + o] for i < m, zero outside [0, n): a (..., n)
    input gives one (..., m) tensor per offset."""
    n = x2.shape[-1]
    P = max(0, -min(offs))
    Q = max(0, max(offs) + m - n)
    xp = F.pad(x2, (P, Q))
    return [xp[..., P + o: P + o + m] for o in offs]


# ---------------------------------------------------------------------------
# heavy-diagonal core: static-shift slabs
# ---------------------------------------------------------------------------

class OffsetsPlan(nn.Module):
    """SpMV over an explicit list of diagonals: slabs[k, i] = A[i, i +
    offs[k]], float32.  ``forward`` takes (n,) or (n, B)."""

    def __init__(self, m, n, offs, slabs, device=None):
        super().__init__()
        self.m, self.n = m, n
        self.offs = tuple(int(o) for o in offs)
        if not isinstance(slabs, torch.Tensor):
            device = resolve_device(device)
        self.register_buffer("slabs", torch.as_tensor(
            slabs, dtype=torch.float32, device=device))

    @classmethod
    def from_entries(cls, m, n, rows, cols, vals, offs, device=None):
        offs = sorted(int(o) for o in offs)
        ra = np.zeros((len(offs), m), dtype=np.float32)
        d = cols - rows
        for k, o in enumerate(offs):
            sel = d == o
            ra[k, rows[sel]] = vals[sel]
        return cls(m, n, offs, ra, device=device)

    def rows(self, x2):
        """Row layout: x2 (B, n) -> (B, m)."""
        x2 = x2.to(torch.float32)
        y = torch.zeros((x2.shape[0], self.m), dtype=torch.float32,
                        device=x2.device)
        if not self.offs:
            return y
        for k, win in enumerate(_shifted(x2, self.offs, self.m)):
            y += self.slabs[k][None, :] * win
        return y

    @torch.inference_mode()
    def forward(self, x):
        x = x.to(torch.float32)
        if x.ndim == 1:
            return self.rows(x[None, :])[0]
        return self.rows(x.T).T


# ---------------------------------------------------------------------------
# split plan: slabs + per-row point lists, one kernel per matvec
# ---------------------------------------------------------------------------

def split_offsets(rows, cols, n, frac: float = 0.02):
    """Heavy offsets: those carrying at least ``frac * n`` entries."""
    d = cols - rows
    offs, counts = np.unique(d, return_counts=True)
    return set(int(o) for o in offs[counts >= max(1, int(frac * n))])


def _pack_points(m, rows, cols, valr, vali):
    """Point entries as per-row lists, rows ascending (entries of a row
    keep their input order: columns ascending for CSC input).  Returns
    (ptr (m+1,), col, row) int32 and val (2, nnz) float32 = (re, im)."""
    order = np.argsort(rows, kind="stable")
    ptr = np.zeros(m + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(rows, minlength=m))
    val = np.zeros((2, len(rows)), dtype=np.float32)
    val[0] = valr[order]
    if vali is not None:
        val[1] = vali[order]
    return (ptr, cols[order].astype(np.int32), rows[order].astype(np.int32),
            val)


@functools.cache
def load_cuda_library():
    """Build ``csrc/bandpoints.cu`` with nvcc for sm_90a (first use) and
    load it.  Returns the ctypes library; raises BuildError when nvcc is
    missing or refuses the source."""
    path = build_cuda_library("bandpoints")
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bandpoints_spmv.restype = ci
    lib.bandpoints_spmv.argtypes = [ci, ci, ci] + [vp] * 11 + [ci, vp]
    lib.bandpoints_spmv_batched.restype = ci
    lib.bandpoints_spmv_batched.argtypes = [ci] * 3 + [vp] * 7
    lib.scenario_minor_pairs.restype = ci
    lib.scenario_minor_pairs.argtypes = [ci] * 3 + [vp] * 4
    lib.bandpoints_error_string.restype = ctypes.c_char_p
    lib.bandpoints_error_string.argtypes = [ci]
    return lib


class SplitBandPoints(nn.Module):
    """Split-complex SpMV = heavy-diagonal slabs + scattered points.

    ``forward(xr, xi) -> (yr, yi)``, float32.  Built on the host from a
    complex (or real) square CSC and placed on ``device`` (None: the CUDA
    card, ``config.default_device()``).  On a CUDA device every matvec
    launches the CUDA kernel once and counts it in ``kernel_launches``; on
    the CPU it runs ``plain``.  Parts of shape (K, n), one vector per
    scenario, are one product too: for K >= 2 one launch of the batched
    kernel (also counted in ``scenario_launches``) over the plan's
    ``batch_entries()``, on x copied
    once into its scenario-minor layout, each row the bits of its own
    one-vector launch; K = 1 is the one-vector launch.

    ``group_span`` partitions the points into ``n_groups`` offset groups
    spanning that many diagonals each, as in the JAX package.  ``plain``
    walks them group by group; the kernel walks their lists joined in
    group order (``_kernel_lists``), which equal the lists of
    ``group_span=None``, in the same one launch.
    ``tile`` is the number of rows per CTA (a multiple of 32, <= 1024).
    """

    def __init__(self, a, frac: float = 0.02, tile: int = 256,
                 group_span: int | None = None,
                 supertile: bool | str | None = None,
                 precision: str = "exact", device=None):
        super().__init__()
        if precision not in ("exact", "fast"):
            raise ValueError(f"precision must be 'exact' or 'fast', "
                             f"got {precision!r}")
        if tile % 32 or not 32 <= tile <= 1024:
            raise ValueError(f"tile must be a multiple of 32 in [32, 1024], "
                             f"got {tile}")
        if a.m != a.n:
            raise ValueError(f"SplitBandPoints needs a square matrix, "
                             f"got {a.shape}")
        device = resolve_device(device, a)
        ip, ix, vals = a.np_arrays()
        m, n = a.m, a.n
        rows = ix.astype(np.int64)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        self.iscomplex = np.iscomplexobj(vals)
        vr = np.ascontiguousarray(vals.real).astype(np.float32)
        vi = (np.ascontiguousarray(vals.imag).astype(np.float32)
              if self.iscomplex else None)
        heavy = split_offsets(rows, cols, n, frac)
        d = cols - rows
        core = np.isin(d, list(heavy)) if heavy else np.zeros(len(d), bool)
        pts = ~core
        self.m, self.n = m, n
        self.tile = tile
        self.group_span = group_span
        self.offs = tuple(sorted(int(o) for o in heavy))
        # slabs (2, D, m): re then im, one row per heavy diagonal
        slabs = np.zeros((2, len(self.offs), m), dtype=np.float32)
        for k, o in enumerate(self.offs):
            sel = core & (d == o)
            slabs[0, k, rows[sel]] = vr[sel]
            if vi is not None:
                slabs[1, k, rows[sel]] = vi[sel]
        self.register_buffer("offs_t", torch.as_tensor(
            np.asarray(self.offs, dtype=np.int32), device=device))
        self.register_buffer("slabs", torch.as_tensor(slabs, device=device))
        # point entries by offset group (ascending offset ranges)
        pr, pc, pvr = rows[pts], cols[pts], vr[pts]
        pvi = vi[pts] if vi is not None else None
        dd = pc - pr
        if group_span is None or not len(dd):
            gids = [np.ones(len(dd), dtype=bool)]
        else:
            gid = (dd - int(dd.min())) // group_span
            gids = [gid == g for g in np.unique(gid)]
        self._n_groups = len(gids)
        groups = [_pack_points(m, pr[sel], pc[sel], pvr[sel],
                               pvi[sel] if pvi is not None else None)
                  for sel in gids]
        for g, packed in enumerate(groups):
            for name, arr in zip(("ptr", "col", "row", "val"), packed):
                self.register_buffer(f"p{g}_{name}",
                                     torch.as_tensor(arr, device=device))
        if self.n_groups > 1:
            # the kernel's lists: the groups' rows joined in group order,
            # which within a row is column order, so the ungrouped lists
            _, col, row, val = (np.concatenate(k, axis=-1)
                                 for k in zip(*groups))
            joined = _pack_points(m, row, col, val[0], val[1])
            whole = _pack_points(m, pr, pc, pvr, pvi)
            if not all(np.array_equal(x, y) for x, y in zip(joined, whole)):
                raise AssertionError("joined offset groups differ from the "
                                     "ungrouped point lists")
            for name, arr in zip(("ptr", "col", "val"),
                                 (joined[0], joined[1], joined[3])):
                self.register_buffer(f"k_{name}",
                                     torch.as_tensor(arr, device=device))
        # the batched kernel's entry lists (``batch_entries``)
        with torch.no_grad():
            for name, t in zip(("eptr", "ecol", "ere", "eim"),
                               self._build_entries(*self._kernel_lists())):
                self.register_buffer(f"b_{name}", t)
        self.kernel_launches = 0
        self.scenario_launches = 0

    @property
    def core_ndiag(self):
        return len(self.offs)

    @property
    def n_groups(self) -> int:
        """The offset groups of the point entries (1 without
        ``group_span``)."""
        return self._n_groups

    def _group(self, g):
        return tuple(getattr(self, f"p{g}_{k}")
                     for k in ("ptr", "col", "row", "val"))

    def _kernel_lists(self):
        """(ptr, col, val) the kernel walks: group 0's lists, or the groups'
        joined in group order."""
        pre = "p0" if self.n_groups == 1 else "k"
        return tuple(getattr(self, f"{pre}_{k}") for k in ("ptr", "col", "val"))

    def _x2(self, xr, xi):
        # (2, n) or (2, K, n) float32: the kernel's input dtype, as
        # bandpoints.py casts
        return torch.stack([xr.to(torch.float32), xi.to(torch.float32)])

    @torch.inference_mode()
    def plain(self, xr, xi):
        """The plain PyTorch version of the kernel, on any device; parts
        (n,) or (K, n)."""
        x2 = self._x2(xr, xi)
        y = torch.zeros(x2.shape[:-1] + (self.m,), dtype=torch.float32,
                        device=x2.device)
        for g in range(self.n_groups):
            _, col, row, val = self._group(g)
            xc = x2.index_select(-1, col)
            y[0].index_add_(-1, row, val[0] * xc[0] - val[1] * xc[1])
            y[1].index_add_(-1, row, val[0] * xc[1] + val[1] * xc[0])
        if self.offs:
            for k, w in enumerate(_shifted(x2, self.offs, self.m)):
                sr, si = self.slabs[0, k], self.slabs[1, k]
                y[0] += sr * w[0] - si * w[1]
                y[1] += sr * w[1] + si * w[0]
        return y[0], y[1]

    @torch.inference_mode()
    def forward(self, xr, xi):
        if xr.device.type == "cpu" and xi.device.type == "cpu":
            return self.plain(xr, xi)
        return self.cuda_kernel(xr, xi)

    @torch.inference_mode()
    def cuda_kernel(self, xr, xi):
        """The CUDA kernel, one launch for parts (n,) or a batch (K, n) (the
        batched kernel for K >= 2); raises for input that is not on this
        plan's CUDA device."""
        dev = self.slabs.device
        if dev.type != "cuda" or xr.device != dev or xi.device != dev:
            raise ValueError(
                f"SplitBandPoints.cuda_kernel needs x on the plan's CUDA "
                f"device; plan on {dev}, x on {xr.device} / {xi.device}")
        if xr.shape != xi.shape or xr.ndim not in (1, 2) \
                or xr.shape[-1] != self.n:
            raise ValueError(f"x parts must have shape ({self.n},) or (K, "
                             f"{self.n}), got {tuple(xr.shape)} / "
                             f"{tuple(xi.shape)}")
        if xr.ndim == 2 and xr.shape[0] >= 2:
            y = torch.empty((2, xr.shape[0], self.m), dtype=torch.float32,
                            device=dev)
            self._launch_batch(
                scenario_minor_pairs(xr, xi, torch.float32), y)
        else:
            x2 = self._x2(xr, xi).contiguous()
            y = torch.empty(x2.shape[:-1] + (self.m,), dtype=torch.float32,
                            device=dev)
            self._launch(x2, y)
        return y[0], y[1]

    def _launch(self, x2, y):
        """One launch of the one-vector kernel on the plan's device: y (2,
        m) = A x for x2 (2, n), both contiguous float32, the real parts
        first (a (2, 1, m) / (2, 1, n) pair is the same memory)."""
        lib = load_cuda_library()
        ptr, col, val = self._kernel_lists()
        D = len(self.offs)
        slab_re = self.slabs.data_ptr()
        dev = self.slabs.device
        with torch.cuda.device(dev):
            err = lib.bandpoints_spmv(
                self.m, self.n, D, self.offs_t.data_ptr(), slab_re,
                slab_re + D * self.m * 4, ptr.data_ptr(), col.data_ptr(),
                val.data_ptr(), val.data_ptr() + col.numel() * 4,
                x2.data_ptr(), x2.data_ptr() + self.n * 4, y.data_ptr(),
                y.data_ptr() + self.m * 4, self.tile,
                torch.cuda.current_stream(dev).cuda_stream)
        self._raise(lib, err)
        self.kernel_launches += 1

    def batch_entries(self):
        """The batched kernel's per-row entry lists, (eptr (m + 1) int32,
        col int32, re, im float32) on the plan's device: row i's terms in the
        one-vector kernel's order, its points in list order, then the heavy
        diagonals d = 0 .. D - 1 whose column i + offs[d] lies inside the
        matrix.  Built with the plan."""
        return self.b_eptr, self.b_ecol, self.b_ere, self.b_eim

    def _build_entries(self, ptr, col, val):
        m, n, dev = self.m, self.n, self.slabs.device
        prow = torch.repeat_interleave(torch.arange(m, device=dev),
                                       ptr.long().diff(),
                                       output_size=col.numel())
        # the heavy diagonals row by row, d ascending: (m, D)
        scol = (torch.arange(m, device=dev)[:, None]
                + self.offs_t.long()[None, :])
        ok = (scol >= 0) & (scol < n)
        srow = torch.arange(m, device=dev)[:, None].expand_as(scol)[ok]
        rows = torch.cat([prow, srow])
        # by row, the points first; stable: list order within each
        order = torch.sort(rows * 2 + torch.cat([
            torch.zeros_like(prow), torch.ones_like(srow)]),
            stable=True).indices
        eptr = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(rows, minlength=m), 0, out=eptr[1:])
        ecol = torch.cat([col.long(), scol[ok]])[order]
        ere = torch.cat([val[0], self.slabs[0].T[ok]])[order]
        eim = torch.cat([val[1], self.slabs[1].T[ok]])[order]
        return (eptr.int(), ecol.int(), ere.contiguous(), eim.contiguous())

    def _launch_batch(self, xs, y):
        """One launch of the batched kernel: y (2, K, m) = A x for the K
        vectors of xs (n, K, 2) (``scenario_minor_pairs``), both contiguous
        float32, with ``scenario_lanes(K)`` lanes a row, over
        ``batch_entries()``."""
        lib = load_cuda_library()
        K = xs.shape[1]
        if K == 0:
            return
        entries = self.batch_entries()
        dev = self.slabs.device
        with torch.cuda.device(dev):
            err = lib.bandpoints_spmv_batched(
                self.m, K, scenario_lanes(K),
                *(t.data_ptr() for t in entries), xs.data_ptr(),
                y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        self._raise(lib, err)
        self.kernel_launches += 1
        self.scenario_launches += 1

    @staticmethod
    def _raise(lib, err):
        if err:
            raise RuntimeError("bandpoints_spmv launch failed: "
                               f"{lib.bandpoints_error_string(err).decode()}")
