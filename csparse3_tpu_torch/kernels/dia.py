"""Banded (DIA-slab) SpMV: the CUDA kernel, its wrapper and its plain
PyTorch version.

The matrix is a dense range of D diagonals, row aligned (the layout of
``ops.matvec.DIAPlan``): ``slabs[d, i] = A[i, i + omin + d]``.  Vectors
are carried as (B, m): batch first, rows last.

    general:    y[b, i] = sum_d slabs[d, i] * x[b, i + omin + d]
    symmetric:  only the diagonals d >= 0 of a symmetric matrix are stored
                (omin = 0) and the strict lower triangle is their mirror,
                y[b, i] += sum_{d > 0} slabs[d, i - d] * x[b, i - d]

``dia_spmv_cuda`` launches the hand-written kernel ``csrc/dia_spmv.cu``
(built with nvcc at first use), which stands for the Pallas kernel of the
JAX package's ``csparse3_tpu/kernels/dia_pallas.py``; ``dia_spmv_plain``
is the same function in plain PyTorch, a loop over diagonals of ``slab *
shifted window``.  ``band_spmv`` picks between them by where its input
lies: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel or raises.  Float32 and float64.

``CudaDIA`` and ``SplitCudaDIA`` are the float32 casting wrappers of the
JAX module (``PallasDIA`` / ``SplitPallasDIA``, kept as aliases).  Their
``tile=`` and ``dchunk=`` are accepted and have no effect: the TPU kernel's
lane tile and diagonal chunk grid have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

from ..utils.build import build_cuda_library
from .bandpoints import _shifted

__all__ = ["band_spmv", "dia_spmv_cuda", "dia_spmv_plain", "load_cuda_library",
           "LAUNCHES", "split_complex_apply", "CudaDIA", "SplitCudaDIA", "PallasDIA",
           "SplitPallasDIA"]

#: kernel launches made by ``dia_spmv_cuda`` since import (or since a caller
#: set it to 0): one per launch, nowhere else
LAUNCHES = {"dia_spmv": 0}

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
    lib.dia_spmv_error_string.restype = ctypes.c_char_p
    lib.dia_spmv_error_string.argtypes = [ci]
    return lib


def _check(slabs, xbm, omin, symmetric):
    if slabs.ndim != 2 or xbm.ndim != 2:
        raise ValueError(f"slabs must be (D, m) and x (B, n); got "
                         f"{tuple(slabs.shape)} and {tuple(xbm.shape)}")
    if symmetric and (omin != 0 or xbm.shape[1] != slabs.shape[1]):
        raise ValueError("the symmetric form needs omin == 0 and a square "
                         f"matrix; got omin={omin}, m={slabs.shape[1]}, "
                         f"n={xbm.shape[1]}")


@torch.inference_mode()
def dia_spmv_plain(slabs, xbm, omin: int, symmetric: bool = False):
    """The plain PyTorch version of the kernel, on any device: y (B, m) for
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


@torch.inference_mode()
def dia_spmv_cuda(slabs, xbm, omin: int, symmetric: bool = False):
    """The CUDA kernel: y (B, m) for slabs (D, m) and x (B, n), both on one
    CUDA device, both float32 or both float64.  One launch per two rows of
    x (the kernel keeps two sums per thread in registers)."""
    _check(slabs, xbm, omin, symmetric)
    dev = slabs.device
    if dev.type != "cuda" or xbm.device != dev:
        raise ValueError(f"dia_spmv_cuda needs slabs and x on one CUDA "
                         f"device; slabs on {dev}, x on {xbm.device}")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, 2):
            nb = min(2, B - b0)
            err = lib.dia_spmv(
                size, int(symmetric), m, n, D, omin, nb, slabs.data_ptr(),
                x.data_ptr() + b0 * n * size, y.data_ptr() + b0 * m * size,
                stream)
            if err:
                raise RuntimeError(
                    "dia_spmv launch failed: "
                    f"{lib.dia_spmv_error_string(err).decode()}")
            LAUNCHES["dia_spmv"] += 1
    return y


def band_spmv(slabs, xbm, omin: int, symmetric: bool = False):
    """y (B, m) = band(slabs, omin) @ x for x given as (B, n): the plain
    version for CPU tensors, the CUDA kernel otherwise."""
    if slabs.device.type == "cpu" and xbm.device.type == "cpu":
        return dia_spmv_plain(slabs, xbm, omin, symmetric)
    return dia_spmv_cuda(slabs, xbm, omin, symmetric)


def split_complex_apply(re, im, xr, xi):
    """(yr, yi) of a complex matrix held as two real operators ``re`` /
    ``im`` (``im`` None for a real matrix), each mapping (B, n) to (B, m),
    for (n,) vectors xr, xi.  Each operator is applied ONCE, to the stacked
    (2, n) input: separate products would stream every diagonal twice."""
    x2 = torch.stack([xr, xi])
    r2 = re(x2)
    if im is None:
        return r2[0], r2[1]
    i2 = im(x2)
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
    yi)``; each real slab set is streamed once for the stacked (2, n)
    input."""

    def __init__(self, a, tile: int = 512, dchunk: int = 64, device=None):
        super().__init__()
        from ..config import resolve_device
        from ..ops.matvec import _split_real

        device = resolve_device(device, a)
        self.iscomplex, re, im = _split_real(a)
        self.re = CudaDIA(re, device=device)
        self.im = None if im is None else CudaDIA(im, device=device)

    @torch.inference_mode()
    def forward(self, xr, xi):
        return split_complex_apply(
            self.re.apply_bn, self.im and self.im.apply_bn, xr, xi)


# the JAX package exports these names
PallasDIA = CudaDIA
SplitPallasDIA = SplitCudaDIA
