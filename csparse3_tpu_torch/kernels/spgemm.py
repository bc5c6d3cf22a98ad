"""Numeric pass of a sparse product on a frozen pattern: the CUDA kernel,
its wrapper and its plain PyTorch version.

The symbolic phase (``ops.spgemm.spgemm_symbolic``, host, once per pattern)
lists every elementary product of C = A @ B sorted by the output entry it
belongs to.  Product t multiplies entry ``pa[t]`` of A's value array by
entry ``pb[t]`` of B's; the products of output o are those with
``gid[t] == o``, that is t in [seg_ptr[o], seg_ptr[o + 1]):

    data[o] = sum_{t: gid[t] = o} a_vals[pa[t]] * b_vals[pb[t]]

``spgemm_numeric_cuda`` launches the hand-written kernel
``csrc/spgemm_numeric.cu`` (built with nvcc at first use), which stands for
the Pallas kernel of the JAX package's ``csparse3_tpu/kernels/
spgemm_pallas.py``; ``spgemm_numeric_plain`` is the same function in plain
PyTorch: two gathers, a product and ``index_add_`` over ``gid``.
``spgemm_numeric`` picks between them.  By dtype: float32, float64,
complex64 and complex128 values are the kernel's; any other dtype
(integers, which the sum must keep exact in their own type) takes the plain
route on whatever device it lies.  By device, for the kernel's dtypes: a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises.  Nothing else decides: not the size (the TPU kernel's cap on the
value arrays has no counterpart) and never a failed build or launch.

On an H100 the kernel is bound by the dependent loads in flight: the
patterns it serves hold ~1.1 products per output, each a chain of segment
bounds, map entries and value gathers.  So a CTA owns a tile of 256 x V
consecutive outputs (V by a size rule in the source, ``outputs_per_thread``
reads it), a thread V of them 256 apart, so that a warp's lanes take
consecutive outputs, and it issues every load of a step for all V before
it uses any; the streams (segment bounds, maps, output) go evict-first so
that the gathered values stay cached.  Each output is summed by one thread
in product order: no size cap, no atomics, the same bits on every run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.build import build_cuda_library

__all__ = ["spgemm_numeric", "spgemm_numeric_cuda", "spgemm_numeric_plain",
           "load_cuda_library", "outputs_per_thread", "LAUNCHES",
           "KERNEL_DTYPES"]

#: kernel launches made by ``spgemm_numeric_cuda`` since import (or since a
#: caller set it to 0): one per launch, nowhere else
LAUNCHES = {"spgemm_numeric": 0}

#: value dtypes the CUDA kernel takes
KERNEL_DTYPES = (torch.float32, torch.float64, torch.complex64,
                 torch.complex128)


@functools.cache
def load_cuda_library():
    """Build ``csrc/spgemm_numeric.cu`` with nvcc for sm_90a (first use) and
    load it.  Returns the ctypes library; raises BuildError when nvcc is
    missing or refuses the source."""
    lib = ctypes.CDLL(build_cuda_library("spgemm_numeric"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.spgemm_numeric.restype = ci
    lib.spgemm_numeric.argtypes = [ci] * 3 + [vp] * 7
    lib.spgemm_numeric_outputs_per_thread.restype = ci
    lib.spgemm_numeric_outputs_per_thread.argtypes = [ci]
    lib.spgemm_numeric_error_string.restype = ctypes.c_char_p
    lib.spgemm_numeric_error_string.argtypes = [ci]
    return lib


def outputs_per_thread(out_nnz: int) -> int:
    """V, the outputs each thread of the kernel owns for a plan of
    ``out_nnz`` outputs (the source's size rule; builds the library)."""
    return load_cuda_library().spgemm_numeric_outputs_per_thread(out_nnz)


def _check(seg_ptr, pa, pb, a_vals, b_vals):
    if not (seg_ptr.ndim == pa.ndim == pb.ndim == a_vals.ndim
            == b_vals.ndim == 1) or seg_ptr.numel() < 1 \
            or pa.shape != pb.shape:
        raise ValueError(
            "spgemm_numeric takes 1-D seg_ptr (outputs + 1), pa and pb of "
            f"one length and 1-D value arrays; got {tuple(seg_ptr.shape)}, "
            f"{tuple(pa.shape)}, {tuple(pb.shape)}, {tuple(a_vals.shape)}, "
            f"{tuple(b_vals.shape)}")


@torch.inference_mode()
def spgemm_numeric_plain(gid, pa, pb, a_vals, b_vals, out_nnz: int):
    """The plain PyTorch version, on any device and for any dtype: data
    (out_nnz,) in the promoted dtype of the two value arrays.  ``gid`` is
    the output id of each product (sorted ascending)."""
    dtype = torch.promote_types(a_vals.dtype, b_vals.dtype)
    prod = (a_vals.to(dtype).index_select(0, pa)
            * b_vals.to(dtype).index_select(0, pb))
    data = torch.zeros(out_nnz, dtype=dtype, device=prod.device)
    return data.index_add_(0, gid, prod)


@torch.inference_mode()
def spgemm_numeric_cuda(seg_ptr, pa, pb, a_vals, b_vals):
    """The CUDA kernel: data (len(seg_ptr) - 1,) for int32 maps and value
    arrays of one of ``KERNEL_DTYPES``, all on one CUDA device; the value
    arrays are promoted to their common dtype.  One launch."""
    _check(seg_ptr, pa, pb, a_vals, b_vals)
    dev = a_vals.device
    tensors = (seg_ptr, pa, pb, a_vals, b_vals)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("spgemm_numeric_cuda needs its maps and values on "
                         "one CUDA device; got "
                         + ", ".join(str(t.device) for t in tensors))
    dtype = torch.promote_types(a_vals.dtype, b_vals.dtype)
    if dtype not in KERNEL_DTYPES:
        raise TypeError("spgemm_numeric_cuda takes float32, float64, "
                        f"complex64 or complex128 values; got {a_vals.dtype} "
                        f"and {b_vals.dtype}")
    if any(t.dtype != torch.int32 for t in (seg_ptr, pa, pb)):
        raise TypeError("spgemm_numeric_cuda takes int32 seg_ptr, pa and pb; "
                        f"got {seg_ptr.dtype}, {pa.dtype}, {pb.dtype}")
    lib = load_cuda_library()
    seg_ptr, pa, pb = seg_ptr.contiguous(), pa.contiguous(), pb.contiguous()
    a = a_vals.to(dtype).contiguous()
    b = b_vals.to(dtype).contiguous()
    out_nnz = seg_ptr.numel() - 1
    data = torch.empty(out_nnz, dtype=dtype, device=dev)
    itemsize = data.element_size() // (2 if dtype.is_complex else 1)
    with torch.cuda.device(dev):
        err = lib.spgemm_numeric(
            itemsize, int(dtype.is_complex), out_nnz, seg_ptr.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), a.data_ptr(), b.data_ptr(),
            data.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("spgemm_numeric launch failed: "
                           f"{lib.spgemm_numeric_error_string(err).decode()}")
    if out_nnz:
        LAUNCHES["spgemm_numeric"] += 1
    return data


def spgemm_numeric(seg_ptr, gid, pa, pb, a_vals, b_vals):
    """data (len(seg_ptr) - 1,) of the numeric pass: the plain version for
    CPU tensors and for dtypes outside ``KERNEL_DTYPES``, the CUDA kernel
    otherwise."""
    on_cpu = a_vals.device.type == "cpu" and b_vals.device.type == "cpu"
    dtype = torch.promote_types(a_vals.dtype, b_vals.dtype)
    if on_cpu or dtype not in KERNEL_DTYPES:
        return spgemm_numeric_plain(gid, pa, pb, a_vals, b_vals,
                                    seg_ptr.numel() - 1)
    return spgemm_numeric_cuda(seg_ptr, pa, pb, a_vals, b_vals)
