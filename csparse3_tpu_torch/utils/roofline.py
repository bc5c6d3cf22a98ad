"""Memory roofline of the card: the triad bandwidth probe and the byte
counts a bandwidth-bound operator is held against.

``triad(a, s)`` is the streaming kernel o = a * s + 0.5 over float32
(``csrc/triad.cu``, hand-written CUDA, built with nvcc at first use); it
stands for the Pallas probe kernel of the JAX repository
(``probes/_probe_pallas.py``).  ``triad_plain`` is the same function in
plain PyTorch.  A CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.  ``measure_hbm_bw`` times the kernel with
CUDA events on arrays far beyond the L2 cache and returns bytes per
second: the rate the SpMV kernels' bounds are stated against, beside the
card's published peak.

``plan_bytes`` counts the compulsory bytes of one call of a plan (its
resident buffers read once, each input and output moved once), and
``pct_roofline`` turns bytes, seconds and a bandwidth into a share.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build_cuda_library

__all__ = ["H100_HBM_BYTES_PER_S", "LAUNCHES", "triad", "triad_cuda",
           "triad_plain", "load_cuda_library", "measure_hbm_bw", "plan_bytes",
           "pct_roofline"]

#: published device-memory rate of one H100 SXM (NVIDIA data sheet)
H100_HBM_BYTES_PER_S = 3.35e12

#: kernel launches made by ``triad_cuda``: one per launch, nowhere else
LAUNCHES = {"triad": 0}

# CTAs per launch: 16 of 256 threads for each of the H100's 132 SMs
_BLOCKS = 132 * 16


@functools.cache
def load_cuda_library():
    """Build ``csrc/triad.cu`` with nvcc for sm_90a (first use) and load
    it; raises BuildError when nvcc is missing or refuses the source."""
    lib = ctypes.CDLL(build_cuda_library("triad"))
    vp = ctypes.c_void_p
    lib.triad.restype = ctypes.c_int
    lib.triad.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.triad_error_string.restype = ctypes.c_char_p
    lib.triad_error_string.argtypes = [ctypes.c_int]
    return lib


def triad_plain(a, s):
    """o = a * s + 0.5, the product and the sum rounded separately; ``s``
    is a one-element tensor on a's device."""
    return a * s.reshape(()) + 0.5


@torch.inference_mode()
def triad_cuda(a, s, out=None):
    """The CUDA kernel: ``a`` float32 and contiguous on a CUDA device,
    ``s`` a one-element float32 tensor there (read on the device, so
    launches chain without a host round trip).  ``out`` is written when
    given (same shape, float32, contiguous), else allocated."""
    dev = a.device
    if dev.type != "cuda" or s.device != dev:
        raise ValueError(f"triad_cuda needs a and s on one CUDA device; a on "
                         f"{dev}, s on {s.device}")
    if a.dtype != torch.float32 or s.dtype != torch.float32 or s.numel() != 1:
        raise TypeError("triad_cuda takes float32 a and a one-element "
                        f"float32 s; got {a.dtype}, {s.dtype} x {s.numel()}")
    if not a.is_contiguous():
        raise ValueError("triad_cuda needs a contiguous a")
    if out is None:
        out = torch.empty_like(a)
    elif (out.shape != a.shape or out.dtype != a.dtype or out.device != dev
          or not out.is_contiguous()):
        raise ValueError("out must match a in shape, dtype and device and "
                         "be contiguous")
    lib = load_cuda_library()
    n = a.numel()
    blocks = max(1, min(_BLOCKS, -(-n // 1024)))
    with torch.cuda.device(dev):
        err = lib.triad(a.data_ptr(), s.data_ptr(), out.data_ptr(), n, blocks,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"triad launch failed: {lib.triad_error_string(err).decode()}")
    LAUNCHES["triad"] += 1
    return out


def triad(a, s):
    """o = a * s + 0.5: the plain version for a CPU tensor, the CUDA kernel
    otherwise."""
    if a.device.type == "cpu" and s.device.type == "cpu":
        return triad_plain(a, s)
    return triad_cuda(a, s)


@torch.inference_mode()
def measure_hbm_bw(mb: int = 1024, reps: int = 10, trials: int = 3,
                   device=None) -> float:
    """Achieved device-memory bandwidth in bytes/s: the triad kernel reads
    ``mb`` MiB and writes ``mb`` MiB per launch (far beyond the L2 cache at
    the default), ``reps`` launches between two CUDA events, best of
    ``trials``.  Needs a CUDA device: there is no CPU reading of a device
    rate."""
    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_hbm_bw measures a CUDA device's memory; "
                         f"got device {dev}")
    n = mb * (1 << 20) // 4
    a = torch.ones(n, dtype=torch.float32, device=dev)
    o = torch.empty_like(a)
    s = torch.full((1,), 1.0000001, dtype=torch.float32, device=dev)
    triad_cuda(a, s, out=o)  # warm-up, and the build at first use
    best = None
    for _ in range(trials):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            triad_cuda(a, s, out=o)
        end.record()
        torch.cuda.synchronize(dev)
        sec = start.elapsed_time(end) * 1e-3 / reps
        best = sec if best is None else min(best, sec)
    expect = triad_plain(a[:8], s)
    if not torch.equal(o[:8], expect) or not torch.equal(o[-8:], expect):
        raise RuntimeError("bandwidth probe result mismatch")
    return 2.0 * a.numel() * 4 / best


def plan_bytes(plan, *io) -> int:
    """Compulsory bytes of one call: every buffer of ``plan`` (an
    nn.Module, the operator's resident state) that a call reads, once, plus
    each explicit ``io`` tensor moved once.  A module names the buffers a
    call reads with ``call_buffers()`` where they are not all of its own (a
    banded plan with an occupancy index reads the index and the packed run
    values, not the slabs); a buffer two modules share counts once."""
    read = {}
    for mod in plan.modules():
        own = mod.call_buffers() if hasattr(mod, "call_buffers") \
            else mod.buffers(recurse=False)
        read.update((id(b), b) for b in own)
    total = sum(b.numel() * b.element_size() for b in read.values())
    return total + sum(t.numel() * t.element_size() for t in io)


def pct_roofline(bytes_touched: int, seconds: float, bw: float) -> float:
    """Fraction of a memory roofline achieved: bytes over seconds over the
    bandwidth ``bw`` (measured, or ``H100_HBM_BYTES_PER_S``)."""
    if not (seconds and bw):
        return 0.0
    return (bytes_touched / seconds) / bw
