"""Profiling and timing helpers, as the JAX package's ``csparse3_tpu/
utils/profiling.py``: ``timeit`` (median wall seconds, each call ending in
a synchronize of the device its results lie on), ``nnz_per_sec``, the
section ``Timer``, ``trace`` (a ``torch.profiler`` context that writes a
Chrome trace) and ``compare_with_scipy``."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["timeit", "Timer", "nnz_per_sec", "trace", "compare_with_scipy"]


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)
    elif hasattr(out, "_arrays"):  # a container: its tensors made so far
        yield from _tensors([a for a in out._arrays
                             if isinstance(a, torch.Tensor)])


def _synchronize(out):
    """Wait for the CUDA devices that the tensors in ``out`` (a tensor, a
    container, or tuples, lists and dicts of them) lie on; nothing when all
    are on the CPU.  Returns ``out``."""
    for d in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(d)
    return out


def timeit(fn: Callable, *args, iters: int = 5, warmup: int = 2,
           **kw) -> float:
    """Median wall seconds of fn(*args, **kw), each call synchronized."""
    for _ in range(warmup):
        _synchronize(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def nnz_per_sec(nnz: int, seconds: float) -> float:
    return nnz / seconds if seconds > 0 else float("inf")


@dataclass
class Timer:
    """Named section timer, printable as a table."""

    records: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = [f"{'section':<32}{'calls':>6}{'total_s':>10}{'mean_ms':>10}"]
        for name, ts in self.records.items():
            lines.append(f"{name:<32}{len(ts):>6}{sum(ts):>10.3f}"
                         f"{1e3 * np.mean(ts):>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present); on exit the Chrome trace is written to
    ``log_dir/trace.json``.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def compare_with_scipy(a, op: str = "spmv", iters: int = 5, seed: int = 0,
                       device=None):
    """Time one of the port's operations against scipy running the same op
    on the host: 'spmv' (an ``SpMVPlan`` on ``device``, None: the default
    device) or 'spgemm' (A A^T: ``spgemm`` on the host).  Returns a dict."""
    from ..config import resolve_device
    from ..ops.construct import transpose
    from ..ops.matvec import SpMVPlan
    from ..ops.spgemm import spgemm

    rng = np.random.RandomState(seed)
    s = a.to_scipy()
    out = {"op": op, "m": a.m, "n": a.n, "nnz": a.nnz}
    if op == "spmv":
        x = rng.rand(a.n)
        if np.iscomplexobj(s.data):
            x = x + 1j * rng.rand(a.n)
        dev = resolve_device(device)
        plan = SpMVPlan(a, device=dev)
        xt = torch.as_tensor(x, device=dev)
        with torch.inference_mode():
            out["ours_s"] = timeit(plan, xt, iters=iters)
        sr = s.tocsr()
        t0 = time.perf_counter()
        for _ in range(iters):
            sr @ x
        out["scipy_s"] = (time.perf_counter() - t0) / iters
    elif op == "spgemm":
        t0 = time.perf_counter()
        spgemm(a, transpose(a))
        out["ours_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (s @ s.T).tocsc()
        out["scipy_s"] = time.perf_counter() - t0
    else:
        raise ValueError(f"unknown op {op!r}")
    out["speedup"] = out["scipy_s"] / out["ours_s"]
    out["nnz_per_s"] = nnz_per_sec(a.nnz, out["ours_s"])
    return out
