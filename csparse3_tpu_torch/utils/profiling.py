"""Profiling and timing helpers, as the JAX package's ``csparse3_tpu/
utils/profiling.py``: ``timeit`` (median wall seconds, each call ending in
a synchronize of the device its results lie on), ``nnz_per_sec``, the
section ``Timer``, ``trace`` (a ``torch.profiler`` context that writes a
Chrome trace) and ``compare_with_scipy``.

The program's spans.  ``span(name, **counts)`` marks one call of a layer
of the program (a study's batch, a front factorization, a sweep; never a
loop step of a level or a group), with its static sizes as ``counts``.
A ``Timer`` is the recorder: while one is open (``with Timer() as rec:``)
every span records into it, and while ``torch.profiler`` runs with none
open they record into ``profiled()``.  Otherwise ``span`` returns one
shared no-op context: it reads no clock, adds no tensor op and never
synchronizes.  A recorded span reads ``time.time_ns()`` twice (the clock
of ``torch.profiler``'s host records, so the device records of a profile
can be put inside the spans that issued them) and appends itself to its
recorder's ``spans``; nothing is written out until the recorder is read.
Sizes known only inside the span are added with ``note``.  One host
thread records at a time.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from time import time_ns
from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["timeit", "Timer", "nnz_per_sec", "trace", "compare_with_scipy",
           "Span", "span", "profiled"]

_TORCH_PROFILER = torch.autograd.profiler


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


class Span:
    """One span: ``name``, ``start_ns`` / ``end_ns`` (``time.time_ns()``;
    ``end_ns`` 0 while open), ``parent`` (the index in its recorder's
    ``spans`` of the span that was open when it opened, -1 for none) and
    ``counts`` (the sizes given to ``span``)."""

    __slots__ = ("rec", "name", "counts", "parent", "start_ns", "end_ns")

    def __init__(self, rec, name, counts):
        self.rec, self.name, self.counts = rec, name, counts
        self.parent, self.start_ns, self.end_ns = -1, 0, 0

    def __enter__(self):
        rec = self.rec
        self.parent, rec._open = rec._open, len(rec.spans)
        rec.spans.append(self)
        self.start_ns = time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time_ns()
        self.rec._open, self.rec = self.parent, None
        return False

    def note(self, **counts):
        """Add ``counts`` to the span's sizes."""
        self.counts.update(counts)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _NoSpan:
    """The span when nothing records: enters and notes nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **counts):
        pass


class Timer:
    """The span recorder, printable as a table.  ``span(name, **counts)``
    (``section``) records into this timer; while it is open (``with
    timer:``) so does every ``span`` of the program.  ``spans``: the
    ``Span`` records in the order they opened; ``records``: {name:
    [seconds of each closed span]}."""

    def __init__(self):
        self.spans: List[Span] = []
        self._open = -1
        self._outer = []

    def span(self, name: str, **counts) -> Span:
        return Span(self, name, counts)

    #: the JAX package's name
    section = span

    @property
    def records(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for s in self.spans:
            if s.end_ns:
                out.setdefault(s.name, []).append(s.seconds)
        return out

    def summary(self) -> str:
        lines = [f"{'section':<32}{'calls':>6}{'total_s':>10}{'mean_ms':>10}"]
        for name, ts in self.records.items():
            lines.append(f"{name:<32}{len(ts):>6}{sum(ts):>10.3f}"
                         f"{1e3 * np.mean(ts):>10.2f}")
        return "\n".join(lines)

    def clear(self):
        """Forget the spans recorded so far."""
        self.spans, self._open = [], -1

    def __enter__(self):
        global _ACTIVE
        self._outer.append(_ACTIVE)
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._outer.pop()
        return False


#: the open recorder, or None
_ACTIVE: Timer | None = None
#: where spans record while torch.profiler runs and no recorder is open
_PROFILED = Timer()
_NO_SPAN = _NoSpan()


def span(name: str, **counts):
    """A span of the program named ``name`` with the sizes ``counts``, as
    a context: recorded by the open recorder, else by ``profiled()``
    while ``torch.profiler`` runs, else the shared no-op."""
    rec = _ACTIVE
    if rec is None:
        if not _TORCH_PROFILER._is_profiler_enabled:
            return _NO_SPAN
        rec = _PROFILED
    return Span(rec, name, counts)


def profiled() -> Timer:
    """The recorder of the spans made while ``torch.profiler`` ran and no
    recorder was open, since the process started or its ``clear()``."""
    return _PROFILED


def _add_spans(path: str, spans) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as a host track of
    their own ("program spans"), on the trace's clock."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
         "tid": "program spans", "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {k: v if isinstance(v, (int, float, str)) else str(v)
                  for k, v in s.counts.items()}}
        for s in spans if s.end_ns)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present) with a recorder open; on exit the Chrome trace is
    written to ``log_dir/trace.json``, the program's spans in it as a host
    track of their own.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with Timer() as rec, torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, rec.spans)


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
