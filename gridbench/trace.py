"""The card's activity over a traced slice, from ``torch.profiler``.

Only the device's records are kept (``ProfilerActivity.CUDA``): turning
the host's op records into events costs the host tens of microseconds
each, and a long profile drops records.  The arithmetic is
``chip_smoke.py``'s ``device_profile`` (busy time as the union of the
device intervals), copied so that an edit of that script cannot move the
yardstick.
"""

from __future__ import annotations

import time
from collections import defaultdict


def busy_seconds(spans) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


def idle_gaps(records):
    """{"after <name>": seconds} of the device's idle gaps, each gap named
    by the record that ended last before it."""
    gaps = defaultdict(float)
    end, last = None, None
    for name, a, b in sorted(records, key=lambda r: r[1]):
        if end is not None and a > end:
            gaps[f"after {last}"] += (a - end) * 1e-6
        if end is None or b > end:
            end, last = b, name
    return dict(gaps)


def kind_of(name: str) -> str:
    """'memcpy', 'memset' or 'kernel' for a device record's name."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def summarize(records, wall_s: float, counted=None) -> dict:
    """The slice's numbers from its device records ``(name, start_us,
    end_us)``: busy_s, window_s (``wall_s``), launches by kind, {name:
    [count, seconds]}, the idle gaps, and ``complete``: for each kernel
    name of ``counted`` ({name: launches the program counted}), whether the
    profiler recorded that many records whose name contains it."""
    by_name = defaultdict(lambda: [0, 0.0])
    kinds = defaultdict(int)
    for name, a, b in records:
        by_name[name][0] += 1
        by_name[name][1] += (b - a) * 1e-6
        kinds[kind_of(name)] += 1
    complete = {}
    for key, want in (counted or {}).items():
        got = sum(c for n, (c, _) in by_name.items() if key in n)
        complete[key] = got == want
    return dict(busy_s=busy_seconds([(a, b) for _, a, b in records]),
                window_s=wall_s, launches=sum(kinds.values()),
                kinds=dict(kinds), by_name=dict(by_name),
                gaps=idle_gaps(records), complete=complete)


def kernel_time(summary: dict, key: str):
    """(records, device seconds) of the records whose name contains
    ``key``."""
    recs = [v for n, v in summary["by_name"].items() if key in n]
    return sum(c for c, _ in recs), sum(s for _, s in recs)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The ``breakdown`` of a traced result line: the device operations
    that took most time and the longest idle gaps, at most ``top`` each."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][1])
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, (_, s) in ops[:top]],
            "idle_gaps": [[n[:160], s] for n, s in gaps[:top]]}


def profile_device(fn):
    """Run ``fn()`` under ``torch.profiler`` recording the card's activity
    alone; returns (fn's result, [(name, start_us, end_us)], wall s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    records = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, records, wall
