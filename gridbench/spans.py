"""The program's spans set against the card's records of a traced slice.

The program marks each call of one of its layers with a span
(``csparse3_tpu_torch.utils.profiling.span``: a study's batch, a front
factorization, a sweep, a host read), timed with ``time.time_ns()``, the
clock of ``torch.profiler``'s host records.  While ``torch.profiler``
runs and no recorder of the program's is open, the spans record into
``profiling.profiled()``: so a traced run of the harness leaves the
slice's spans there, and a program without spans leaves nothing to read.

``profile_linked`` profiles a slice like ``trace.profile_device`` and
also gives, for each device record, the host start of the CUDA runtime
call that issued it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...),
joined by correlation id.  ``attribute`` then gives each span name its
calls, host self seconds (its duration less its children's), the device
seconds and records it issued (the innermost span open at the runtime
call), and the device-idle seconds while it was the innermost open span.

Every time below is in one frame: microseconds from the profile's start,
as ``trace.profile_device`` gives the device records.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

#: device records issued, and idle time, outside every span
OUTSIDE = "(outside)"
#: device records with no runtime record
UNLINKED = "(unlinked)"
#: the spans that wait for the card or move data, not issue work
NOT_DISPATCH = ("host.sync", "io.", "bench.")


def recorded():
    """The Span records the program made while ``torch.profiler`` ran (its
    ``profiling.profiled()``), or None where the program has no spans."""
    try:
        from csparse3_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "profiled", None)
    return None if rec is None else list(rec().spans)


def in_frame(spans, base_ns: int = 0):
    """``spans`` (the program's Span records, closed ones) as (name,
    start_us, end_us, parent) tuples, microseconds from ``base_ns``; a
    parent is an index into the list returned, -1 for none."""
    keep = [i for i, s in enumerate(spans) if s.end_ns]
    new = {old: j for j, old in enumerate(keep)}
    out = []
    for i in keep:
        s = spans[i]
        out.append((s.name, (s.start_ns - base_ns) / 1e3,
                    (s.end_ns - base_ns) / 1e3, new.get(s.parent, -1)))
    return out


def self_seconds(spans) -> dict:
    """{name: seconds} of host self time: each span's duration less the
    durations of its children.  ``spans`` as ``in_frame`` gives them."""
    child = defaultdict(float)
    for _, a, b, p in spans:
        if p >= 0:
            child[p] += b - a
    out = defaultdict(float)
    for i, (name, a, b, _) in enumerate(spans):
        out[name] += (b - a - child[i]) * 1e-6
    return dict(out)


def self_share(spans, names, window_s: float):
    """Host self time of the spans named ``names`` as a share of
    ``window_s``, in %; None without spans or window."""
    if not spans or not window_s:
        return None
    own = self_seconds(spans)
    return 100.0 * sum(own.get(n, 0.0) for n in names) / window_s


def timeline(spans):
    """[(start_us, end_us, name)]: the innermost open span over time, in
    order, ``OUTSIDE`` where none is open, from -inf to inf.  The spans
    are properly nested, as one host thread makes them."""
    kids = defaultdict(list)
    for i, (_, a, _, p) in enumerate(spans):
        kids[p].append((a, i))
    inner = []

    def walk(i):
        name, a, b, _ = spans[i]
        t = a
        for ca, c in sorted(kids[i]):
            if ca > t:
                inner.append((t, ca, name))
            walk(c)
            t = max(t, spans[c][2])
        if b > t:
            inner.append((t, b, name))

    for _, i in sorted(kids[-1]):
        walk(i)
    out, t = [], float("-inf")
    for a, b, name in inner:
        if a > t:
            out.append((t, a, OUTSIDE))
        out.append((a, b, name))
        t = b
    out.append((t, float("inf"), OUTSIDE))
    return out


def owners(spans, links):
    """The span that issued each device record: the innermost span open at
    its runtime call's start (``UNLINKED`` where it has none)."""
    tl = timeline(spans)
    starts = [a for a, _, _ in tl]
    return [UNLINKED if h is None
            else tl[bisect.bisect_right(starts, h) - 1][2] for h in links]


def idle_intervals(records, window):
    """The intervals of ``window`` (start_us, end_us) in which no device
    record ran, in order."""
    out, t = [], window[0]
    for _, a, b in sorted(records, key=lambda r: r[1]):
        if a > t:
            out.append((t, min(a, window[1])))
        t = max(t, b)
        if t >= window[1]:
            break
    if t < window[1]:
        out.append((t, window[1]))
    return [(a, b) for a, b in out if b > a]


def idle_by_owner(spans, records, window) -> dict:
    """{name: seconds} of the device's idle time in ``window``, by the
    innermost span open meanwhile (``OUTSIDE`` for none)."""
    idle, tl = idle_intervals(records, window), timeline(spans)
    out = defaultdict(float)
    i = j = 0
    while i < len(idle):
        a, b = max(idle[i][0], tl[j][0]), min(idle[i][1], tl[j][1])
        if b > a:
            out[tl[j][2]] += (b - a) * 1e-6
        if idle[i][1] <= tl[j][1]:
            i += 1
        else:
            j += 1
    return dict(out)


def attribute(spans, records, links, window) -> dict:
    """{span name: {calls, self_s, device_s, launches, idle_s}} of a
    traced slice: ``spans`` as ``in_frame`` gives them, device
    ``records`` (name, start_us, end_us), ``links`` the host start of
    each record's runtime call (None: not found), ``window`` the slice's
    (start_us, end_us).  ``OUTSIDE`` takes what no span covers,
    ``UNLINKED`` the records with no runtime call."""
    table = defaultdict(lambda: dict(calls=0, self_s=0.0, device_s=0.0,
                                     launches=0, idle_s=0.0))
    for name, _, _, _ in spans:
        table[name]["calls"] += 1
    for name, s in self_seconds(spans).items():
        table[name]["self_s"] = s
    for (_, a, b), who in zip(records, owners(spans, links)):
        table[who]["device_s"] += (b - a) * 1e-6
        table[who]["launches"] += 1
    for who, s in idle_by_owner(spans, records, window).items():
        table[who]["idle_s"] = s
    return dict(table)


def idle_share(table, names=None) -> float:
    """Device-idle seconds of the spans ``names`` (None: the program's
    compute spans, every name but ``OUTSIDE``, ``UNLINKED`` and
    ``NOT_DISPATCH``) as a share of the slice's idle time, in %."""
    total = sum(v["idle_s"] for v in table.values())
    if not total:
        return 0.0
    if names is None:
        names = [n for n in table if n not in (OUTSIDE, UNLINKED)
                 and not n.startswith(NOT_DISPATCH)]
    return 100.0 * sum(table[n]["idle_s"] for n in names
                       if n in table) / total


def by_span(table, top: int = 12):
    """[[name, calls, self_s, device_s, launches, idle_s]] of the ``top``
    span names of most self time (the rows that hold self time first)."""
    rows = sorted(table.items(), key=lambda kv: (-kv[1]["self_s"],
                                                 -kv[1]["idle_s"]))
    return [[n, v["calls"], v["self_s"], v["device_s"], v["launches"],
             v["idle_s"]] for n, v in rows[:top]]


def table_text(table) -> str:
    """The whole table, one line a span name."""
    lines = [f"{'span':<24}{'calls':>8}{'self_s':>10}{'device_s':>10}"
             f"{'launches':>10}{'idle_s':>10}"]
    for n, c, s, d, k, i in by_span(table, len(table)):
        lines.append(f"{n:<24}{c:>8}{s:>10.4f}{d:>10.4f}{k:>10}{i:>10.4f}")
    return "\n".join(lines)


def profile_linked(fn):
    """``trace.profile_device`` with the runtime calls: runs ``fn()`` under
    ``torch.profiler`` (the card's activity alone) and returns (fn's
    result, records [(name, start_us, end_us)], links [host start_us of
    each record's runtime call, or None], wall s, window (start_us,
    end_us) of the slice, base_ns: the profile's start in
    ``time.time_ns()``'s clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, w0 = time.perf_counter(), time.time_ns()
        out = fn()
        torch.cuda.synchronize()
        wall, w1 = time.perf_counter() - t0, time.time_ns()
    res = prof.profiler.kineto_results
    base = res.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    device, runtime = [], {}
    for e in res.events():
        if e.device_type() == cuda:
            device.append(e)
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
    records, links = [], []
    for e in device:
        records.append((e.name(), (e.start_ns() - base) / 1e3,
                        (e.end_ns() - base) / 1e3))
        h = runtime.get(e.correlation_id(),
                        runtime.get(e.linked_correlation_id()))
        links.append(None if h is None else (h - base) / 1e3)
    return out, records, links, wall, ((w0 - base) / 1e3,
                                       (w1 - base) / 1e3), base
