"""The program's spans against a traced slice's device records, on fixed
spans, records and links: self time, the innermost span over time, the
records each span issued, the idle time inside each, the readers of the
span metrics, and the existing metrics' values on the same records."""

import pytest

from _tiny import ROOT, real_bench
from csparse3_tpu_torch.utils import profiling
from gridbench import spans as sp
from gridbench import trace as tr
from gridbench.spec import _find, _module

# bench.batch [0, 100] > study.batch [5, 95] > io.upload [10, 20],
# front.factor [30, 60], host.sync [70, 90]
SPANS = [("bench.batch", 0.0, 100.0, -1), ("study.batch", 5.0, 95.0, 0),
         ("io.upload", 10.0, 20.0, 1), ("front.factor", 30.0, 60.0, 1),
         ("host.sync", 70.0, 90.0, 1)]
RECS = [("Memcpy HtoD (Pageable -> Device)", 12.0, 40.0),
        ("k_front", 40.0, 50.0), ("k_front", 55.0, 58.0),
        ("k_sync", 75.0, 80.0), ("Memcpy DtoH (Device -> Pinned)", 96.0, 98.0),
        ("k_lost", 101.0, 102.0)]
LINKS = [15.0, 35.0, 45.0, 65.0, 96.0, None]
WINDOW = (0.0, 110.0)
IDLE = {"bench.batch": 8e-6, "study.batch": 20e-6, "io.upload": 2e-6,
        "front.factor": 7e-6, "host.sync": 15e-6, sp.OUTSIDE: 9e-6}


def test_self_time_is_the_duration_less_the_children():
    assert sp.self_seconds(SPANS) == pytest.approx(
        {"bench.batch": 10e-6, "study.batch": 30e-6, "io.upload": 10e-6,
         "front.factor": 30e-6, "host.sync": 20e-6})
    assert sp.self_share(SPANS, ("front.factor",), 110e-6) == \
        pytest.approx(100 * 30 / 110)
    assert sp.self_share([], ("front.factor",), 1.0) is None


def test_the_timeline_is_the_innermost_open_span():
    tl = sp.timeline(SPANS)
    assert [(a, b, n) for a, b, n in tl[1:-1]] == [
        (0.0, 5.0, "bench.batch"), (5.0, 10.0, "study.batch"),
        (10.0, 20.0, "io.upload"), (20.0, 30.0, "study.batch"),
        (30.0, 60.0, "front.factor"), (60.0, 70.0, "study.batch"),
        (70.0, 90.0, "host.sync"), (90.0, 95.0, "study.batch"),
        (95.0, 100.0, "bench.batch")]
    assert tl[0][2] == tl[-1][2] == sp.OUTSIDE
    assert sp.owners(SPANS, LINKS) == [
        "io.upload", "front.factor", "front.factor", "study.batch",
        "bench.batch", sp.UNLINKED]


def test_idle_time_goes_to_the_span_open_meanwhile():
    assert sp.idle_intervals(RECS, WINDOW) == [
        (0.0, 12.0), (50.0, 55.0), (58.0, 75.0), (80.0, 96.0),
        (98.0, 101.0), (102.0, 110.0)]
    assert sp.idle_by_owner(SPANS, RECS, WINDOW) == pytest.approx(IDLE)
    # no span at all: the whole idle time is outside
    assert sp.idle_by_owner([], RECS, WINDOW) == pytest.approx(
        {sp.OUTSIDE: sum(IDLE.values())})


def test_attribute_and_by_span():
    t = sp.attribute(SPANS, RECS, LINKS, WINDOW)
    assert t["front.factor"] == pytest.approx(dict(
        calls=1, self_s=30e-6, device_s=13e-6, launches=2, idle_s=7e-6))
    assert t["io.upload"]["device_s"] == pytest.approx(28e-6)
    assert t[sp.UNLINKED]["launches"] == 1
    assert sum(v["launches"] for v in t.values()) == len(RECS)
    assert sum(v["idle_s"] for v in t.values()) == pytest.approx(
        110e-6 - tr.busy_seconds([(a, b) for _, a, b in RECS]))
    # the program's compute spans: study.batch and front.factor
    assert sp.idle_share(t) == pytest.approx(100 * 27 / 61)
    assert sp.idle_share(t, ["io.upload"]) == pytest.approx(100 * 2 / 61)
    rows = sp.by_span(t, top=3)
    assert [r[0] for r in rows] == ["study.batch", "front.factor",
                                    "host.sync"]
    assert rows[1][1:] == pytest.approx([1, 30e-6, 13e-6, 2, 7e-6])
    assert len(sp.table_text(t).splitlines()) == len(t) + 1


def test_in_frame_keeps_closed_spans_and_their_parents():
    t = profiling.Timer()
    with t.span("a"):
        with t.span("b"):
            pass
    t.span("open").__enter__()
    base = t.spans[0].start_ns
    got = sp.in_frame(t.spans, base)
    assert [(n, p) for n, _, _, p in got] == [("a", -1), ("b", 0)]
    assert got[0][1] == 0.0 and got[1][2] <= got[0][2]


def _reader(name):
    return _module(_find(ROOT, "metrics", f"{name}.py"), name)


def _program_spans(base_ns=10**18):
    """SPANS as the program's Span records."""
    out = []
    for name, a, b, p in SPANS:
        s = profiling.Span(None, name, {})
        s.start_ns, s.end_ns = base_ns + int(a * 1e3), base_ns + int(b * 1e3)
        s.parent = p
        out.append(s)
    return out


READERS = [("front_lu_self.ts", "snapshot", 30 / 110),
           ("front_lu_self.n1", "outage", 30 / 110),
           ("level_solve_self.n1", "outage", 0.0),
           ("banded_self.ts", "snapshot", 0.0)]


@pytest.mark.parametrize("name,item,share", READERS)
def test_span_readers(name, item, share, monkeypatch):
    ctx = dict(item=item, trace=dict(window_s=110e-6))
    monkeypatch.setattr(profiling.profiled(), "spans", _program_spans())
    assert _reader(name).read(ctx) == pytest.approx(100 * share)
    other = "outage" if item == "snapshot" else "snapshot"
    assert _reader(name).read(dict(ctx, item=other)) is None
    assert _reader(name).read(dict(ctx, trace=None)) is None
    # a program that records no spans, or has none to record
    monkeypatch.setattr(profiling.profiled(), "spans", [])
    assert _reader(name).read(ctx) is None
    monkeypatch.delattr(profiling, "profiled")
    assert _reader(name).read(ctx) is None


def test_span_readers_are_the_benchmarks():
    per_layer = {m["name"]: m for m in real_bench()["per_layer"]}
    for name, _, _ in READERS:
        assert per_layer[name]["source"] == "program_span"
        assert per_layer[name]["workloads"]


def test_the_existing_metrics_read_the_same_records_alike():
    s = tr.summarize(RECS, 110e-6, {"k_front": 2})
    ctx = dict(item="snapshot", items=4, trace=s)
    assert _reader("device_idle.ts").read(ctx) == pytest.approx(
        100 * 61 / 110)
    assert _reader("launches_per_snapshot").read(ctx) == 6 / 4
    # gaps inside the records only, each named by what ended before it
    assert tr.breakdown(s)["idle_gaps"][0] == [
        "after k_front", pytest.approx(22e-6)]
