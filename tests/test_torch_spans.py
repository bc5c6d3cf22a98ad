"""The program's spans (``utils/profiling.py``): off, ``span`` is one shared
no-op that reads no clock and adds no tensor op, and the studies give
equal outputs through the same aten ops with a recorder open or not; on,
the span tree has the names, parents and counts of the calls made, the
set-up is timed by part, the spans share the clock of ``torch.profiler``'s
host records, and ``trace`` writes them into its Chrome trace."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models.contingency import DCContingency
from csparse3_tpu_torch.models.powerflow import (FastDecoupled,
                                                 NewtonPowerFlow, sbus)
from csparse3_tpu_torch.utils import profiling

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

N, K, OUTAGES, CHUNK = 300, 4, 20, 8


class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched inside it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _loads(grid, perm=None):
    sb = sbus(grid)[None, :] * np.linspace(0.8, 1.1, K)[:, None]
    return sb if perm is None else sb[:, perm]


@pytest.fixture(scope="module")
def studies():
    """{name: (recorder of its set-up, call of one batch)}."""
    g = pgrids.synthetic_grid(N, seed=3)
    out = {}
    with profiling.Timer() as rec:
        pf = NewtonPowerFlow(g, spmv="bandpoints", solver="multifrontal",
                             tol=1e-3, device="cpu")
    out["newton"] = (rec, lambda: pf.solve_batch(_loads(g)))
    with profiling.Timer() as rec:
        gr, perm = pgrids.rcm_grid(g)
        fd = FastDecoupled(gr, spmv="symdia", solver="blocklu", tol=1e-8,
                           max_iter=100, device="cpu")
    out["fdpf"] = (rec, lambda: fd.solve_batch(_loads(g, perm)))
    with profiling.Timer() as rec:
        dc = DCContingency(g, device="cpu")
    out["dc"] = (rec, lambda: dc.run(np.arange(OUTAGES), batch=CHUNK))
    for _, run in out.values():
        run()  # warm: the banded stacks upload at the first solve
    return out


def _no_clock(*_):
    raise AssertionError("a span read the clock while off")


def test_span_is_the_shared_noop_when_off(monkeypatch):
    monkeypatch.setattr(profiling, "time_ns", _no_clock)
    a, b = profiling.span("x", K=3), profiling.span("y")
    assert a is b
    with a as entered:
        entered.note(n=1)
    assert not hasattr(a, "counts")


@pytest.mark.parametrize("name", ["newton", "fdpf", "dc"])
def test_recorder_on_and_off_give_equal_outputs_and_ops(studies, name,
                                                        monkeypatch):
    _, run = studies[name]
    with profiling.Timer() as rec, _Ops() as on:
        got_on = run()
    assert rec.spans
    monkeypatch.setattr(profiling, "time_ns", _no_clock)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_clock)
    with _Ops() as off:
        got_off = run()
    assert on.ops == off.ops
    for x, y in zip(got_on, got_off):
        assert torch.equal(x, y)


def _tree(rec):
    spans = rec.spans
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans]


def test_newton_span_tree(studies):
    with profiling.Timer() as rec:
        _, _, it, _ = studies["newton"][1]()
    tree = Counter(_tree(rec))
    iters = int(it.max())
    assert tree[("study.batch", None)] == 1
    assert tree[("io.upload", "study.batch")] == 1
    assert tree[("pf.iteration", "study.batch")] == iters
    assert tree[("pf.mismatch", "study.batch")] == iters + 1
    assert tree[("spmv", "pf.mismatch")] == iters + 1
    assert tree[("host.sync", "study.batch")] == iters + 2
    for child in ("pf.jacobian", "front.factor", "front.solve"):
        assert tree[(child, "pf.iteration")] == iters
    assert sum(tree.values()) == 7 * iters + 6
    passes = [s.counts["i"] for s in rec.spans if s.name == "pf.iteration"]
    assert passes == list(range(iters))
    f = next(s for s in rec.spans if s.name == "front.factor")
    assert f.counts["K"] == K and f.counts["groups"] > 0
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)


def test_fdpf_span_tree(studies):
    with profiling.Timer() as rec:
        _, _, it = studies["fdpf"][1]()
    tree = Counter(_tree(rec))
    iters = int(it.max())
    assert tree[("pf.iteration", "study.batch")] == iters
    assert tree[("host.sync", "study.batch")] == iters + 1
    # one residual a pass, two mismatches a step
    assert tree[("pf.mismatch", "study.batch")] == iters + 1
    assert tree[("pf.mismatch", "pf.iteration")] == 2 * iters
    assert tree[("spmv", "pf.mismatch")] == 3 * iters + 1
    assert tree[("banded.sweeps", "pf.iteration")] == 2 * iters
    sweeps = next(s for s in rec.spans if s.name == "banded.sweeps")
    assert sweeps.counts["blocks"] >= 1 and sweeps.counts["s"] >= 1


def test_dc_span_tree(studies):
    with profiling.Timer() as rec:
        studies["dc"][1]()
    chunks = -(-OUTAGES // CHUNK)
    assert Counter(_tree(rec)) == {
        ("study.batch", None): chunks,
        ("front.factor", "study.batch"): chunks,
        ("front.retarget", "study.batch"): chunks,
        ("trisolve", "study.batch"): 2 * chunks}
    assert [s.counts["K"] for s in rec.spans if s.name == "study.batch"] \
        == [8, 8, 4]
    assert {s.counts["lower"] for s in rec.spans
            if s.name == "trisolve"} == {True, False}


@pytest.mark.parametrize("name,want", [
    ("newton", ["setup.plans", "setup.plans", "setup.symbolic"]),
    ("fdpf", ["setup.rcm", "setup.banded_factor", "setup.banded_factor",
              "setup.plans"]),
    ("dc", ["setup.symbolic"])])
def test_setup_spans(studies, name, want):
    rec = studies[name][0]
    assert [s.name for s in rec.spans] == want
    assert all(s.parent == -1 and s.seconds >= 0 for s in rec.spans)
    for s in rec.spans:
        if s.name == "setup.symbolic":
            assert s.counts["n"] > 0 and s.counts["front_floats"] > 0
        if s.name == "setup.banded_factor":
            assert s.counts["s"] >= s.counts["bw"] > 0


def test_spans_record_into_profiled_while_the_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    profiling.profiled().clear()
    x = torch.ones(4096)
    with profiling.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("inside", n=1):
            x.mul(2)
    with profiling.span("after"):
        pass
    spans = profiling.profiled().spans
    assert [s.name for s in spans] == ["inside"]
    # the host records of torch.profiler are on the spans' clock
    op = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mul")
    assert spans[0].start_ns <= op.start_ns() <= op.end_ns() \
        <= spans[0].end_ns
    profiling.profiled().clear()
    assert profiling.profiled().spans == []


def test_trace_writes_the_spans_as_a_host_track(tmp_path):
    x = torch.ones(4096)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", K=2):
            with profiling.span("inner"):
                x.mul(2)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(mine) == {"outer", "inner"}
    assert mine["outer"]["args"] == {"K": 2}
    op = next(e for e in events if e.get("name") == "aten::mul")
    lo, hi = mine["inner"]["ts"], mine["inner"]["ts"] + mine["inner"]["dur"]
    assert lo <= op["ts"] and op["ts"] + op["dur"] <= hi
    assert mine["outer"]["ts"] <= lo


def test_timer_sections_are_spans():
    t = profiling.Timer()
    with t.section("a"):
        with t.span("b", n=3) as b:
            pass
        with t.section("b"):
            pass
    assert [(s.name, s.parent) for s in t.spans] == [
        ("a", -1), ("b", 0), ("b", 0)]
    assert b.counts == {"n": 3}
    assert list(t.records) == ["a", "b"] and len(t.records["b"]) == 2
    assert "b" in t.summary()
    # a timer's own sections record whether or not it is open
    assert profiling.span("c") is profiling.span("d")
    with t:
        with profiling.span("c"):
            pass
    assert t.spans[-1].name == "c"
