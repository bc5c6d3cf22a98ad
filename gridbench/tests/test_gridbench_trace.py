"""The arithmetic of a traced slice: busy time, idle gaps, launches."""

import pytest

from _tiny import ROOT  # noqa: F401
from gridbench.trace import (breakdown, busy_seconds, idle_gaps, kind_of,
                             kernel_time, summarize)

RECS = [("k_a", 0.0, 10.0), ("k_b", 5.0, 12.0), ("Memcpy DtoH", 20.0, 30.0),
        ("k_a", 40.0, 41.0), ("Memset (Device)", 41.0, 42.0)]


def test_busy_is_the_union():
    assert busy_seconds([(a, b) for _, a, b in RECS]) == pytest.approx(
        (12 + 10 + 2) * 1e-6)
    assert busy_seconds([]) == 0.0


def test_idle_gaps_named_by_what_ended_last():
    g = idle_gaps(RECS)
    assert g == pytest.approx({"after k_b": 8e-6, "after Memcpy DtoH": 10e-6})


def test_summary_counts_and_idle_share():
    s = summarize(RECS, 100e-6, {"k_a": 2, "k_b": 3})
    assert s["launches"] == 5
    assert s["kinds"] == {"kernel": 3, "memcpy": 1, "memset": 1}
    assert s["complete"] == {"k_a": True, "k_b": False}
    assert 1 - s["busy_s"] / s["window_s"] == pytest.approx(0.76)
    assert kernel_time(s, "k_a") == (2, pytest.approx(11e-6))
    b = breakdown(s, top=2)
    assert [n for n, _ in b["device_ops"]] == ["k_a", "Memcpy DtoH"]
    assert b["idle_gaps"][0][0] == "after Memcpy DtoH"


@pytest.mark.parametrize("name,kind", [
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("Memset (Device)", "memset"),
    ("void band_points_entries_kernel<float>(int)", "kernel")])
def test_kind_of(name, kind):
    assert kind_of(name) == kind
