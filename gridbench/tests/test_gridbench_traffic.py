"""The traffic generator: deterministic in the seed, in range, and every
seed the same kind of work."""

import json
import os

import numpy as np
import pytest
import torch

from _tiny import PKG, small_grid
from gridbench.spec import stream_module

load_factors = stream_module("load_profile").load_factors


def make_traffic(p, arrays, seed, batch, order=None):
    return stream_module(p["kind"]).Stream(p, arrays, seed, batch, order)

torch.set_num_threads(1)


def _mix(name, **over):
    with open(os.path.join(PKG, "traffic", f"{name}.json")) as f:
        p = json.load(f)
    p.update(over)
    return p


@pytest.fixture(scope="module")
def arrays():
    return small_grid(200)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_load_factors_in_range_and_deterministic(seed):
    p = _mix("ts")
    a, b = load_factors(p, seed), load_factors(p, seed)
    assert np.array_equal(a, b)
    assert a.shape == (8760,)
    assert a.min() == pytest.approx(0.60) and a.max() == pytest.approx(1.05)
    assert not np.array_equal(a, load_factors(p, seed + 1))


def test_snapshots_deterministic_and_seeded(arrays):
    p = _mix("ts", pool_hours=16)
    t1 = make_traffic(p, arrays, 2**33 + 1, 4)
    t2 = make_traffic(p, arrays, 2**33 + 1, 4)
    t3 = make_traffic(p, arrays, 2**33 + 2, 4)
    assert np.array_equal(t1.pool, t2.pool)
    assert not np.array_equal(t1.pool, t3.pool)
    assert t1.payload(5).shape == (4, 200)
    # batch b is pool rows [bK, (b+1)K) modulo the pool, a view
    assert np.shares_memory(t1.payload(1), t1.pool)
    assert np.array_equal(t1.items(5), np.arange(4, 8))


def test_snapshot_is_base_times_factor_with_bus_noise(arrays):
    p = _mix("ts", pool_hours=256)
    t = make_traffic(p, arrays, 7, 4)
    base = (arrays["pg"] - arrays["pd"]) - 1j * arrays["qd"]
    live = np.abs(base.real) > 1e-6
    ratio = t.pool.real[:, live] / base.real[live]
    # the row's mean ratio is the hour's factor, the spread 3% of it
    fac = t.factors[t.hours]
    assert np.allclose(ratio.mean(1), fac, rtol=0.02)
    assert np.allclose((ratio / fac[:, None]).std(1), 0.03, rtol=0.2)
    both = np.abs(base.imag) > 1e-6
    assert np.allclose(t.pool.imag[:, both] / base.imag[both],
                       t.pool.real[:, both] / base.real[both])


def test_order_holds_the_pool_in_the_study_bus_order(arrays):
    p = _mix("ts", pool_hours=8)
    order = np.random.default_rng(0).permutation(200)
    t = make_traffic(p, arrays, 9, 4, order=order)
    base = ((arrays["pg"] - arrays["pd"]) - 1j * arrays["qd"])[order]
    live = np.abs(base.real) > 1e-6
    ratio = t.pool.real[:, live] / base.real[live]
    assert np.allclose(ratio.mean(1), t.factors[t.hours], rtol=0.02)


def test_pool_must_hold_whole_batches(arrays):
    with pytest.raises(ValueError):
        make_traffic(_mix("ts", pool_hours=10), arrays, 1, 4)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_outages_cycle_every_branch(arrays, seed):
    m = len(arrays["f"])
    t = make_traffic(_mix("n1"), arrays, seed, 7)
    seen = np.concatenate([t.items(b) for b in range(-(-m // 7))])
    assert np.array_equal(np.sort(seen[:m]), np.arange(m))
    assert np.array_equal(t.items(3),
                          make_traffic(_mix("n1"), arrays, seed, 7).items(3))
    other = make_traffic(_mix("n1"), arrays, seed + 1, 7)
    assert not np.array_equal(t.order, other.order)
