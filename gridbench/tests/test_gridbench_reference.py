"""The reference against cases solved by hand and IEEE 14's published
solution."""

import numpy as np
import pytest
import scipy.sparse as sp

from _tiny import ROOT  # noqa: F401
from gridbench.reference import contingency, network, powerflow

PQ, PV, SLACK = 0, 1, 2


def _grid(n, f, t, x, r=None, b=None, tap=None, bus_type=None, pd=None,
          qd=None, pg=None, vm0=None, bs=None):
    m = len(f)
    z = np.zeros
    return dict(n_bus=n, f=np.asarray(f), t=np.asarray(t),
                r=z(m) if r is None else np.asarray(r, float),
                x=np.asarray(x, float), b=z(m) if b is None else np.asarray(b),
                tap=np.ones(m) if tap is None else np.asarray(tap, float),
                bus_type=np.asarray(bus_type), pd=np.asarray(pd, float),
                qd=z(n) if qd is None else np.asarray(qd, float),
                pg=z(n) if pg is None else np.asarray(pg, float),
                vm0=np.ones(n) if vm0 is None else np.asarray(vm0, float),
                gs=z(n), bs=z(n) if bs is None else np.asarray(bs, float))


# a lossless star: slack 0 feeds four unity-power-factor loads, one line
# each, so every spoke solves alone: V = cos d, sin 2d = -2 P x
X5 = np.array([0.1, 0.2, 0.15, 0.25])
P5 = np.array([0.5, 0.8, 1.0, 0.6])
STAR5 = _grid(5, [0, 0, 0, 0], [1, 2, 3, 4], X5,
              bus_type=[SLACK, PQ, PQ, PQ, PQ], pd=np.r_[0.0, P5])


def _star_solution():
    d = -0.5 * np.arcsin(2 * P5 * X5)
    return np.r_[1.0, np.cos(d)], np.r_[0.0, d]


@pytest.mark.parametrize("solve,per_vm,tol", [
    (powerflow.newton, False, 1e-12), (powerflow.fdpf, True, 1e-12)])
def test_five_bus_star_by_hand(solve, per_vm, tol):
    Y = network.ybus(STAR5)
    sb = network.sbus(STAR5)
    vm, va, it = solve(Y, sb, STAR5, tol, 50)
    want_vm, want_va = _star_solution()
    assert it < 50
    assert np.abs(vm - want_vm).max() < 1e-9
    assert np.abs(va - want_va).max() < 1e-9
    pvpq, pq, _ = network.index_sets(STAR5)
    assert powerflow.mismatch(Y, vm, va, sb, pvpq, pq, per_vm)[0] <= 1e-9
    # the exact state's mismatch is nought; a moved angle's is not
    assert powerflow.mismatch(Y, want_vm, want_va, sb, pvpq, pq)[0] < 1e-12
    assert powerflow.mismatch(Y, want_vm, want_va + [0, 1e-3, 0, 0, 0], sb,
                              pvpq, pq)[0] > 1e-3


# IEEE 14 (MATPOWER case14, 100 MVA) and the solution its case file holds
BR14 = np.array([
    [1, 2, 0.01938, 0.05917, 0.0528, 1], [1, 5, 0.05403, 0.22304, 0.0492, 1],
    [2, 3, 0.04699, 0.19797, 0.0438, 1], [2, 4, 0.05811, 0.17632, 0.034, 1],
    [2, 5, 0.05695, 0.17388, 0.0346, 1], [3, 4, 0.06701, 0.17103, 0.0128, 1],
    [4, 5, 0.01335, 0.04211, 0, 1], [4, 7, 0, 0.20912, 0, 0.978],
    [4, 9, 0, 0.55618, 0, 0.969], [5, 6, 0, 0.25202, 0, 0.932],
    [6, 11, 0.09498, 0.1989, 0, 1], [6, 12, 0.12291, 0.25581, 0, 1],
    [6, 13, 0.06615, 0.13027, 0, 1], [7, 8, 0, 0.17615, 0, 1],
    [7, 9, 0, 0.11001, 0, 1], [9, 10, 0.03181, 0.0845, 0, 1],
    [9, 14, 0.12711, 0.27038, 0, 1], [10, 11, 0.08205, 0.19207, 0, 1],
    [12, 13, 0.22092, 0.19988, 0, 1], [13, 14, 0.17093, 0.34802, 0, 1]])
BUS14 = np.array([  # type, Pd, Qd, Pg, Vm set, Bs; solution Vm, Va deg
    [SLACK, 0, 0, 232.4, 1.06, 0, 1.06, 0],
    [PV, 21.7, 12.7, 40, 1.045, 0, 1.045, -4.98],
    [PV, 94.2, 19, 0, 1.01, 0, 1.01, -12.72],
    [PQ, 47.8, -3.9, 0, 1, 0, 1.019, -10.33],
    [PQ, 7.6, 1.6, 0, 1, 0, 1.02, -8.78],
    [PV, 11.2, 7.5, 0, 1.07, 0, 1.07, -14.22],
    [PQ, 0, 0, 0, 1, 0, 1.062, -13.37],
    [PV, 0, 0, 0, 1.09, 0, 1.09, -13.36],
    [PQ, 29.5, 16.6, 0, 1, 19, 1.056, -14.94],
    [PQ, 9, 5.8, 0, 1, 0, 1.051, -15.1],
    [PQ, 3.5, 1.8, 0, 1, 0, 1.057, -14.79],
    [PQ, 6.1, 1.6, 0, 1, 0, 1.055, -15.07],
    [PQ, 13.5, 5.8, 0, 1, 0, 1.05, -15.16],
    [PQ, 14.9, 5, 0, 1, 0, 1.036, -16.04]])
IEEE14 = _grid(14, BR14[:, 0].astype(int) - 1, BR14[:, 1].astype(int) - 1,
               BR14[:, 3], r=BR14[:, 2], b=BR14[:, 4], tap=BR14[:, 5],
               bus_type=BUS14[:, 0].astype(int), pd=BUS14[:, 1] / 100,
               qd=BUS14[:, 2] / 100, pg=BUS14[:, 3] / 100, vm0=BUS14[:, 4],
               bs=BUS14[:, 5] / 100)


@pytest.mark.parametrize("solve,tol", [(powerflow.newton, 1e-10),
                                       (powerflow.fdpf, 1e-10)])
def test_ieee14_matches_the_published_solution(solve, tol):
    Y = network.ybus(IEEE14)
    vm, va, it = solve(Y, network.sbus(IEEE14), IEEE14, tol, 50)
    assert it < 50
    assert np.abs(vm - BUS14[:, 6]).max() < 1.5e-3
    assert np.abs(np.degrees(va) - BUS14[:, 7]).max() < 0.03


def test_ieee14_ybus_row_sums():
    # with no shunts, taps or charging a row of Ybus sums to 0; here the
    # row sums are the shunt and charging admittances
    Y = network.ybus(IEEE14).toarray()
    assert np.allclose(Y, Y.T)  # real taps: complex symmetric
    assert abs(Y.sum(1)[13]) < 1e-12  # bus 14: two plain lines
    Y0 = network.ybus(dict(IEEE14, bs=np.zeros(14))).toarray()
    assert np.isclose((Y - Y0)[8, 8], 0.19j)
    assert np.isclose(Y[0, 1], -1 / (0.01938 + 0.05917j))


def test_lower_precision_misses_the_float64_floor():
    Y = network.ybus(IEEE14)
    sb = network.sbus(IEEE14)
    pvpq, pq, _ = network.index_sets(IEEE14)
    worst = {}
    for prec in ("float64", "float32", "bf16_product"):
        vm, va, _ = powerflow.newton(Y, sb, IEEE14, 1e-12, 20, prec)
        worst[prec] = powerflow.mismatch(Y, vm, va, sb, pvpq, pq)[0]
    assert worst["float64"] < 1e-12 < worst["float32"] < worst["bf16_product"]


def test_bf16_rounding():
    x = np.array([1.0, 1.0 + 2**-9, 1.0 + 3 * 2**-9, 3.0e5], np.float32)
    y = powerflow.to_bf16(x)
    assert y[0] == 1.0 and y[1] == 1.0  # tie to even
    assert y[2] == np.float32(1.0 + 2**-7)
    assert abs(y[3] - 3.0e5) / 3.0e5 < 2**-8


# a 5-bus ring 0-1-2-3-4-0 of equal lines, slack 0, loads 0.1-0.4: with a
# line out the ring is a chain, whose flows are the loads downstream
RING5 = _grid(5, [0, 1, 2, 3, 4], [1, 2, 3, 4, 0], [0.1] * 5,
              bus_type=[SLACK, PQ, PQ, PQ, PQ], pd=[0, 0.1, 0.2, 0.3, 0.4])


@pytest.mark.parametrize("k,want", [
    (4, [1.0, 0.9, 0.7, 0.4, 0.0]),
    (0, [0.0, -0.1, -0.3, -0.6, -1.0]),
    (2, [0.3, 0.2, 0.0, -0.3, -0.7])])
def test_dc_outage_flows_by_hand(k, want):
    assert np.allclose(contingency.dc_flows(RING5, k), want, atol=1e-12)
    assert not contingency.islands(RING5, k)


def test_islands_and_bridges():
    # the ring plus a pendant bus 5 on bus 2 (branch 5) and a doubled
    # branch 6 parallel to branch 0
    g = _grid(6, [0, 1, 2, 3, 4, 2, 0], [1, 2, 3, 4, 0, 5, 1], [0.1] * 7,
              bus_type=[SLACK] + [PQ] * 5, pd=[0, .1, .2, .3, .4, .1])
    br = contingency.bridges(g)
    assert br.tolist() == [False] * 5 + [True, False]
    assert [contingency.islands(g, k) for k in range(7)] == br.tolist()
    # either of the doubled pair out leaves the other the same flow
    a, b = contingency.dc_flows(g, 0), contingency.dc_flows(g, 6)
    assert np.isclose(a[6], b[0]) and a[0] == 0.0 and b[6] == 0.0


def test_b_series_is_a_laplacian():
    B = network.b_series(RING5).toarray()
    assert np.allclose(B.sum(1), 0)
    assert np.allclose(B, B.T)
    assert sp.issparse(network.b_series(RING5, drop=2))
