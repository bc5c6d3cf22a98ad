"""Parity of the port's linear sensitivity factors, short-circuit study and
MATPOWER reader with the JAX package's, on the same numpy inputs (JAX on
the CPU with x64).

Tolerances: PTDF, LODF, screened flows and Z columns within 1e-10 of
their largest magnitude; ``ok`` masks equal; the MATPOWER reader (a copy
of the JAX package's numpy) gives equal grids.  The JAX references are
computed once per module.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

from csparse3_tpu.models import contingency as jco
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import matpower as jmp
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu.models import sensitivity as jse
from csparse3_tpu.models import shortcircuit as jsc
import csparse3_tpu_torch as pt
from csparse3_tpu_torch.models import contingency as pco
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import matpower as pmp
from csparse3_tpu_torch.models import powerflow as ppf
from csparse3_tpu_torch.models import sensitivity as pse
from csparse3_tpu_torch.models import shortcircuit as psc
from csparse3_tpu_torch.utils.interop import grid_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-10


def both(jgrid):
    return jgrid, grid_from_arrays(**jgrid._asdict())


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_close(got, ref, rtol=RTOL):
    got, ref = np_(got), np_(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def g14():
    return both(jgrids.ieee14())


@pytest.fixture(scope="module")
def g200():
    return both(jgrids.synthetic_grid(200, seed=2))


@pytest.fixture(scope="module")
def ptdf_ref(g14, g200):
    return {"ieee14": jse.ptdf(g14[0]), "syn200": jse.ptdf(g200[0])}


@pytest.fixture(scope="module")
def linear14(g14):
    jg, pg = g14
    return (jse.LinearContingency(jg),
            pse.LinearContingency(pg, device="cpu"))


# ---------------------------------------------------------------------------
# PTDF / LODF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ieee14", "syn200"])
def test_ptdf_matches_jax(request, ptdf_ref, name):
    _, pg = request.getfixturevalue("g14" if name == "ieee14" else "g200")
    H = pse.ptdf(pg, device="cpu")
    assert H.dtype == torch.float64 and H.device.type == "cpu"
    assert_close(H, ptdf_ref[name])
    # slack columns are exactly 0
    assert not np_(H)[:, pg.slack].any()


def test_ptdf_subset_chunking_and_level_fallback(g200, ptdf_ref):
    jg, pg = g200
    br = np.array([5, 0, 77, 3, 150, 9])
    H = pse.ptdf(pg, branches=br, chunk=4, device="cpu")
    assert_close(H, ptdf_ref["syn200"][br])
    # 'amd' asks for the level-scheduled plan: the same factors
    H_amd = pse.ptdf(pg, branches=br, ordering="amd", chunk=5, device="cpu")
    assert_close(H_amd, jse.ptdf(jg, branches=br, ordering="amd", chunk=5))
    with pytest.raises(IndexError):
        pse.ptdf(pg, branches=[pg.n_branch], device="cpu")


def test_ptdf_warns_and_falls_back_when_no_pivot_factor_fails():
    """A negative series reactance (series compensation) breaks B'
    diagonal dominance: here the reduced B' is [[0, 1], [1, 0]], whose
    no-pivot factorization fails at its first pivot.  The banded fast path
    refuses, warned, and the pivoting level plan gives the JAX package's
    answer."""
    n = 3
    jg2, pg2 = both(jgrids.Grid(
        n_bus=n, f=np.array([0, 1, 0]), t=np.array([1, 2, 2]),
        r=np.zeros(3), x=np.array([1.0, -1.0, 1.0]), b=np.zeros(3),
        tap=np.ones(3),
        bus_type=np.array([jgrids.SLACK, jgrids.PQ, jgrids.PQ]),
        pd=np.array([0, 0.1, 0.2]), qd=np.zeros(n), pg=np.zeros(n),
        vm0=np.ones(n), gs=np.zeros(n), bs=np.zeros(n)))
    with pytest.warns(UserWarning, match="banded fast path"):
        H_j = jse.ptdf(jg2)
    with pytest.warns(UserWarning, match="banded fast path"):
        H = pse.ptdf(pg2, device="cpu")
    assert_close(H, H_j, 1e-8)


@pytest.mark.parametrize("name", ["ieee14", "syn200"])
def test_lodf_matches_jax(request, ptdf_ref, name):
    jg, pg = request.getfixturevalue("g14" if name == "ieee14" else "g200")
    L_j, ok_j = jse.lodf(jg, H=ptdf_ref[name])
    L, ok = pse.lodf(pg, H=torch.as_tensor(ptdf_ref[name]))
    np.testing.assert_array_equal(np_(ok), ok_j)
    assert_close(L, L_j)
    if name == "ieee14":
        assert not ok_j.all()          # the radial branch to bus 8
        k = int(np.flatnonzero(~ok_j)[0])
        assert not np_(L)[:, k].any()  # its column is zeroed


def test_lodf_computes_its_own_ptdf_and_checks_the_shape(g14, ptdf_ref):
    jg, pg = g14
    L, ok = pse.lodf(pg, device="cpu")
    assert_close(L, jse.lodf(jg, H=ptdf_ref["ieee14"])[0])
    with pytest.raises(ValueError):
        pse.lodf(pg, H=np.zeros((3, pg.n_bus)), device="cpu")


def test_linear_contingency_matches_jax(linear14):
    jlc, plc = linear14
    assert_close(plc.base_flows, jlc.base_flows)
    fl_j, ok_j = jlc.run()
    fl, ok = plc.run()
    np.testing.assert_array_equal(np_(ok), ok_j)
    assert_close(fl, fl_j)
    ks = np.array([3, 0, 9])
    fl, ok = plc.run(ks)
    assert_close(fl, jlc.run(ks)[0])
    fl, ok = plc.run(np.array([], dtype=int))
    assert fl.shape == (0, plc.n_branch) and ok.shape == (0,)
    with pytest.raises(IndexError):
        plc.run([plc.n_branch])


def test_linear_contingency_agrees_with_dc_contingency(g200):
    """LODF screening is exact for DC flows: the refactorization sweep's
    flows, on every outage that does not island."""
    _, pg = g200
    fl_l, ok_l = pse.LinearContingency(pg, device="cpu").run()
    fl_d, _, ok_d = pco.DCContingency(pg, device="cpu").run(batch=128)
    np.testing.assert_array_equal(np_(ok_l), np_(ok_d))
    sel = np_(ok_d)
    assert_close(np_(fl_l)[sel], np_(fl_d)[sel], 1e-8)


# ---------------------------------------------------------------------------
# short circuit
# ---------------------------------------------------------------------------

def test_short_circuit_all_buses_match_jax(g14):
    jg, pg = g14
    ref = jsc.short_circuit(jg)
    res = psc.short_circuit(pg, device="cpu")
    assert isinstance(res, psc.SCResult)
    np.testing.assert_array_equal(res.buses, ref.buses)
    np.testing.assert_array_equal(np_(res.ok), ref.ok)
    assert_close(res.ifault, ref.ifault)
    assert_close(res.vpost, ref.vpost)
    assert_close(res.iflow, ref.iflow)


def test_short_circuit_fault_impedance_and_vpre_match_jax(g14):
    jg, pg = g14
    rng = np.random.RandomState(0)
    vpre = 1.0 + 0.05 * rng.randn(14) + 1j * 0.02 * rng.randn(14)
    kw = dict(buses=np.array([2, 7, 13]), zf=0.01 + 0.05j, vpre=vpre)
    ref = jsc.short_circuit(jg, **kw)
    res = psc.short_circuit(pg, chunk=2, device="cpu", **kw)
    assert_close(res.ifault, ref.ifault)
    assert_close(res.vpost, ref.vpost)
    assert_close(res.iflow, ref.iflow)
    with pytest.raises(ValueError):
        psc.short_circuit(pg, vpre=np.ones(3), device="cpu")


def test_zbus_columns_match_jax_and_chunk(g200):
    jg, pg = g200
    Y = pgrids.ybus(pg)[0]
    buses = np.array([0, 199, 17, 54, 3])
    ref = jsc.zbus_columns(jgrids.ybus(jg)[0], buses)
    Z = psc.zbus_columns(Y, buses, chunk=2, device="cpu")
    assert Z.dtype == torch.complex128
    assert_close(Z, ref)
    with pytest.raises(IndexError):
        psc.zbus_columns(Y, np.array([pg.n_bus]), device="cpu")


def test_isolated_bus_flagged_as_the_jax_package_does():
    g = jgrids.Grid(
        n_bus=3, f=np.array([0]), t=np.array([1]), r=np.array([0.01]),
        x=np.array([0.1]), b=np.array([0.0]), tap=np.array([1.0]),
        bus_type=np.array([jgrids.SLACK, jgrids.PQ, jgrids.PQ]),
        pd=np.zeros(3), qd=np.zeros(3), pg=np.zeros(3), vm0=np.ones(3),
        gs=np.zeros(3), bs=np.zeros(3))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jsc.short_circuit(g)
        res = psc.short_circuit(grid_from_arrays(**g._asdict()),
                                device="cpu")
    np.testing.assert_array_equal(np_(res.ok), ref.ok)
    assert not np_(res.ok)[2] and np.isnan(np_(res.ifault)[2])
    assert np.isnan(np_(res.vpost)[2]).all()


# ---------------------------------------------------------------------------
# MATPOWER
# ---------------------------------------------------------------------------

CASE3 = """
function mpc = case3
% a 3-bus case: non-consecutive ids, a phase-shifting transformer,
% one out-of-service branch, one switched-off generator
mpc.version = '2';
mpc.baseMVA = 50;
mpc.bus = [
    10  3   0    0    0   0   1  1.00  0  345  1  1.1  0.9;
    20  2  25   10    0   5   1  1.02  0  345  1  1.1  0.9;
    35  1  60   20    2   0   1  0     0  345  1  1.1  0.9;
];
mpc.gen = [
    10  80  0  99 -99  1.05  50  1  200  0;
    20  40  0  99 -99  1.01  50  1  200  0;
    35  99  0  99 -99  1.50  50  0  200  0;  % off: must be ignored
];
mpc.branch = [
    10  20  0.01  0.06  0.10  0 0 0  0     0   1  -360 360;
    20  35  0.02  0.08  0.04  0 0 0  1.05  10  1  -360 360;
    10  35  0.01  0.05  0.00  0 0 0  0     0   0  -360 360;  % out of service
];
"""

# IEEE 14-bus in MATPOWER syntax (case14 data, 100 MVA base)
CASE14 = """
mpc.baseMVA = 100;
mpc.bus = [
 1 3 0 0 0 0 1 1.06 0 0 1 1.06 0.94;
 2 2 21.7 12.7 0 0 1 1.045 -4.98 0 1 1.06 0.94;
 3 2 94.2 19 0 0 1 1.01 -12.72 0 1 1.06 0.94;
 4 1 47.8 -3.9 0 0 1 1.019 -10.33 0 1 1.06 0.94;
 5 1 7.6 1.6 0 0 1 1.02 -8.78 0 1 1.06 0.94;
 6 2 11.2 7.5 0 0 1 1.07 -14.22 0 1 1.06 0.94;
 7 1 0 0 0 0 1 1.062 -13.37 0 1 1.06 0.94;
 8 2 0 0 0 0 1 1.09 -13.36 0 1 1.06 0.94;
 9 1 29.5 16.6 0 19 1 1.056 -14.94 0 1 1.06 0.94;
 10 1 9 5.8 0 0 1 1.051 -15.1 0 1 1.06 0.94;
 11 1 3.5 1.8 0 0 1 1.057 -14.79 0 1 1.06 0.94;
 12 1 6.1 1.6 0 0 1 1.055 -15.07 0 1 1.06 0.94;
 13 1 13.5 5.8 0 0 1 1.05 -15.16 0 1 1.06 0.94;
 14 1 14.9 5 0 0 1 1.036 -16.04 0 1 1.06 0.94;
];
mpc.gen = [
 1 232.4 -16.9 10 0 1.06 100 1 332.4 0;
 2 40 42.4 50 -40 1.045 100 1 140 0;
 3 0 23.4 40 0 1.01 100 1 100 0;
 6 0 12.2 24 -6 1.07 100 1 100 0;
 8 0 17.4 24 -6 1.09 100 1 100 0;
];
mpc.branch = [
 1 2 0.01938 0.05917 0.0528 0 0 0 0 0 1 -360 360;
 1 5 0.05403 0.22304 0.0492 0 0 0 0 0 1 -360 360;
 2 3 0.04699 0.19797 0.0438 0 0 0 0 0 1 -360 360;
 2 4 0.05811 0.17632 0.034 0 0 0 0 0 1 -360 360;
 2 5 0.05695 0.17388 0.0346 0 0 0 0 0 1 -360 360;
 3 4 0.06701 0.17103 0.0128 0 0 0 0 0 1 -360 360;
 4 5 0.01335 0.04211 0 0 0 0 0 0 1 -360 360;
 4 7 0 0.20912 0 0 0 0 0.978 0 1 -360 360;
 4 9 0 0.55618 0 0 0 0 0.969 0 1 -360 360;
 5 6 0 0.25202 0 0 0 0 0.932 0 1 -360 360;
 6 11 0.09498 0.1989 0 0 0 0 0 0 1 -360 360;
 6 12 0.12291 0.25581 0 0 0 0 0 0 1 -360 360;
 6 13 0.06615 0.13027 0 0 0 0 0 0 1 -360 360;
 7 8 0 0.17615 0 0 0 0 0 0 1 -360 360;
 7 9 0 0.11001 0 0 0 0 0 0 1 -360 360;
 9 10 0.03181 0.0845 0 0 0 0 0 0 1 -360 360;
 9 14 0.12711 0.27038 0 0 0 0 0 0 1 -360 360;
 10 11 0.08205 0.19207 0 0 0 0 0 0 1 -360 360;
 12 13 0.22092 0.19988 0 0 0 0 0 0 1 -360 360;
 13 14 0.17093 0.34802 0 0 0 0 0 0 1 -360 360;
];
"""


@pytest.mark.parametrize("text", [CASE3, CASE14], ids=["case3", "case14"])
def test_parse_case_matches_jax(text):
    gj, gp = jmp.parse_case(text), pmp.parse_case(text)
    assert isinstance(gp, pgrids.Grid) and gp.n_bus == gj.n_bus
    for name, a in gj._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(gp, name)),
                                      np.asarray(a), err_msg=name)


def test_load_case_reads_a_file(tmp_path):
    p = tmp_path / "case3.m"
    p.write_text(CASE3)
    g = pt.load_case(p)
    assert g.n_bus == 3 and g.n_branch == 2


def test_parsed_case_runs_through_newton_as_in_the_jax_package():
    vm_j, va_j, it_j, _ = jpf.newton_raphson(jmp.parse_case(CASE14))
    g = pmp.parse_case(CASE14)
    vm, va, it, res = ppf.NewtonPowerFlow(g, device="cpu").solve()
    assert res < 1e-10 and it == it_j
    np.testing.assert_allclose(vm, vm_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(va, va_j, rtol=0, atol=1e-9)


@pytest.mark.parametrize("text,match", [
    ("mpc.baseMVA = 100;\n", "no mpc.bus"),
    ("mpc.bus = [1 3 0 0 0 0 1 1 0;\n 2 1 0 0;];\nmpc.branch = [1 2 0 0.1 "
     "0;];", "ragged rows"),
])
def test_parse_case_refuses_what_the_jax_package_refuses(text, match):
    with pytest.raises(ValueError, match=match):
        jmp.parse_case(text)
    with pytest.raises(ValueError, match=match):
        pmp.parse_case(text)


def test_dc_contingency_of_a_parsed_case_matches_jax():
    fl_j, _, ok_j = jco.DCContingency(jmp.parse_case(CASE14)).run()
    fl, _, ok = pco.DCContingency(pmp.parse_case(CASE14), device="cpu").run()
    np.testing.assert_array_equal(np_(ok), ok_j)
    assert_close(np_(fl)[ok_j], fl_j[ok_j])
