"""Parity of the port's batched study path with the JAX package's: the
power-flow ``solve_batch`` (Newton 'level' / 'multifrontal' / 'blocklu',
fast-decoupled), the per-scenario Ybus value override, and the DC and AC
N-1 contingencies, on the same numpy inputs (JAX on the CPU with x64).

The JAX package runs a batch as ``jax.vmap`` of one scenario; the port
runs the scenarios as the leading axis of every op.  Tolerances: flows and
angles within 1e-10 of their scale, Newton and fast-decoupled states
within 1e-8 with equal per-scenario iteration counts, ``ok`` masks equal
(the noisy-pivot chain and the islanding AC outage included).  A batched
refactorization must equal K single ones: that is what catches an
in-place front update lost to a silent copy.  The JAX references are
computed once per module.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

from csparse3_tpu.models import contingency as jco
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu_torch.kernels.bandpoints import SplitBandPoints
from csparse3_tpu_torch.linalg import BandedLU, MultifrontalLU, splu
from csparse3_tpu_torch.linalg.multifrontal import MultifrontalRefactor
from csparse3_tpu_torch.models import contingency as pco
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import powerflow as ppf
from csparse3_tpu_torch.ops.matvec import SplitDIA, SplitSymDIA
from csparse3_tpu_torch.utils.interop import grid_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

FLOW_RTOL = 1e-10    # flows and angles, of their largest magnitude
STATE_ATOL = 1e-8    # Newton and fast-decoupled states
K = 4


def both(jgrid):
    """The same grid for both packages, through numpy."""
    return jgrid, grid_from_arrays(**jgrid._asdict())


def chain5():
    """The 5-bus chain of the JAX package's tests: every outage islands
    buses from the slack, and the frozen pivots come out as round-off
    noise, not zeros."""
    n = 5
    return jgrids.Grid(
        n_bus=n, f=np.array([0, 1, 2, 3]), t=np.array([1, 2, 3, 4]),
        r=np.zeros(4), x=np.array([0.13, 0.071, 0.093, 0.17]),
        b=np.zeros(4), tap=np.ones(4),
        bus_type=np.array([jgrids.SLACK, jgrids.PQ, jgrids.PQ, jgrids.PQ,
                           jgrids.PQ]),
        pd=np.array([0, 0.1, 0.1, 0.1, 0.1]), qd=np.zeros(n),
        pg=np.zeros(n), vm0=np.ones(n), gs=np.zeros(n), bs=np.zeros(n))


def load_scenarios(grid, k=K, seed=0):
    """(k, n) complex injections: the base case scaled per scenario."""
    scale = 1 + 0.05 * np.random.RandomState(seed).randn(k)
    return jpf.sbus(grid)[None, :] * scale[:, None]


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_close(got, ref, rtol=FLOW_RTOL):
    got, ref = np_(got), np_(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# module-scoped JAX references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def g14():
    return both(jgrids.ieee14())


@pytest.fixture(scope="module")
def g14_rcm():
    return both(jgrids.rcm_grid(jgrids.ieee14())[0])


@pytest.fixture(scope="module")
def g300():
    return both(jgrids.synthetic_grid(300, seed=4))


@pytest.fixture(scope="module")
def dc14(g14):
    jg, pg = g14
    return jco.DCContingency(jg).run(), pco.DCContingency(pg, device="cpu")


@pytest.fixture(scope="module")
def ac14(g14):
    jg, pg = g14
    return jco.ACContingency(jg).run(), pco.ACContingency(pg, device="cpu")


# ---------------------------------------------------------------------------
# solve_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["level", "multifrontal"])
def test_newton_solve_batch_matches_jax(g14, solver):
    jg, pg = g14
    sb = load_scenarios(jg)
    vm_j, va_j, it_j, res_j = jpf.NewtonPowerFlow(
        jg, solver=solver).solve_batch(sb)
    vm, va, it, res = ppf.NewtonPowerFlow(
        pg, solver=solver, device="cpu").solve_batch(sb)
    np.testing.assert_array_equal(np_(it), np_(it_j))
    assert_close(vm, vm_j, STATE_ATOL)
    np.testing.assert_allclose(np_(va), np_(va_j), rtol=0, atol=STATE_ATOL)
    assert np_(res).max() <= 1e-10


def test_newton_blocklu_solve_batch_matches_jax(g14_rcm):
    jg, pg = g14_rcm
    sb = load_scenarios(jg, seed=1)
    vm_j, va_j, it_j, _ = jpf.NewtonPowerFlow(
        jg, spmv="dia", solver="blocklu").solve_batch(sb)
    vm, va, it, res = ppf.NewtonPowerFlow(
        pg, spmv="dia", solver="blocklu", device="cpu").solve_batch(sb)
    np.testing.assert_array_equal(np_(it), np_(it_j))
    np.testing.assert_allclose(np_(vm), np_(vm_j), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(np_(va), np_(va_j), rtol=0, atol=STATE_ATOL)


@pytest.mark.parametrize("spmv,solver", [("symdia", "level"),
                                         ("dia", "blocklu")])
def test_fast_decoupled_solve_batch_matches_jax(g14_rcm, spmv, solver):
    jg, pg = g14_rcm
    sb = load_scenarios(jg, seed=2)
    vm_j, va_j, it_j = jpf.FastDecoupled(jg, spmv=spmv,
                                         solver=solver).solve_batch(sb)
    vm, va, it = ppf.FastDecoupled(pg, spmv=spmv, solver=solver,
                                   device="cpu").solve_batch(sb)
    np.testing.assert_array_equal(np_(it), np_(it_j))
    np.testing.assert_allclose(np_(vm), np_(vm_j), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(np_(va), np_(va_j), rtol=0, atol=STATE_ATOL)


def test_solve_batch_rows_equal_single_runs(g300):
    """Every scenario of a batch stops where its own solve stops: unequal
    iteration counts across the batch (one scenario needs more), the
    others frozen meanwhile."""
    _, pg = g300
    sb = load_scenarios(pg, k=3, seed=3)
    sb[1] *= 12.0                      # a heavier case: more iterations
    pf = ppf.NewtonPowerFlow(pg, device="cpu")
    vm, va, it, res = pf.solve_batch(sb)
    assert len(set(np_(it).tolist())) > 1
    for k in range(3):
        vm1, va1, it1, r1, bad = pf.run(
            torch.as_tensor(pg.vm0.astype(float)),
            torch.zeros(pg.n_bus, dtype=torch.float64),
            torch.as_tensor(sb[k].real.copy()),
            torch.as_tensor(sb[k].imag.copy()))
        assert it1 == int(it[k]) and not bad
        np.testing.assert_allclose(np_(vm[k]), np_(vm1), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np_(va[k]), np_(va1), rtol=0, atol=1e-12)


def test_gated_scenario_falls_back_to_the_host_alone(g14):
    """A scenario that trips the growth gate finishes on the host (warned)
    and its neighbours keep their device results."""
    _, pg = g14
    sb = load_scenarios(pg, k=2)
    pf = ppf.NewtonPowerFlow(pg, solver="multifrontal", device="cpu")
    ref = pf.solve_batch(sb)
    pf.growth_limit = 0.0               # every factorization trips it
    with pytest.warns(RuntimeWarning, match="pivot-growth gate"):
        vm, va, it, res = pf.solve_batch(sb)
    assert np_(res).max() < 1e-10
    np.testing.assert_allclose(np_(vm), np_(ref[0]), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# the Ybus value override
# ---------------------------------------------------------------------------

def test_value_override_matches_jax_run(g14):
    """``run`` with per-scenario Ybus values (one outage's), against the
    JAX package's ``run`` with the same override."""
    jg, pg = g14
    pf_j = jpf.NewtonPowerFlow(jg)
    pf = ppf.NewtonPowerFlow(pg, device="cpu")
    ac = pco.ACContingency(pg, device="cpu")
    k = torch.tensor([5])
    ygr = pco._outage_values(pf._ygr, ac._pos, ac._dre, k)[0]
    ygi = pco._outage_values(pf._ygi, ac._pos, ac._dim, k)[0]
    vm0 = pg.vm0.astype(np.float64)
    out_j = pf_j.run(vm0, np.zeros(pg.n_bus), pf_j._sbr, pf_j._sbi,
                     np_(ygr), np_(ygi))
    vm, va, it, res, bad = pf.run(torch.as_tensor(vm0),
                                  torch.zeros(pg.n_bus, dtype=torch.float64),
                                  ygr=ygr, ygi=ygi)
    assert it == int(out_j[2]) and not bad and res < 1e-8
    np.testing.assert_allclose(np_(vm), np_(out_j[0]), rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(np_(va), np_(out_j[1]), rtol=0,
                               atol=STATE_ATOL)


def test_override_with_base_values_is_the_spmv_mismatch(g300):
    """I = Y v from the raw entry streams equals the SpMV plan's when the
    override holds Ybus's own values, for one vector and for a batch."""
    _, pg = g300
    pf = ppf.NewtonPowerFlow(pg, device="cpu")
    rng = np.random.RandomState(5)
    vm = torch.as_tensor(1 + 0.01 * rng.randn(3, pg.n_bus))
    va = torch.as_tensor(0.05 * rng.randn(3, pg.n_bus))
    for v, a in ((vm, va), (vm[0], va[0])):
        f0 = pf._mismatch_f(v, a, pf._sbr, pf._sbi)[0]
        f1 = pf._mismatch_f(v, a, pf._sbr, pf._sbi, pf._ygr, pf._ygi)[0]
        np.testing.assert_allclose(np_(f1), np_(f0), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# DC contingency
# ---------------------------------------------------------------------------

def test_dc_contingency_all_outages_match_jax(dc14):
    (fl_j, th_j, ok_j), dc = dc14
    fl, th, ok = dc.run()
    np.testing.assert_array_equal(np_(ok), ok_j)
    assert not ok_j.all()            # the radial branch to bus 8 islands
    assert_close(fl[ok], fl_j[ok_j])
    assert_close(th[ok], th_j[ok_j])


def test_dc_contingency_batching_and_multifrontal_plan(g300):
    jg, pg = g300
    ks = np.random.RandomState(0).choice(pg.n_branch, 12, replace=False)
    dc = pco.DCContingency(pg, device="cpu")
    assert isinstance(dc._rp, MultifrontalRefactor)
    f1, t1, ok1 = dc.run(ks)
    f2, t2, ok2 = dc.run(ks, batch=5)        # uneven chunks, same result
    np.testing.assert_array_equal(np_(ok1), np_(ok2))
    np.testing.assert_allclose(np_(f2), np_(f1), rtol=1e-12, atol=0)
    fl_j, th_j, ok_j = jco.DCContingency(jg).run(ks)
    np.testing.assert_array_equal(np_(ok1), ok_j)
    assert_close(f1, fl_j)
    assert_close(t1, th_j)


def test_dc_contingency_level_fallback_matches_jax(g14):
    """ordering='natural' skips the multifrontal plan: RefactorPlan."""
    jg, pg = g14
    dc = pco.DCContingency(pg, ordering="natural", device="cpu")
    assert not isinstance(dc._rp, MultifrontalRefactor)
    fl_j, th_j, ok_j = jco.DCContingency(jg, ordering="natural").run()
    fl, th, ok = dc.run(batch=7)
    np.testing.assert_array_equal(np_(ok), ok_j)
    assert_close(fl[ok], fl_j[ok_j])


def test_dc_contingency_noisy_pivot_chain_flags_every_outage():
    jg, pg = both(chain5())
    _, _, ok_j = jco.DCContingency(jg).run()
    fl, th, ok = pco.DCContingency(pg, device="cpu").run()
    assert not ok_j.any()
    np.testing.assert_array_equal(np_(ok), ok_j)


def test_dc_base_theta_matches_jax_and_dc_power_flow(g14, dc14):
    jg, pg = g14
    th = dc14[1].base_theta()
    th_j = jco.DCContingency(jg).base_theta()
    assert_close(th, th_j)
    np.testing.assert_allclose(np_(th), ppf.dc_power_flow(pg, device="cpu"),
                               rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# AC contingency
# ---------------------------------------------------------------------------

def test_ac_contingency_all_outages_match_jax(ac14):
    (vm_j, va_j, it_j, ok_j), ac = ac14
    vm, va, it, ok = ac.run(batch=6)
    np.testing.assert_array_equal(np_(ok), ok_j)
    assert not ok_j.all()            # the islanding branch to bus 8
    sel = np_(ok)
    np.testing.assert_array_equal(np_(it)[sel], it_j[sel])
    np.testing.assert_allclose(np_(vm)[sel], vm_j[sel], rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(np_(va)[sel], va_j[sel], rtol=0,
                               atol=STATE_ATOL)


def test_ac_contingency_multifrontal_matches_level(g14, ac14):
    _, pg = g14
    ks = np.arange(10)
    vm, va, it, ok = ac14[1].run(ks)
    vm2, va2, it2, ok2 = pco.ACContingency(
        pg, solver="multifrontal", device="cpu").run(ks, batch=4)
    np.testing.assert_array_equal(np_(ok2), np_(ok))
    sel = np_(ok)
    np.testing.assert_array_equal(np_(it2)[sel], np_(it)[sel])
    np.testing.assert_allclose(np_(vm2)[sel], np_(vm)[sel], rtol=0,
                               atol=STATE_ATOL)


# ---------------------------------------------------------------------------
# outage lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [[14 + 6], [-1], [0, 25]])
def test_check_outages_refuses_ids_out_of_range(bad):
    with pytest.raises(IndexError, match="out of range"):
        pco._check_outages(np.asarray(bad), 20)
    np.testing.assert_array_equal(pco._check_outages([3, 0], 20), [3, 0])


def test_empty_outage_lists(dc14, ac14):
    dc, ac = dc14[1], ac14[1]
    fl, th, ok = dc.run(np.array([], dtype=int))
    assert fl.shape == (0, dc.n_branch) and th.shape == (0, 14)
    assert ok.shape == (0,) and ok.dtype == torch.bool
    vm, va, it, ok = ac.run(np.array([], dtype=int))
    assert vm.shape == (0, 14) and it.shape == (0,) and ok.shape == (0,)
    with pytest.raises(IndexError):
        dc.run(np.array([dc.n_branch]))
    with pytest.raises(IndexError):
        ac.run(np.array([-1]))


# ---------------------------------------------------------------------------
# batched refactorizations against K single ones
# ---------------------------------------------------------------------------

def _jacobian_values(grid, k, seed):
    Y, _, _ = pgrids.ybus(grid)
    v0 = grid.vm0.astype(complex)
    J = ppf._jacobian(Y, v0, Y.to_scipy() @ v0,
                      np.concatenate([grid.pv, grid.pq]), grid.pq)
    vals = J.np_arrays()[2]
    rng = np.random.RandomState(seed)
    return J, torch.as_tensor(vals[None, :] * (1 + 0.01 * rng.randn(
        k, len(vals)))), torch.as_tensor(rng.randn(k, J.n))


@pytest.mark.parametrize("kind", ["multifrontal", "level", "supernodal"])
def test_batched_refactor_equals_single_calls(g300, kind):
    _, pg = g300
    J, vals, b = _jacobian_values(pg, K, 7)
    if kind == "level":
        rp = splu(J).refactor_plan(J, device="cpu")
    else:
        lu0 = splu(J, ordering="nd", tol=0.0)
        if kind == "multifrontal":
            rp = MultifrontalRefactor(lu0._h, J, device="cpu")
        else:
            from csparse3_tpu_torch.linalg.supernodal import \
                SupernodalRefactor
            rp = SupernodalRefactor(lu0._h, J, relax=8, device="cpu")
    if kind != "supernodal":
        Lb, Ub = rp.factor_values(vals)
        for k in range(K):
            L1, U1 = rp.factor_values(vals[k])
            assert torch.equal(Lb[k], L1) and torch.equal(Ub[k], U1)
        plan, diag = rp.refactor(vals, with_diag=True)
        assert plan.batched and diag.shape == (K, J.n)
        x = plan(b)
        for k in range(K):
            np.testing.assert_allclose(np_(x[k]),
                                       np_(rp.refactor(vals[k])(b[k])),
                                       rtol=0, atol=1e-12)
    else:
        # SupernodalRefactor keeps one scenario per call; its dense LU
        # helper is shared with the batched fronts and keeps its results
        L1, U1 = rp.factor_values(vals[0])
        Lm, Um = MultifrontalRefactor(splu(J, ordering="nd", tol=0.0)._h, J,
                                      device="cpu").factor_values(vals[0])
        np.testing.assert_allclose(np_(L1), np_(Lm), rtol=0, atol=1e-12)


def test_batched_front_lu_equals_single_calls(g300):
    _, pg = g300
    J, vals, b = _jacobian_values(pg, K, 8)
    mf = MultifrontalLU.from_matrix(J, device="cpu")
    fac, stats = mf.factor_piv(vals)
    assert stats["min_pivot"].shape == (K,)
    x = mf.solve_piv(fac, b)
    for k in range(K):
        f1, s1 = mf.factor_piv(vals[k])
        for a, c in zip(fac, f1):
            for t, u in zip(a, c):
                np.testing.assert_allclose(np_(t[k]), np_(u), rtol=0,
                                           atol=1e-12 * max(
                                               np_(u).__abs__().max(), 1))
        assert float(s1["max_u"]) == float(stats["max_u"][k])
        np.testing.assert_allclose(np_(x[k]), np_(mf.solve_piv(f1, b[k])),
                                   rtol=0, atol=1e-12)


def test_batched_banded_refactor_equals_single_calls(g300):
    _, pg = g300
    gr = pgrids.rcm_grid(pg)[0]
    J, vals, b = _jacobian_values(gr, K, 9)
    rf = BandedLU(J, device="cpu").refactor_plan(J)
    lu = rf(vals)
    assert lu.batched and lu.stacks()[1].shape[1] == K
    x = lu(b)
    for k in range(K):
        one = rf(vals[k])
        np.testing.assert_allclose(np_(lu.stacks()[1][:, k]),
                                   np_(one.stacks()[1]), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np_(x[k]), np_(one(b[k])), rtol=0,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the Ybus SpMV plans on a batch (their plain versions, here on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["bandpoints", "dia", "symdia", "ell"])
def test_split_spmv_batch_rows_equal_single_products(g300, plan):
    _, pg = g300
    g = pgrids.rcm_grid(pg)[0] if plan in ("dia", "symdia") else pg
    Y, _, _ = pgrids.ybus(g)
    p = ppf._make_yplan(Y, plan, "cpu")
    rng = np.random.RandomState(11)
    xr, xi = (torch.as_tensor(rng.randn(3, g.n_bus)) for _ in range(2))
    yr, yi = p(xr, xi)
    assert yr.shape == (3, g.n_bus)
    for k in range(3):
        r1, i1 = p(xr[k], xi[k])
        if plan == "ell":
            # the multi-RHS ELL product sums slot by slot, one vector's
            # row by row: the same terms in another order
            np.testing.assert_allclose(np_(yr[k]), np_(r1), rtol=1e-13,
                                       atol=1e-13)
            np.testing.assert_allclose(np_(yi[k]), np_(i1), rtol=1e-13,
                                       atol=1e-13)
        else:
            assert torch.equal(yr[k], r1) and torch.equal(yi[k], i1)
    if plan == "bandpoints":
        assert isinstance(p, SplitBandPoints) and p.kernel_launches == 0
    if plan in ("dia", "symdia"):
        assert isinstance(p, (SplitDIA, SplitSymDIA)) and p.shared_runs
