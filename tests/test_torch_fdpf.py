"""The banded power-flow path as a whole: ``rcm_grid``, ``dc_power_flow``,
``FastDecoupled`` and ``NewtonPowerFlow(spmv='dia' | 'symdia')`` of the
port against the JAX package on the same grids, plus the default-device
rule and the triad's plain version.

Both packages run float64 on the CPU: iteration counts must be equal and
the states agree to 1e-8 (the fast-decoupled iteration stops at tol=1e-8,
so two runs that differ in summation order differ by less than that; the
Newton states agree to 1e-10).
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu_torch as pt
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu_torch import config
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import powerflow as ppf
from csparse3_tpu_torch.utils import roofline

STATE_ATOL = 1e-8


def _grids(name):
    if name == "ieee14":
        return pgrids.ieee14(), jgrids.ieee14()
    return (pgrids.rcm_grid(pgrids.synthetic_grid(200, seed=7))[0],
            jgrids.rcm_grid(jgrids.synthetic_grid(200, seed=7))[0])


def test_rcm_grid_and_reorder_grid_match_jax():
    gp0, gj0 = pgrids.synthetic_grid(200, seed=7), jgrids.synthetic_grid(
        200, seed=7)
    (gp, pp), (gj, pj) = pgrids.rcm_grid(gp0), jgrids.rcm_grid(gj0)
    np.testing.assert_array_equal(pp, pj)
    assert sorted(pp) == list(range(200))
    for a, b in zip(gp, gj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the reordered Ybus is the permuted Ybus, and it is banded
    Y0, Y1 = pgrids.ybus(gp0)[0], pgrids.ybus(gp)[0]
    np.testing.assert_allclose(Y1.to_scipy().toarray(),
                               Y0.to_scipy().toarray()[np.ix_(pp, pp)],
                               rtol=1e-13, atol=1e-13)
    band = lambda Y: np.abs(np.subtract(*Y.to_scipy().nonzero())).max()
    assert band(Y1) < band(Y0)
    perm = np.random.default_rng(0).permutation(200)
    for a, b in zip(pgrids.reorder_grid(gp0, perm),
                    jgrids.reorder_grid(gj0, perm)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["ieee14", "rcm200"])
def test_dc_power_flow_matches_jax_and_scipy(name):
    gp, gj = _grids(name)
    th_p = ppf.dc_power_flow(gp, device="cpu")
    th_j = jpf.dc_power_flow(gj)
    np.testing.assert_allclose(th_p, th_j, rtol=0, atol=1e-12)
    keep = np.flatnonzero(gp.bus_type != pgrids.SLACK)
    B = ppf._b_series(gp)[keep, keep].to_scipy()
    ref = spla.spsolve(B.tocsc(), (gp.pg - gp.pd)[keep])
    np.testing.assert_allclose(th_p[keep], ref, rtol=1e-9, atol=1e-12)
    assert th_p[gp.slack] == 0


@pytest.mark.parametrize("spmv", ["ell", "dia", "symdia"])
@pytest.mark.parametrize("name", ["ieee14", "rcm200"])
def test_fast_decoupled_matches_jax(name, spmv):
    gp, gj = _grids(name)
    fp = ppf.FastDecoupled(gp, spmv=spmv, device="cpu")
    vm_p, va_p, it_p, res_p = fp.solve()
    vm_j, va_j, it_j, res_j = jpf.FastDecoupled(gj, spmv=spmv).solve()
    assert it_p == it_j and 0 < it_p < fp.max_iter
    assert res_p <= 1e-8 and res_j <= 1e-8
    np.testing.assert_allclose(vm_p, vm_j, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(va_p, va_j, rtol=0, atol=STATE_ATOL)
    # the answer is the Newton answer
    vm_n, va_n, _, _ = ppf.NewtonPowerFlow(gp, device="cpu").solve()
    np.testing.assert_allclose(vm_p, vm_n, rtol=0, atol=1e-7)
    np.testing.assert_allclose(va_p, va_n, rtol=0, atol=1e-7)


@pytest.mark.parametrize("spmv", ["dia", "symdia"])
@pytest.mark.parametrize("name", ["ieee14", "rcm200"])
def test_newton_banded_spmv_matches_jax(name, spmv):
    gp, gj = _grids(name)
    vm_p, va_p, it_p, res_p = ppf.NewtonPowerFlow(
        gp, spmv=spmv, device="cpu").solve()
    vm_j, va_j, it_j, res_j = jpf.NewtonPowerFlow(gj, spmv=spmv).solve()
    assert it_p == it_j and res_p < 1e-10
    np.testing.assert_allclose(vm_p, vm_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(va_p, va_j, rtol=0, atol=1e-10)


def test_fast_decoupled_step_and_residual_match_jax():
    gp, gj = _grids("rcm200")
    fp = ppf.FastDecoupled(gp, spmv="dia", device="cpu")
    fj = jpf.FastDecoupled(gj, spmv="dia")
    vm0 = torch.as_tensor(gp.vm0.astype(np.float64))
    va0 = torch.zeros(200, dtype=torch.float64)
    carry = (vm0, va0, fp._sbr, fp._sbi)
    new = fp.step(carry)
    assert torch.equal(carry[0], vm0) and not torch.equal(new[1], va0)
    vm_j, va_j, _, _ = fj.step((fj._vm0, jnp.zeros(200), fj._sbr, fj._sbi))
    np.testing.assert_allclose(new[0].numpy(), np.asarray(vm_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(new[1].numpy(), np.asarray(va_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(float(fp.residual(new[0], new[1])),
                               float(fj.residual(vm_j, va_j)), rtol=1e-9)
    for a, b in zip(fp.mismatch(vm0, va0), fj.mismatch(fj._vm0, jnp.zeros(200))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_fast_decoupled_stops_at_max_iter():
    gp, _ = _grids("rcm200")
    vm, va, it, res = ppf.FastDecoupled(gp, max_iter=2, device="cpu").solve()
    assert it == 2 and res > 1e-8


def test_symdia_refuses_a_phase_shifted_ybus():
    g = pgrids.ieee14()
    Y = pgrids.ybus(g)[0]
    ip, ix, dt = Y.np_arrays()
    cols = np.repeat(np.arange(Y.n), np.diff(ip))
    dt = dt.copy()
    dt[np.flatnonzero(ix > cols)[0]] *= np.exp(0.1j)
    bent = pt.CSC(Y.m, Y.n, ip, ix, dt)
    with pytest.raises(ValueError, match="not symmetric"):
        ppf._make_yplan(bent, "symdia", "cpu")
    ppf._make_yplan(bent, "dia", "cpu")
    with pytest.raises(ValueError, match="unknown spmv"):
        ppf._make_yplan(Y, "csr", "cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        ppf.FastDecoupled(g, solver="qr", device="cpu")


# -- the default device ------------------------------------------------------

def test_default_device_raises_without_a_card_and_names_the_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.resolve_device(None)
    assert config.resolve_device("cpu") == torch.device("cpu")
    assert pt.default_device is config.default_device


ENTRY_POINTS = {
    "NewtonPowerFlow": lambda g, Y: ppf.NewtonPowerFlow(g),
    "FastDecoupled": lambda g, Y: ppf.FastDecoupled(g),
    "dc_power_flow": lambda g, Y: ppf.dc_power_flow(g),
    "newton_raphson": lambda g, Y: ppf.newton_raphson(g),
    "SpMVPlan": lambda g, Y: pt.SpMVPlan(Y),
    "SplitSpMV": lambda g, Y: pt.SplitSpMV(Y),
    "SplitBandPoints": lambda g, Y: pt.SplitBandPoints(Y),
    "SplitDIA": lambda g, Y: pt.SplitDIA(Y),
    "SplitSymDIA": lambda g, Y: pt.SplitSymDIA(Y, tol=1e-12),
    "SplitCudaDIA": lambda g, Y: pt.SplitCudaDIA(Y),
    "solve_plan": lambda g, Y: pt.splu(Y).solve_plan(),
    "refactor_plan": lambda g, Y: pt.splu(Y).refactor_plan(Y),
    "solve_numpy_rhs": lambda g, Y: pt.splu(Y).solve(np.ones(Y.n)),
    "TriSolvePlan": lambda g, Y: pt.TriSolvePlan(
        Y.n, *pt.splu(Y).L.np_arrays(), lower=True),
    "container_tensor": lambda g, Y: Y.data,
    "measure_hbm_bw": lambda g, Y: roofline.measure_hbm_bw(mb=1),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """device=None is the CUDA card: without one every entry point raises
    the error of ``default_device`` instead of running on the CPU."""
    g = pgrids.ieee14()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](g, pgrids.ybus(g)[0])


def test_plans_follow_an_explicitly_placed_matrix():
    Y = pgrids.ybus(pgrids.ieee14())[0].to("cpu")
    assert pt.SplitDIA(Y).re.slabs.device.type == "cpu"
    assert pt.SpMVPlan(Y).vals.device.type == "cpu"
    assert pt.SplitDIA(Y, device="meta").re.slabs.device.type == "meta"


# -- the triad's plain version -------------------------------------------------

def test_triad_plain_matches_numpy():
    rng = np.random.RandomState(0)
    a = rng.rand(1000, 512).astype(np.float32)
    s = np.float32(1.0000001)
    ref = a * s + np.float32(0.5)  # two float32 roundings, as the kernel
    s_t = torch.full((1,), float(s), dtype=torch.float32)
    np.testing.assert_array_equal(
        roofline.triad_plain(torch.as_tensor(a), s_t).numpy(), ref)
    # the dispatching wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        roofline.triad(torch.as_tensor(a), s_t).numpy(), ref)
    assert roofline.LAUNCHES["triad"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        roofline.triad_cuda(torch.as_tensor(a), s_t)
    with pytest.raises(ValueError, match="CUDA device"):
        roofline.measure_hbm_bw(mb=1, device="cpu")


def test_plan_bytes_and_pct_roofline():
    Y = pgrids.ybus(pgrids.rcm_grid(pgrids.synthetic_grid(200, seed=7))[0])[0]
    plan = pt.SplitDIA(Y, device="cpu")
    x = torch.zeros(200, dtype=torch.float64)
    # a call reads the shared occupancy index once and each slab set's
    # packed run values, not the (D, 200) slabs
    assert plan.shared_runs
    read = sum(t.numel() * 4 for t in plan.re.runs) + sum(
        t.numel() * 8 for p in (plan.re, plan.im) for t in p.run_values)
    assert read < plan.re.ndiag * 200 * 8
    assert roofline.plan_bytes(plan) == read
    assert roofline.plan_bytes(plan, x, x) == read + 2 * 200 * 8
    # a dense band keeps no index: all of its slabs
    tri = pt.DIAPlan(pt.from_triplets(
        np.r_[0:50, 1:50], np.r_[0:50, 0:49], np.ones(99), (50, 50)),
        device="cpu")
    assert not tri.has_runs and roofline.plan_bytes(tri) == 2 * 50 * 8
    assert roofline.pct_roofline(3.35e12, 2.0, roofline.H100_HBM_BYTES_PER_S) \
        == 0.5
    assert roofline.pct_roofline(1, 0.0, 1.0) == 0.0
