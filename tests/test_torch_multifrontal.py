"""Parity of the port's multifrontal path with the JAX package's:
``MultifrontalRefactor``, ``MultifrontalLU`` and
``NewtonPowerFlow(solver='multifrontal')`` with its pivot-growth gate, on
the same numpy inputs.

The host builds are the JAX package's numpy, copied: the front structure
(``nlevels``, ``ngroups``, ``group_static``, ``groups_at``) must be equal
exactly.  The numeric work is the same float64 arithmetic in another
order: factors within 1e-10 of their largest entry (1e-12 for the
front-form factors of one front factorization), solves within 1e-8, and
Newton states within 1e-9 of the JAX package's at tol 1e-10.  The JAX
references are jitted with the plan as an argument and computed once per
module.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from csparse3_tpu.linalg import multifrontal as jmf
from csparse3_tpu.linalg import supernodal as jsn
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import powerflow as jpf
import csparse3_tpu_torch as pt
from csparse3_tpu_torch.linalg import multifrontal as pmf
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import powerflow as ppf
from csparse3_tpu_torch.utils import profiling

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

N = 300
FACTOR_RTOL = 1e-10   # of the largest factor entry, float64
FRONT_RTOL = 1e-12    # front-form factors of one factorization
SOLVE_RTOL = 1e-8
STATE_ATOL = 1e-9     # Newton states, both at tol 1e-10


def shifted_susceptance(n, seed):
    """B + 3I for the series susceptances B of synthetic_grid(n, seed), as
    the JAX package's tests build it."""
    g = pgrids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    d = np.arange(n)
    return pt.from_triplets(np.concatenate([g.f, g.t, g.f, g.t, d]),
                            np.concatenate([g.f, g.t, g.t, g.f, d]),
                            np.concatenate([bp, bp, -bp, -bp,
                                            np.full(n, 3.0)]), (n, n))


def assert_factors_close(got, ref, rtol=FACTOR_RTOL):
    for g, r in zip(got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=rtol * np.abs(r).max())


@pytest.fixture(scope="module")
def system():
    A = shifted_susceptance(N, seed=1)
    return A, pt.splu(A, ordering="amd", tol=0.0)._h


@pytest.fixture(scope="module")
def jax_factors(system):
    """The JAX plan's factors of 1.7 A (amd, relax 16)."""
    A, h = system
    data = A.np_arrays()[2] * 1.7
    plan = jmf.MultifrontalRefactor(h, A)
    Lx, Ux = jax.jit(lambda p, d: p.factor_values(d))(plan, data)
    return data, (np.asarray(Lx), np.asarray(Ux))


@pytest.fixture(scope="module")
def lu_pair():
    """The port's and the JAX package's MultifrontalLU of the same matrix
    (n = 200: the JAX program unrolls every front group), and the JAX
    factorization of 1.3 A with its solve of three right-hand sides."""
    A = shifted_susceptance(200, seed=2)
    p = pmf.MultifrontalLU.from_matrix(A, device="cpu")
    j = jmf.MultifrontalLU.from_matrix(A)
    data = A.np_arrays()[2] * 1.3
    B = np.random.RandomState(4).rand(A.n, 3)

    def run(plan, d, b):
        fac, stats = plan.factor_piv(d)
        return fac, stats, plan.solve_piv(fac, b)

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(run)(j, data, B))
    return A, p, j, data, B, ref


@pytest.mark.parametrize("relax", [1, 16])
@pytest.mark.parametrize("ordering", ["amd", "nd", "rcm"])
@pytest.mark.parametrize("cls", ["SupernodalRefactor", "MultifrontalRefactor"])
def test_structure_matches_jax(cls, ordering, relax):
    """The front / panel schedule equals the JAX plan's exactly."""
    A = shifted_susceptance(N, seed=1)
    h = pt.splu(A, ordering=ordering, tol=0.0)._h
    p = getattr(pt.linalg, cls)(h, A, relax=relax, device="cpu")
    j = (jmf if cls.startswith("Multi") else jsn).__dict__[cls](
        h, A, relax=relax)
    keys = (("nlevels", "nsnodes", "ngroups", "group_static", "groups_at")
            if cls.startswith("Multi") else
            ("nlevels", "nsnodes", "level_widths"))
    assert [getattr(p, k) for k in keys] == [getattr(j, k) for k in keys]


@pytest.mark.parametrize("relax", [1, 16])
@pytest.mark.parametrize("ordering", ["amd", "nd", "rcm"])
def test_factor_values_match_host(ordering, relax):
    A = shifted_susceptance(N, seed=1)
    h = pt.splu(A, ordering=ordering, tol=0.0)._h
    p = pmf.MultifrontalRefactor(h, A, relax=relax, device="cpu")
    assert_factors_close(p.factor_values(A.np_arrays()[2]), (h.Lx, h.Ux))


def test_factor_values_match_jax(system, jax_factors):
    A, h = system
    data, ref = jax_factors
    p = pmf.MultifrontalRefactor(h, A, device="cpu")
    got = p.factor_values(torch.as_tensor(data))
    assert got[0].dtype == torch.float64
    assert_factors_close(got, ref)
    # the padded fronts: one flat buffer of the groups' (nb, rmax, rmax)
    assert p.front_floats == sum(nb * r * r for nb, _, _, r in p.group_static)


def test_refactor_new_values_solve_matches_scipy(system):
    """refactor(3 A) solves like scipy's spsolve of 3 A: 1e-10 of max|x|."""
    A, h = system
    p = pmf.MultifrontalRefactor(h, A, device="cpu")
    b = np.random.RandomState(0).rand(A.n)
    x = p.refactor(A.np_arrays()[2] * 3.0)(torch.as_tensor(b)).numpy()
    ref = spla.spsolve(A.to_scipy().tocsc() * 3.0, b)
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-10 * np.abs(ref).max())


def test_refactor_needs_the_solve_plumbing(system):
    A, h = system
    p = pmf.MultifrontalRefactor(h, A, solve_plumbing=False, device="cpu")
    with pytest.raises(ValueError, match="solve_plumbing"):
        p.refactor(A.np_arrays()[2])


@pytest.mark.parametrize("cls", ["SupernodalRefactor", "MultifrontalRefactor"])
def test_pure_chain(cls):
    """A 1-D chain in natural order makes a pure-chain etree: the
    amalgamation path and deep levels (the JAX test's case: n = 200,
    relax 8)."""
    n = 200
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([np.full(n, 4.0), np.full(n - 1, -1.0),
                           np.full(n - 1, -1.0)])
    A = pt.from_triplets(rows, cols, vals, (n, n))
    h = pt.splu(A, ordering="natural", tol=0.0)._h
    p = getattr(pt.linalg, cls)(h, A, relax=8, device="cpu")
    j = (jmf if cls.startswith("Multi") else jsn).__dict__[cls](h, A, relax=8)
    assert p.nlevels == j.nlevels <= n // 4    # amalgamation merged
    assert_factors_close(p.factor_values(A.np_arrays()[2]), (h.Lx, h.Ux))


def test_asymmetric_pattern_raises():
    A = sp.eye(6, format="lil") * 4.0
    A[0, 5] = 1.0
    A = pt.CSC.from_scipy(A.tocsc())
    h = pt.splu(A, ordering="natural", tol=0.0)._h
    with pytest.raises(ValueError, match="symmetric"):
        pmf.MultifrontalRefactor(h, A, device="cpu")


# -- MultifrontalLU: from-scratch fronts with partial pivoting ----------------

def test_lu_structure_matches_jax(lu_pair):
    A, p, j, *_ = lu_pair
    keys = ("nlevels", "nsnodes", "ngroups", "group_static", "groups_at")
    assert [getattr(p, k) for k in keys] == [getattr(j, k) for k in keys]
    # the build is timed by its span, not by an attribute of the plan
    assert not hasattr(p, "build_s")
    with profiling.Timer() as rec:
        pmf.MultifrontalLU.from_matrix(A, device="cpu")
    assert [(s.name, s.counts) for s in rec.spans] == [
        ("setup.symbolic", {"n": A.n, "front_floats": p.front_floats})]


def test_factor_piv_matches_jax(lu_pair):
    """Both pick the largest |pivot| of each column (LAPACK getrf): the
    per-front permutations are equal, the front factors within 1e-12 of
    their largest entry and the growth stats within 1e-12 relative."""
    A, p, j, data, B, (fac_j, stats_j, _) = lu_pair
    fac, stats = p.factor_piv(torch.as_tensor(data))
    assert len(fac) == len(fac_j) == p.ngroups
    for f, fj in zip(fac, fac_j):
        np.testing.assert_array_equal(f[3].numpy(), fj[3])
        assert_factors_close(f[:3], fj[:3], FRONT_RTOL)
    for k in ("min_pivot", "max_u"):
        assert stats[k].ndim == 0
        assert abs(float(stats[k]) - float(stats_j[k])) <= FRONT_RTOL * abs(
            float(stats_j[k]))


@pytest.mark.parametrize("nrhs", [1, 3])
def test_solve_piv_matches_jax_and_scipy(lu_pair, nrhs):
    """One right-hand side (against the first column of JAX's solve of
    three) and three."""
    A, p, j, data, B, (_, _, x3_j) = lu_pair
    fac, _ = p.factor_piv(torch.as_tensor(data))
    b = B[:, 0] if nrhs == 1 else B
    x = p.solve_piv(fac, torch.as_tensor(b)).numpy()
    assert x.shape == b.shape
    ref = spla.spsolve(A.to_scipy().tocsc() * 1.3, b)
    np.testing.assert_allclose(x, x3_j[:, 0] if nrhs == 1 else x3_j,
                               rtol=SOLVE_RTOL, atol=1e-12)
    np.testing.assert_allclose(x, ref, rtol=SOLVE_RTOL, atol=1e-12)


def dense_case(seed):
    rng = np.random.RandomState(seed)
    D = rng.rand(40, 40) + np.eye(40) * 0.1
    return D, rng


def test_pivoting_fixes_bad_diagonal():
    """A dense 40 x 40 (one wide front) with D[3, 3] = 1e-300: the
    no-pivot factorization dies, within-front pivoting recovers
    np.linalg.solve (1e-9, the JAX test's tolerance)."""
    D, rng = dense_case(5)
    D[3, 3] = 1e-300
    A = pt.CSC.from_scipy(sp.csc_matrix(D))
    mf = pmf.MultifrontalLU.from_matrix(A, ordering=None, device="cpu")
    fac, _ = mf.factor_piv(A.np_arrays()[2])
    assert any(not torch.equal(f[3], torch.arange(f[3].shape[1]).expand_as(
        f[3])) for f in fac)    # a row exchange happened
    b = rng.rand(40)
    x = mf.solve_piv(fac, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(D, b), rtol=1e-9,
                               atol=1e-9)


def test_growth_stats_flag_singular():
    """Two equal rows on a healthy pattern: min_pivot < 1e-10 max_u, the
    gate's condition (a); the healthy matrix stays clear of it."""
    D, _ = dense_case(7)
    A = pt.CSC.from_scipy(sp.csc_matrix(D))
    mf = pmf.MultifrontalLU.from_matrix(A, ordering=None, device="cpu")
    _, ok = mf.factor_piv(A.np_arrays()[2])
    assert float(ok["min_pivot"]) > 1e-10 * float(ok["max_u"])
    D[5] = D[4]
    _, bad = mf.factor_piv(pt.CSC.from_scipy(sp.csc_matrix(D)).np_arrays()[2])
    assert float(bad["min_pivot"]) < 1e-10 * float(bad["max_u"])


# -- NewtonPowerFlow(solver='multifrontal') -----------------------------------

@pytest.fixture(scope="module")
def newton_jax():
    """The JAX package's multifrontal Newton on synthetic_grid(120, seed=14)
    (its own test's grid), tol 1e-10, through jax.jit(run_fn)."""
    g = jgrids.synthetic_grid(120, seed=14)
    pf = jpf.NewtonPowerFlow(g, tol=1e-10, solver="multifrontal")
    out = jax.jit(jpf.NewtonPowerFlow.run_fn)(
        pf, jnp.asarray(g.vm0.astype(np.float64)), jnp.zeros(g.n_bus),
        pf._sbr, pf._sbi)
    return tuple(np.asarray(o) for o in out)


@pytest.fixture(scope="module")
def newton_port():
    pf = ppf.NewtonPowerFlow(pgrids.synthetic_grid(120, seed=14), tol=1e-10,
                             solver="multifrontal", device="cpu")
    return pf, pf.solve()


def test_newton_multifrontal_matches_jax(newton_jax, newton_port):
    vm_j, va_j, it_j, res_j, bad_j = newton_jax
    pf, (vm, va, it, res) = newton_port
    assert isinstance(pf._rp, pt.linalg.MultifrontalLU)
    assert not bad_j and it == int(it_j) and res < 1e-10
    np.testing.assert_allclose(vm, vm_j, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(va, va_j, rtol=0, atol=STATE_ATOL)


def test_newton_multifrontal_matches_newton_raphson(newton_port):
    """Against the port's host reference (splu per iteration): 1e-7."""
    pf, (vm, va, it, res) = newton_port
    vm_h, va_h, _, _ = ppf.newton_raphson(pf.grid, tol=1e-10, device="cpu")
    np.testing.assert_allclose(vm, vm_h, rtol=0, atol=1e-7)
    np.testing.assert_allclose(va, va_h, rtol=0, atol=1e-7)


def test_run_reports_no_gate(newton_port):
    pf, (vm, va, it, res) = newton_port
    vm0 = torch.as_tensor(pf.grid.vm0, dtype=torch.float64)
    vm_r, va_r, it_r, res_r, bad = pf.run(vm0, torch.zeros_like(vm0))
    assert bad is False and it_r == it and res_r == res
    np.testing.assert_array_equal(vm_r.numpy(), vm)


@pytest.fixture(scope="module")
def gated():
    """growth_limit=1e-12: any real factorization has max_u > 1e-12 max|J|,
    so the first device factorization trips the gate."""
    return ppf.NewtonPowerFlow(pgrids.synthetic_grid(120, seed=14),
                               tol=1e-10, solver="multifrontal",
                               growth_limit=1e-12, device="cpu")


def test_growth_gate_falls_back_to_host_and_converges(gated, newton_port):
    with pytest.warns(RuntimeWarning, match="pivot-growth gate"):
        vm, va, it, res = gated.solve()
    _, (vm_m, va_m, it_m, _) = newton_port
    assert res < 1e-10
    # the gated iteration counts, then the host Newton's
    assert it > it_m
    np.testing.assert_allclose(vm, vm_m, rtol=0, atol=1e-9)
    np.testing.assert_allclose(va, va_m, rtol=0, atol=1e-9)


def test_gated_run_leaves_the_flat_start(gated):
    """run alone reports the gate (bad=True) after one iteration whose
    update was not applied: the state is the flat start, bit for bit."""
    vm0 = torch.as_tensor(gated.grid.vm0, dtype=torch.float64)
    va0 = torch.zeros_like(vm0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        vm, va, it, res, bad = gated.run(vm0, va0)
    assert bad is True and it == 1 and res > gated.tol
    assert torch.equal(vm, vm0) and torch.equal(va, va0)


def test_growth_gate_zero_scale_guard_in_float32():
    """Fault F3 of the JAX package, repaired here by design: its guard adds
    np.finfo(np.float64).tiny cast to the Jacobian's dtype, which is 0 in
    float32, so an all-zero float32 Jacobian gives it a scale of 0 and any
    positive max_u trips the growth test.  The port's guard is the tiny of
    the Jacobian's own dtype: a positive scale, and the same tiny factors
    pass."""
    jd = np.zeros(6, np.float32)
    jax_scale = jnp.max(jnp.abs(jnp.asarray(jd))) + jnp.asarray(
        np.finfo(np.float64).tiny, jnp.float32)
    assert float(jax_scale) == 0.0
    u = 1e-35      # a normal float32
    stats = {k: torch.tensor(u, dtype=torch.float32)
             for k in ("min_pivot", "max_u")}
    jax_bad = (u < 1e-10 * u) | (jnp.float32(u) > 1e7 * jax_scale)
    assert bool(jax_bad)
    port_scale = torch.as_tensor(jd).abs().max() + torch.finfo(
        torch.float32).tiny
    assert float(port_scale) > 0
    gate = ppf._growth_gate(torch.as_tensor(jd), stats, 1e7, 1e-10)
    assert gate.dtype == torch.bool and not bool(gate)
    # the gate's other tests still hold in float32
    stats["max_u"] = torch.tensor(float("nan"), dtype=torch.float32)
    assert bool(ppf._growth_gate(torch.as_tensor(jd), stats, 1e7, 1e-10))
