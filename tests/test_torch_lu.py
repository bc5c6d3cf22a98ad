"""Parity of the port's LU stack with the JAX package: orderings, host
factorization (the same C++, so identical), level-scheduled triangular
solves and device refactorization (rtol 1e-10: only the order of the
floating-point sums differs)."""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu.linalg as jlin
import csparse3_tpu_torch.linalg as plin
from csparse3_tpu.linalg import trisolve as jtri
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu_torch.linalg import ordering as pord
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import powerflow as ppf
from csparse3_tpu_torch.utils.interop import csc_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _jacobians(name, va_scale=0.0, seed=0):
    """(port J, JAX J) of the Newton Jacobian at a perturbed flat start."""
    out = []
    for grids, pf in ((pgrids, ppf), (jgrids, jpf)):
        g = grids.ieee14() if name == "ieee14" else grids.synthetic_grid(
            600, seed=2)
        Y, _, _ = grids.ybus(g)
        rng = np.random.default_rng(seed)
        v = g.vm0 * np.exp(1j * va_scale * rng.standard_normal(g.n_bus))
        ibus = Y.to_scipy().tocsr() @ v
        pvpq = np.concatenate([g.pv, g.pq])
        out.append(pf._jacobian(Y, v, ibus, pvpq, g.pq))
    return out


@pytest.mark.parametrize("name", ["ieee14", "synthetic600"])
def test_splu_matches_jax_exactly(name):
    Jp, Jj = _jacobians(name)
    lp, lj = plin.splu(Jp), jlin.splu(Jj)
    assert lp.method == lj.method
    np.testing.assert_array_equal(lp.perm_r, lj.perm_r)
    np.testing.assert_array_equal(lp.perm_c, lj.perm_c)
    for fp, fj in ((lp.L, lj.L), (lp.U, lj.U)):
        for a, b in zip(fp.np_arrays(), fj.np_arrays()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["amd", "nd", "rcm", "natural"])
def test_orderings_match_jax(name):
    Jp, Jj = _jacobians("synthetic600")
    np.testing.assert_array_equal(pord.get_ordering(name, Jp),
                                  jlin.ordering.get_ordering(name, Jj))


def test_lu_factor_host_matches_jax():
    rng = np.random.default_rng(3)
    n = 40
    A = sp.random(n, n, density=0.1, random_state=4, format="csc") \
        + sp.diags(rng.uniform(0.5, 1.0, n))
    A = A.tocsc()
    A.sort_indices()
    hp = plin.lu_factor_host(n, A.indptr, A.indices, A.data, tol=0.5)
    hj = jlin.lu_host.lu_factor_host(n, A.indptr, A.indices, A.data, tol=0.5)
    for a, b in zip(hp, hj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_plan_matches_jax(lower):
    Jp, _ = _jacobians("synthetic600")
    h = plin.splu(Jp)._h
    F = (h.Lp, h.Li, h.Lx) if lower else (h.Up, h.Ui, h.Ux)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((h.n, 3))
    pp = plin.TriSolvePlan(h.n, *F, lower=lower, device="cpu")
    pj = jtri.TriSolvePlan(h.n, *F, lower=lower)
    assert pp.nlevels == pj.nlevels
    for rhs in (b[:, 0], b):
        xp = pp(torch.as_tensor(rhs)).numpy()
        xj = np.asarray(pj.solve(rhs))
        np.testing.assert_allclose(xp, xj, rtol=1e-10, atol=1e-12)
    host = (jtri.lsolve if lower else jtri.usolve)(*F, b)
    np.testing.assert_allclose(pp(torch.as_tensor(b)).numpy(), host,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["ieee14", "synthetic600"])
def test_refactor_matches_jax(name):
    Jp0, Jj0 = _jacobians(name)
    Jp1, Jj1 = _jacobians(name, va_scale=0.05, seed=7)
    rp = plin.splu(Jp0).refactor_plan(Jp0, device="cpu")
    rj = jlin.splu(Jj0).refactor_plan(Jj0)
    data = Jp1.np_arrays()[2]
    np.testing.assert_array_equal(data, Jj1.np_arrays()[2])
    Lp, Up = rp.factor_values(torch.as_tensor(data))
    Lj, Uj = rj.factor_values(data)
    np.testing.assert_allclose(Lp.numpy(), np.asarray(Lj), rtol=1e-10,
                               atol=1e-13)
    np.testing.assert_allclose(Up.numpy(), np.asarray(Uj), rtol=1e-10,
                               atol=1e-13)
    # the refactored solve plan solves the new matrix
    b = np.random.default_rng(8).standard_normal(Jp1.n)
    plan, u_diag = rp.refactor(torch.as_tensor(data), with_diag=True)
    x = plan(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, spla.spsolve(Jp1.to_scipy(), b),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(u_diag.numpy(), np.asarray(
        rj.refactor(data, with_diag=True)[1]), rtol=1e-10)


def test_refactor_sums_duplicate_update_targets():
    """Columns 0 and 1 sit in one level and both update cell (2, 2): the
    level's scatter must add both (indexed += would keep one)."""
    A = np.array([[4.0, 0.0, 1.0], [0.0, 4.0, 1.0], [1.0, 1.0, 4.0]])
    a = csc_from_arrays(3, 3, *_csc(A))
    lu = plin.splu(a, ordering="natural", mode="gp")
    rp = lu.refactor_plan(a, device="cpu")
    lv0 = rp.upd_dst[rp.upd_ptr[0]:rp.upd_ptr[1]].tolist()
    assert len(lv0) == 2 and lv0[0] == lv0[1]
    A2 = A + np.diag([1.0, 2.0, 3.0])
    Lx, Ux = rp.factor_values(torch.as_tensor(_csc(A2)[2]))
    h2 = plin.splu(csc_from_arrays(3, 3, *_csc(A2)), ordering="natural",
                   mode="gp")._h
    np.testing.assert_allclose(Lx.numpy(), h2.Lx, rtol=1e-14)
    np.testing.assert_allclose(Ux.numpy(), h2.Ux, rtol=1e-14)


def _csc(A):
    m = sp.csc_matrix(A)
    m.sort_indices()
    return m.indptr, m.indices, m.data


def test_spsolve_and_solve_match_scipy():
    Jp, _ = _jacobians("synthetic600", va_scale=0.02)
    b = np.random.default_rng(9).standard_normal((Jp.n, 2))
    ref = spla.spsolve(Jp.to_scipy(), b)
    np.testing.assert_allclose(plin.spsolve(Jp, b, device="cpu").numpy(), ref, rtol=1e-9,
                               atol=1e-11)
    lu = plin.splu(Jp, ordering="amd", mode="gp")
    np.testing.assert_allclose(lu.solve_host(b), ref, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(lu.solve(torch.as_tensor(b[:, 0])).numpy(),
                               ref[:, 0], rtol=1e-9, atol=1e-11)


def test_complex_ybus_solve_matches_scipy():
    Y, _, _ = pgrids.ybus(pgrids.synthetic_grid(300, seed=5))
    b = np.random.default_rng(10).standard_normal(300) * (1 + 0.5j)
    x = plin.spsolve(Y, b, device="cpu").numpy()
    np.testing.assert_allclose(x, spla.spsolve(Y.to_scipy(), b), rtol=1e-9)


# -- dense-tail solves ---------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(min_tail=32, block=16),
                                dict(min_tail=32, block=16, max_tail=200),
                                dict(min_density=0.9),
                                dict(min_tail=100, block=48, min_density=0.5)])
def test_choose_dense_tail_matches_jax(kw):
    Jp, _ = _jacobians("synthetic600")
    h = plin.splu(Jp)._h
    for Fp, Fi in ((h.Lp, h.Li), (h.Up, h.Ui)):
        assert plin.choose_dense_tail(h.n, Fp, Fi, **kw) \
            == jtri.choose_dense_tail(h.n, Fp, Fi, **kw)
    # the default finds the separator clique of this matrix; a demand no
    # corner meets finds none
    assert plin.choose_dense_tail(h.n, h.Lp, h.Li) == 512
    assert plin.choose_dense_tail(h.n, h.Lp, h.Li, min_density=2.1) == 0


@pytest.mark.parametrize("tail,block", [(512, 256), (200, 48), (37, 16)])
@pytest.mark.parametrize("lower", [True, False])
def test_dense_tail_plan_matches_jax(lower, tail, block):
    """A tail that is a whole number of blocks, one with a short last
    block, and a small one; rtol 1e-9: the dense tail multiplies by block
    inverses, so it differs from substitution by more than sum order."""
    Jp, _ = _jacobians("synthetic600", va_scale=0.02)
    h = plin.splu(Jp)._h
    F = (h.Lp, h.Li, h.Lx) if lower else (h.Up, h.Ui, h.Ux)
    pp = plin.DenseTailTriSolvePlan(h.n, *F, lower=lower, tail=tail,
                                    block=block, device="cpu")
    pj = jtri.DenseTailTriSolvePlan(h.n, *F, lower=lower, tail=tail,
                                    block=block)
    level = plin.TriSolvePlan(h.n, *F, lower=lower, device="cpu")
    assert pp.nlevels == pj.nlevels < level.nlevels
    b = np.random.default_rng(11).standard_normal((h.n, 3))
    host = (jtri.lsolve if lower else jtri.usolve)(*F, b)
    for rhs, ref in ((b[:, 0], host[:, 0]), (b, host)):
        xp = pp(torch.as_tensor(rhs)).numpy()
        assert xp.shape == rhs.shape
        np.testing.assert_allclose(xp, np.asarray(pj.solve(rhs)), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(xp, ref, rtol=1e-9, atol=1e-11)
    # the right-hand side is not written to
    b0 = torch.as_tensor(b.copy())
    pp(b0)
    assert torch.equal(b0, torch.as_tensor(b))


@pytest.mark.parametrize("style", ["auto", "level"])
def test_solve_plan_styles_match_jax_and_scipy(style):
    Jp, Jj = _jacobians("synthetic600", va_scale=0.02)
    lp, lj = plin.splu(Jp), jlin.splu(Jj)
    pp, pj = lp.solve_plan(style=style, device="cpu"), lj.solve_plan(style)
    for fp, fj in ((pp.lplan, pj.lplan), (pp.uplan, pj.uplan)):
        assert type(fp).__name__ == type(fj).__name__
        assert fp.nlevels == fj.nlevels
        assert isinstance(fp, plin.DenseTailTriSolvePlan) == (style == "auto")
    b = np.random.default_rng(12).standard_normal((Jp.n, 2))
    x = pp(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, np.asarray(pj(b)), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(x, spla.spsolve(Jp.to_scipy(), b), rtol=1e-9,
                               atol=1e-11)
    # cached per (style, device)
    assert lp.solve_plan(style=style, device="cpu") is pp
    other = "level" if style == "auto" else "auto"
    assert lp.solve_plan(style=other, device="cpu") is not pp
    with pytest.raises(ValueError, match="style"):
        lp.solve_plan(style="dense", device="cpu")


def test_singular_factor_keeps_the_level_plan():
    A = np.array([[1.0, 2.0], [2.0, 4.0]])
    lu = plin.splu(csc_from_arrays(2, 2, *_csc(A)), mode="gp")
    assert lu.is_singular
    plan = lu.solve_plan(device="cpu")
    assert isinstance(plan.lplan, plin.TriSolvePlan)
    with pytest.warns(UserWarning, match="singular"):
        x = lu.solve(np.ones(2), device="cpu")
    assert not np.isfinite(x.numpy()).all()


def test_refactor_templates_stay_level_plans():
    """``refactor`` retargets the level layout whatever ``solve_plan``
    would pick for the factors (as the JAX package does)."""
    Jp, Jj = _jacobians("synthetic600")
    lu = plin.splu(Jp)
    assert isinstance(lu.solve_plan(device="cpu").lplan,
                      plin.DenseTailTriSolvePlan)
    plan = lu.refactor_plan(Jp, device="cpu").refactor(
        torch.as_tensor(Jp.np_arrays()[2]))
    jplan = jlin.splu(Jj).refactor_plan(Jj).refactor(Jj.np_arrays()[2])
    for fp, fj in ((plan.lplan, jplan.lplan), (plan.uplan, jplan.uplan)):
        assert type(fp).__name__ == type(fj).__name__ == "TriSolvePlan"
