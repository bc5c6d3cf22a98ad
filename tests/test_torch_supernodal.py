"""Parity of the port's supernodal refactorization and its dense helpers
with the JAX package (``linalg/supernodal.py``), on the same numpy inputs.

The host helpers and the host build are the JAX package's numpy, copied,
so their results must be equal exactly.  The numeric factorization is the
same float64 arithmetic in another order: within 1e-10 of the largest
factor entry, against JAX and against the host factors; the no-pivot dense
LU within 1e-12.  The JAX references are jitted with the plan as an
argument and computed once per module.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from csparse3_tpu.linalg import supernodal as jsn
import csparse3_tpu_torch as pt
from csparse3_tpu_torch.linalg import supernodal as psn
from csparse3_tpu_torch.models.grids import synthetic_grid

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

N = 300
FACTOR_RTOL = 1e-10   # of the largest factor entry, float64


def shifted_susceptance(n, seed):
    """B + 3I for the series susceptances B of synthetic_grid(n, seed), as
    the JAX package's tests build it."""
    g = synthetic_grid(n, seed=seed)
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
    """The JAX plan's factors of 1.7 A (amd, fundamental supernodes)."""
    A, h = system
    data = A.np_arrays()[2] * 1.7
    plan = jsn.SupernodalRefactor(h, A)
    Lx, Ux = jax.jit(lambda p, d: p.factor_values(d))(plan, data)
    return data, (np.asarray(Lx), np.asarray(Ux))


@pytest.mark.parametrize("w", [5, 32, 70])
def test_dense_lu_nopiv_matches_jax(w):
    """Batch of 3 diagonally dominant float64 blocks; w = 70 crosses the
    32-wide panel of the blocked form: 1e-12 of max|M|."""
    D = (np.random.RandomState(w).standard_normal((3, w, w))
         + 2 * w * np.eye(w))
    ref = np.asarray(jax.jit(jsn._dense_lu_nopiv)(D))
    D0 = D.copy()
    got = psn._dense_lu_nopiv(torch.as_tensor(D)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    # the input is left as it was, and L U gives it back
    np.testing.assert_array_equal(D, D0)
    L = np.tril(got, -1) + np.eye(w)
    np.testing.assert_allclose(L @ np.triu(got), D, rtol=0,
                               atol=1e-12 * np.abs(D).max())


@pytest.mark.parametrize("ordering", ["amd", "nd", "rcm", "natural"])
def test_pattern_helpers_match_jax(ordering):
    """``_pattern_symmetric`` and ``_fundamental_partition`` give the JAX
    package's results exactly."""
    A = shifted_susceptance(N, seed=2)
    h = pt.splu(A, ordering=ordering, tol=0.0)._h
    args = (h.n, h.Lp, h.Li, h.Up, h.Ui)
    assert psn._pattern_symmetric(*args) is jsn._pattern_symmetric(*args)
    assert psn._pattern_symmetric(*args)
    fp = psn._fundamental_partition(h.n, h.Lp, h.Li)
    fj = jsn._fundamental_partition(h.n, h.Lp, h.Li)
    assert fp[0] == fj[0]
    for a, b in zip(fp[1:], fj[1:]):
        np.testing.assert_array_equal(a, b)


def arrow(n=6):
    """A matrix whose no-pivot factor pattern is not symmetric: A[0, n-1]
    has no transposed partner."""
    A = sp.eye(n, format="lil") * 4.0
    A[0, n - 1] = 1.0
    return pt.CSC.from_scipy(A.tocsc())


def test_pattern_symmetric_flags_an_asymmetric_factor():
    h = pt.splu(arrow(), ordering="natural", tol=0.0)._h
    args = (h.n, h.Lp, h.Li, h.Up, h.Ui)
    assert not psn._pattern_symmetric(*args)
    assert not jsn._pattern_symmetric(*args)


def test_asymmetric_pattern_raises():
    A = arrow()
    h = pt.splu(A, ordering="natural", tol=0.0)._h
    with pytest.raises(ValueError, match="symmetric"):
        psn.SupernodalRefactor(h, A, device="cpu")


@pytest.mark.parametrize("relax", [1, 16])
@pytest.mark.parametrize("ordering", ["amd", "nd", "rcm"])
def test_index_maps_match_jax(ordering, relax):
    """Every per-level index stack of the build equals the JAX plan's."""
    A = shifted_susceptance(N, seed=1)
    h = pt.splu(A, ordering=ordering, tol=0.0)._h
    p = psn.SupernodalRefactor(h, A, relax=relax, device="cpu")
    j = jsn.SupernodalRefactor(h, A, relax=relax)
    assert (p.nlevels, p.nsnodes, p.level_widths) == (
        j.nlevels, j.nsnodes, j.level_widths)
    for lp, lj in zip(p.levels, j.levels):
        for a, b in zip(lp, lj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(p.a_dst.numpy(), np.asarray(j.a_dst))
    np.testing.assert_array_equal(p.l_unit.numpy(), np.asarray(j.l_unit))


@pytest.mark.parametrize("relax", [1, 16])
@pytest.mark.parametrize("ordering", ["amd", "nd", "rcm"])
def test_factor_values_match_host(ordering, relax):
    A = shifted_susceptance(N, seed=1)
    h = pt.splu(A, ordering=ordering, tol=0.0)._h
    p = psn.SupernodalRefactor(h, A, relax=relax, device="cpu")
    assert_factors_close(p.factor_values(A.np_arrays()[2]), (h.Lx, h.Ux))


def test_factor_values_match_jax(system, jax_factors):
    A, h = system
    data, ref = jax_factors
    p = psn.SupernodalRefactor(h, A, device="cpu")
    got = p.factor_values(torch.as_tensor(data))
    assert got[0].dtype == torch.float64
    assert_factors_close(got, ref)


def test_refactor_new_values_solve_matches_scipy(system):
    """refactor(3 A) solves like scipy's spsolve of 3 A: 1e-10 of max|x|."""
    A, h = system
    p = psn.SupernodalRefactor(h, A, device="cpu")
    b = np.random.RandomState(0).rand(A.n)
    x = p.refactor(A.np_arrays()[2] * 3.0)(torch.as_tensor(b)).numpy()
    ref = spla.spsolve(A.to_scipy().tocsc() * 3.0, b)
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-10 * np.abs(ref).max())
