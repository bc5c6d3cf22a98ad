"""The port's sparse LDL^T (``linalg/cholesky.py``) against the JAX
package's on the same numpy inputs.

Both factor on the host with the same native kernel, so L, D, the
ordering and the singular columns must agree to 1e-12 (they are equal
here); the solves run the level-scheduled sweeps on the CPU in the port
and XLA's in the JAX package, and agree to 1e-10 relative, real and
complex symmetric, (n,) and (n, k).  scipy is the third opinion.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu import linalg as jlin
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu_torch import config
from csparse3_tpu_torch import linalg as plin
from csparse3_tpu_torch.linalg import cholesky as pchol
from csparse3_tpu_torch.models import grids as pgrids

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

N = 100


def _bprime(mod, grids, n, seed=1, shift=3.0):
    g = grids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    eye = mod.from_triplets(np.arange(n), np.arange(n), np.full(n, shift),
                            (n, n))
    return mod.from_triplets(rows, cols, vals, (n, n)) + eye


@pytest.fixture(scope="module")
def real_case():
    """(port A, JAX A, JAX factors per ordering, b, B, JAX solves)."""
    Aj = _bprime(jt, jgrids, N)
    rng = np.random.RandomState(0)
    b, B = rng.rand(N), rng.rand(N, 5)
    facs = {o: jlin.ldlt(Aj, ordering=o)
            for o in ("amd", "rcm", "nd", "mindeg", None)}
    f = facs["amd"]
    return (_bprime(pt, pgrids, N), Aj, facs, b, B,
            np.asarray(f.solve(b)), np.asarray(f.solve_plan()(B)))


@pytest.mark.parametrize("ordering", ["amd", "rcm", "nd", "mindeg", None])
def test_factors_equal_reference(real_case, ordering):
    Ap, _, facs, *_ = real_case
    fp, fj = plin.ldlt(Ap, ordering=ordering), facs[ordering]
    for got, ref in ((fp.perm, fj.perm), (fp.Lp, fj.Lp), (fp.Li, fj.Li),
                     (fp.singular_cols, fj.singular_cols)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(fp.Lx, fj.Lx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fp.D, fj.D, rtol=0, atol=1e-12)
    assert fp.fill_nnz == fj.fill_nnz and not fp.is_singular
    L = sp.csc_matrix((fp.Lx, fp.Li, fp.Lp), shape=(N, N))
    R = L @ sp.diags(fp.D) @ L.T - Ap.to_scipy()[fp.perm][:, fp.perm]
    assert abs(R).max() < 1e-10


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_real_solves_match_reference(real_case):
    Ap, _, _, b, B, xj, Xj = real_case
    f = plin.ldlt(Ap)
    assert _rel(f.solve(b, device="cpu"), xj) < 1e-10
    assert _rel(f.solve_host(b), xj) < 1e-10
    plan = f.solve_plan(device="cpu")
    assert isinstance(plan, plin.LDLTSolvePlan)
    assert plan is f.solve_plan(device="cpu")
    assert _rel(plan(torch.as_tensor(B)), Xj) < 1e-10
    assert _rel(f.solve_host(B), Xj) < 1e-10
    assert _rel(f.solve_host(b), spla.spsolve(Ap.to_scipy().tocsc(), b)) \
        < 1e-10


def test_complex_symmetric_ybus_matches_reference():
    """Ybus is complex SYMMETRIC: LDL^T without conjugation factors it."""
    Yj, _, _ = jgrids.ybus(jgrids.synthetic_grid(80, seed=2))
    Yp, _, _ = pgrids.ybus(pgrids.synthetic_grid(80, seed=2))
    fj, fp = jlin.ldlt(Yj), plin.ldlt(Yp)
    np.testing.assert_array_equal(fp.perm, fj.perm)
    np.testing.assert_allclose(fp.Lx, fj.Lx, rtol=0, atol=1e-12)
    rng = np.random.RandomState(1)
    b = rng.rand(80) + 1j * rng.rand(80)
    B = rng.rand(80, 3) + 1j * rng.rand(80, 3)
    xj = np.asarray(fj.solve(b))
    x = fp.solve(b, device="cpu")
    assert x.dtype == torch.complex128
    assert _rel(x, xj) < 1e-10
    assert _rel(fp.solve_host(b), spla.spsolve(Yp.to_scipy().tocsc(), b)) \
        < 1e-10
    # a real right-hand side against complex factors promotes
    assert _rel(fp.solve(b.real, device="cpu"),
                spla.spsolve(Yp.to_scipy().tocsc(), b.real + 0j)) < 1e-10
    assert _rel(fp.solve_plan(device="cpu")(torch.as_tensor(B)),
                np.asarray(fj.solve_plan()(B))) < 1e-10


def test_dense_tail_plan_matches_host():
    """Under nested dissection the factor of a 1200-bus B' has a dense
    trailing separator clique: both sweeps take the dense-tail plan."""
    A = _bprime(pt, pgrids, 1200, seed=3)
    f = plin.ldlt(A, ordering="nd")
    plan = f.solve_plan(device="cpu")
    assert isinstance(plan.lplan, plin.DenseTailTriSolvePlan)
    assert isinstance(plan.ltplan, plin.DenseTailTriSolvePlan)
    b = np.random.RandomState(4).rand(1200)
    assert _rel(plan(torch.as_tensor(b)), f.solve_host(b)) < 1e-10


def test_singular_reported_like_reference():
    s = sp.csc_matrix(np.array([[1.0, 2.0], [2.0, 4.0]]))
    fj = jlin.ldlt(jt.CSC.from_scipy(s), ordering=None)
    fp = plin.ldlt(pt.CSC.from_scipy(s), ordering=None)
    np.testing.assert_array_equal(fp.singular_cols, fj.singular_cols)
    assert fp.is_singular and 1 in fp.singular_cols
    with pytest.warns(UserWarning, match="singular"):
        x = fp.solve_host(np.ones(2))
    assert not np.all(np.isfinite(x))
    with pytest.warns(UserWarning, match="singular"):
        x = fp.solve(np.ones(2), device="cpu")
    assert not torch.isfinite(x).all()


def test_dense_fallback_matches_native():
    A = _bprime(pt, pgrids, 40)
    ap = A.np_arrays()
    native = plin.ldlt(A, ordering=None)
    Lp, Li, Lx, D, sing = pchol._ldlt_dense_fallback(40, *ap)
    Ls = sp.csc_matrix((Lx, Li, Lp), shape=(40, 40)).toarray()
    Ln = sp.csc_matrix((native.Lx, native.Li, native.Lp),
                       shape=(40, 40)).toarray()
    np.testing.assert_allclose(Ls, Ln, atol=1e-12)
    np.testing.assert_allclose(D, native.D, rtol=1e-12)
    assert len(sing) == 0


def test_rectangular_raises():
    with pytest.raises(ValueError, match="square"):
        plin.ldlt(pt.from_triplets([0], [1], [1.0], (2, 3)))


def test_device_none_is_the_default_device(monkeypatch):
    """A numpy right-hand side with no device goes to
    ``config.default_device()``, the CUDA card."""
    def card():
        raise RuntimeError("default device asked for")

    monkeypatch.setattr(config, "default_device", card)
    f = plin.ldlt(_bprime(pt, pgrids, 20))
    with pytest.raises(RuntimeError, match="default device"):
        f.solve(np.ones(20))
    with pytest.raises(RuntimeError, match="default device"):
        f.solve_plan()
