"""The port's Krylov solvers and refinement (``linalg/iterative.py``)
against the JAX package's on the same numpy inputs: the single-device
cases of the JAX package's ``tests/test_parallel.py`` (``cg`` with the
Jacobi preconditioner, complex ``bicgstab``, ``gmres``) and its mixed-
precision ``refine`` of ``tests/test_lu.py``, plus ``ilu0_prec`` and the
DIA plans as the matvec (their plain version on the CPU; on a card the
DIA kernel).

x agrees with the JAX package's to 1e-10 relative and the residual norms
to 1e-10 relative of ||b||.  The iteration counts are equal: none of these
cases stops on a rounding boundary of its stop test, where sums taken in
another order could move the count by one.
"""

import importlib

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.linalg import BandedLU as JBandedLU
from csparse3_tpu_torch import config
from csparse3_tpu_torch.linalg import BandedLU as PBandedLU

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

jit_ = importlib.import_module("csparse3_tpu.linalg.iterative")
pit = importlib.import_module("csparse3_tpu_torch.linalg.iterative")

TOL = 1e-10


def banded_spd(n, bw=5, seed=0):
    """SPD banded matrix (Laplacian-like), the RCM-ordered Ybus shape (the
    JAX package's test matrix)."""
    rng = np.random.RandomState(seed)
    diags, offs = [], []
    for off in range(1, bw + 1):
        v = -rng.rand(n - off)
        diags += [v, v]
        offs += [off, -off]
    a = sp.diags(diags, offs, shape=(n, n), format="csc")
    d = -np.asarray(a.sum(axis=1)).ravel() + 0.1
    return (a + sp.diags(d)).tocsc()


def _systems():
    spd = banded_spd(60, bw=2, seed=21)
    cplx = (banded_spd(60, bw=2, seed=22).astype(complex)
            + sp.eye(60) * 0.3j).tocsc()
    gen = banded_spd(50, bw=2, seed=23).tolil()
    gen[3, 10] += 0.4
    return {"spd": spd, "complex": cplx, "general": gen.tocsc()}


def _run(mod, name, a, b):
    """One solver case through ``mod`` (the JAX or the port's module)."""
    port = mod is pit
    A = (pt.CSC.from_scipy(a, device="cpu") if port
         else jt.CSC.from_scipy(a))
    plan = pt.SpMVPlan(A, device="cpu") if port else jt.SpMVPlan(A)
    v = torch.as_tensor(b) if port else jnp.asarray(b)
    dev = {"device": "cpu"} if port else {}
    if name == "cg":
        return mod.cg(plan, v, M=mod.jacobi_prec(A, **dev), tol=1e-13)
    if name == "bicgstab":
        return mod.bicgstab(plan, v, tol=1e-12, maxiter=2000)
    if name == "gmres":
        return mod.gmres(plan, v, tol=1e-11, restart=25)
    if name == "gmres_complex":
        return mod.gmres(plan, v, tol=1e-11, restart=20)
    if name == "gmres_ilu0":
        return mod.gmres(plan, v, M=mod.ilu0_prec(A, **dev), tol=1e-11,
                         restart=5)
    raise KeyError(name)


CASES = {"cg": "spd", "bicgstab": "complex", "gmres": "general",
         "gmres_complex": "complex", "gmres_ilu0": "general"}


@pytest.fixture(scope="module")
def reference():
    systems = _systems()
    out = {}
    for name, system in CASES.items():
        a = systems[system]
        b = np.random.RandomState(10).rand(a.shape[0])
        if system == "complex":
            b = b + 0j
        x, res, it = _run(jit_, name, a, b)
        out[name] = (a, b, np.asarray(x), float(res), int(it))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_solver_matches_reference(reference, name):
    a, b, xj, resj, itj = reference[name]
    x, res, it = _run(pit, name, a, b)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.as_tensor(b).dtype
    assert it == itj
    xn = x.numpy()
    assert np.abs(xn - xj).max() <= TOL * np.abs(xj).max()
    assert abs(float(res) - resj) <= TOL * np.linalg.norm(b)
    np.testing.assert_allclose(a @ xn, b, rtol=1e-6, atol=1e-7)


def test_gmres_closes_its_krylov_space_early():
    """restart above n: the Arnoldi basis stops growing (a zero column of
    H), the least-squares solve takes y_j = 0 there, as the JAX package's
    lstsq gives."""
    a = _systems()["general"]
    b = np.random.RandomState(3).rand(50)
    xj, rj, itj = jit_.gmres(jt.SpMVPlan(jt.CSC.from_scipy(a)),
                             jnp.asarray(b), tol=1e-11, restart=60)
    x, r, it = pit.gmres(pt.SpMVPlan(pt.CSC.from_scipy(a), device="cpu"),
                         torch.as_tensor(b), tol=1e-11, restart=60)
    assert it == int(itj) == 1
    assert np.abs(x.numpy() - np.asarray(xj)).max() < 1e-8
    assert float(r) < 1e-11 * np.linalg.norm(b)


def test_cg_over_dia_plans_matches_spmv_plan():
    """The DIA plans as the matvec (the DIA kernel on a card; the plain
    version here): the same iterates as the ELL plan to 1e-12."""
    a = banded_spd(200, bw=3, seed=5)
    A = pt.CSC.from_scipy(a, device="cpu")
    b = torch.as_tensor(np.random.RandomState(6).rand(200))
    M = pit.jacobi_prec(A, device="cpu")
    xs, _, its = pit.cg(pt.SpMVPlan(A, device="cpu"), b, M=M, tol=1e-12)
    for plan in (pt.SymDIAPlan(A, device="cpu"), pt.DIAPlan(A, device="cpu")):
        x, res, it = pit.cg(plan, b, M=M, tol=1e-12)
        assert it == its
        assert float((x - xs).abs().max()) < 1e-12 * float(xs.abs().max())
    x, _, _ = pit.bicgstab(pt.DIAPlan(A, device="cpu"), b, M=M, tol=1e-12)
    np.testing.assert_allclose(x.numpy(), spla.spsolve(a, b.numpy()),
                               rtol=1e-9)


def _bprime(mod, n):
    grids = importlib.import_module(mod.__name__ + ".models.grids")
    g = grids.synthetic_grid(n, seed=1)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    eye = mod.from_triplets(np.arange(n), np.arange(n), np.full(n, 3.0),
                            (n, n))
    return mod.from_triplets(rows, cols, vals, (n, n)) + eye


def test_refine_float32_factor_matches_reference():
    """An f32 banded factor with an f64 residual reaches f64 accuracy in
    one sweep (the LAPACK dsgesv pattern), in both packages."""
    n = 200
    Aj, Ap = _bprime(jt, n), _bprime(pt, n)
    b = np.random.RandomState(0).rand(n)
    xr = spla.spsolve(Ap.to_scipy().tocsc(), b)
    xj = np.asarray(jit_.refine(JBandedLU(Aj, dtype=np.float32),
                                jt.SpMVPlan(Aj), jnp.asarray(b), iters=1))
    lu = PBandedLU(Ap, dtype=np.float32, device="cpu")
    plan = pt.SpMVPlan(Ap, device="cpu")
    x0 = lu(torch.as_tensor(b)).double().numpy()
    x1 = pit.refine(lu, plan, torch.as_tensor(b), iters=1)
    assert x1.dtype == torch.float64
    x1 = x1.numpy()
    e0 = np.abs(x0 - xr).max() / np.abs(xr).max()
    e1 = np.abs(x1 - xr).max() / np.abs(xr).max()
    assert e0 > 1e-9 and e1 < 1e-12, (e0, e1)
    assert np.abs(x1 - xj).max() < 1e-10 * np.abs(xj).max()
    B = np.random.RandomState(1).rand(n, 3)
    X = pit.refine(lu, plan, torch.as_tensor(B), iters=2).numpy()
    assert np.abs(X - spla.spsolve(Ap.to_scipy().tocsc(), B)).max() < 1e-12


def test_jacobi_prec_matches_reference():
    a = _systems()["general"]
    a = a.tolil()
    a[4, 4] = 0.0  # a zero diagonal entry is taken as 1
    a = a.tocsc()
    r = np.random.RandomState(2).rand(50)
    Mj = jit_.jacobi_prec(jt.CSC.from_scipy(a))
    Mp = pit.jacobi_prec(pt.CSC.from_scipy(a, device="cpu"), device="cpu")
    np.testing.assert_array_equal(Mp(torch.as_tensor(r)).numpy(),
                                  np.asarray(Mj(jnp.asarray(r))))


def test_device_none_is_the_default_device(monkeypatch):
    def card():
        raise RuntimeError("default device asked for")

    monkeypatch.setattr(config, "default_device", card)
    A = pt.CSC.from_scipy(banded_spd(10, bw=1))
    for make in (pit.jacobi_prec, pit.ilu0_prec):
        with pytest.raises(RuntimeError, match="default device"):
            make(A)


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
def test_maxiter_stops_like_reference(solver):
    """A solver stopped by ``maxiter`` returns the same iterate and count;
    the port's count is a Python int."""
    a = banded_spd(40, bw=2, seed=1)
    b = np.random.RandomState(4).rand(40)
    kw = {"maxiter": 3, "tol": 1e-14}
    if solver == "gmres":
        kw.update(restart=4, maxiter=2)
    xj, rj, itj = getattr(jit_, solver)(jt.SpMVPlan(jt.CSC.from_scipy(a)),
                                        jnp.asarray(b), **kw)
    x, r, it = getattr(pit, solver)(
        pt.SpMVPlan(pt.CSC.from_scipy(a), device="cpu"),
        torch.as_tensor(b), **kw)
    assert isinstance(it, int) and it == int(itj) == kw["maxiter"]
    assert np.abs(x.numpy() - np.asarray(xj)).max() < 1e-12
    assert abs(float(r) - float(rj)) < 1e-12 * np.linalg.norm(b)
