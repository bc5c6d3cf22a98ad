"""Gradients through the port's numeric factorizations.

Each factorization's in-place loop is the forward of one
``torch.autograd.Function`` whose backward is a reverse sweep over the
factors it kept (``linalg/refactor.py`` ``_LevelFactor``,
``linalg/supernodal.py`` ``_PanelFactor``, ``linalg/multifrontal.py``
``_FrontFactor``); ``retarget_solve_plan`` and ``MultifrontalLU.solve_piv``
are differentiable in the factors (``_FactorSolve``, ``_FrontSolve``).
They are held three ways:

* to ``jax.grad`` of the JAX package, one reference per family, jitted once
  per module on a 12-bus system (float64, random weights on (Lx, Ux));
* without JAX, the chain ``retarget_solve_plan(p, *p.factor_values(d))(b)``
  against ``p.refactor(d)(b)``, whose gradient in d is ``_Solve``'s exact
  ``-lam[rows] x[cols]`` by a separate route, and ``solve_piv(factor_piv(
  d), b)`` against scipy's adjoint on a matrix whose fronts swap rows;
* ``torch.autograd.gradcheck`` of every new Function at n = 10, complex
  values and the scenario axis included.

A call with no input that requires a gradient stays under inference mode
and gives the same bits as the differentiable call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu import linalg as jlin
from csparse3_tpu.linalg.refactor import retarget_solve_plan as jretarget
from csparse3_tpu_torch import linalg as plin
from csparse3_tpu_torch.models import grids as pgrids

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-9
N_JAX = 12
N_SMALL = 10   # the gradchecks' buses
KINDS = ("level", "supernodal", "multifrontal")


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _grid_matrix(n, seed):
    """B' + 3I of synthetic_grid(n, seed), as a canonical scipy CSC."""
    g = pgrids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t, np.arange(n)])
    cols = np.concatenate([g.f, g.t, g.t, g.f, np.arange(n)])
    vals = np.concatenate([bp, bp, -bp, -bp, np.full(n, 3.0)])
    a = sp.csc_matrix((vals, (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    return a


def _weak_diagonal(n, seed):
    """synthetic_grid(n, seed)'s structurally symmetric pattern with random
    values and a diagonal too weak to pivot on: the fronts of
    ``MultifrontalLU`` swap rows."""
    g = pgrids.synthetic_grid(n, seed=seed)
    rng = np.random.RandomState(seed)
    m = len(g.f)
    rows = np.concatenate([g.f, g.t, np.arange(n)])
    cols = np.concatenate([g.t, g.f, np.arange(n)])
    vals = np.concatenate([rng.randn(2 * m), 0.1 + 0.1 * rng.rand(n)])
    a = sp.csc_matrix((vals, (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    return a


def _port_plan(kind, A, relax=None):
    if kind == "level":
        return plin.splu(A).refactor_plan(A, device="cpu")
    cls = (plin.SupernodalRefactor if kind == "supernodal"
           else plin.MultifrontalRefactor)
    kw = {} if relax is None else {"relax": relax}
    return cls(plin.splu(A, ordering="amd", tol=0.0)._h, A, device="cpu",
               **kw)


def _jax_plan(kind, A):
    if kind == "level":
        return jlin.splu(A).refactor_plan(A)
    cls = (jlin.SupernodalRefactor if kind == "supernodal"
           else jlin.MultifrontalRefactor)
    return cls(jlin.splu(A, ordering="amd", tol=0.0)._h, A)


def _perms_moved(factors):
    """How many groups' front perms are not the identity."""
    return sum(int((f[3] != torch.arange(f[3].shape[-1])).any())
               for f in factors)


# ---------------------------------------------------------------------------
# jax.grad references, one per family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_refs():
    """The gradients of the JAX package at N_JAX buses: the weighted
    factors of each plan in the values, Σ retarget_solve_plan(p, Lx,
    Ux)(b)² of the level plan in (Lx, Ux), and Σ solve_piv(factor_piv(d),
    b)² in d and b on a matrix whose fronts swap rows."""
    a = _grid_matrix(N_JAX, 1)
    A = jt.CSC.from_scipy(a)
    d = jnp.asarray(a.data)
    rng = np.random.RandomState(4)
    b = rng.rand(N_JAX)
    refs = {}
    for kind in KINDS:
        p = _jax_plan(kind, A)
        wL, wU = rng.randn(p.lnz), rng.randn(p.unz)

        def loss(p, d, wL=wL, wU=wU):
            Lx, Ux = p.factor_values(d)
            return jnp.sum(wL * Lx) + jnp.sum(wU * Ux)

        g = jax.jit(jax.grad(loss, argnums=1))(p, d)
        refs[kind] = (wL, wU, np.asarray(g))
        if kind == "level":
            Lx, Ux = p.factor_values(d)
            gL, gU = jax.jit(jax.grad(
                lambda p, L, U: jnp.sum(jretarget(p, L, U)(b) ** 2),
                argnums=(1, 2)))(p, Lx, Ux)
            refs["retarget"] = (np.asarray(Lx), np.asarray(Ux), b,
                                np.asarray(gL), np.asarray(gU))
    w = _weak_diagonal(N_JAX, 5)
    lu = jlin.MultifrontalLU.from_matrix(jt.CSC.from_scipy(w))
    gd, gb = jax.jit(jax.grad(
        lambda lu, d, b: jnp.sum(lu.solve_piv(lu.factor_piv(d)[0], b) ** 2),
        argnums=(1, 2)))(lu, jnp.asarray(w.data), jnp.asarray(b))
    refs["piv"] = (w, b, np.asarray(gd), np.asarray(gb))
    return a, refs


@pytest.mark.parametrize("kind", KINDS)
def test_factor_values_grad_matches_jax(jax_refs, kind):
    a, refs = jax_refs
    wL, wU, gref = refs[kind]
    A = pt.CSC.from_scipy(a)
    p = _port_plan(kind, A)
    d = torch.tensor(a.data, requires_grad=True)
    Lx, Ux = p.factor_values(d)
    assert Lx.requires_grad and Ux.requires_grad
    g, = torch.autograd.grad((torch.tensor(wL) * Lx).sum()
                             + (torch.tensor(wU) * Ux).sum(), d)
    _close(g, gref)


def test_retarget_solve_plan_grad_matches_jax(jax_refs):
    a, refs = jax_refs
    Lx0, Ux0, b, gLref, gUref = refs["retarget"]
    A = pt.CSC.from_scipy(a)
    p = _port_plan("level", A)
    Lx = torch.tensor(Lx0, requires_grad=True)
    Ux = torch.tensor(Ux0, requires_grad=True)
    x = plin.retarget_solve_plan(p, Lx, Ux)(torch.tensor(b))
    gL, gU = torch.autograd.grad((x ** 2).sum(), (Lx, Ux))
    _close(gL, gLref)
    _close(gU, gUref)
    # L's unit diagonal is a constant of the solve
    h = p._host_factors
    diag = np.asarray(h.Li) == np.repeat(np.arange(h.n), np.diff(h.Lp))
    assert not gL[torch.as_tensor(diag)].any()


def test_factor_piv_solve_piv_grad_matches_jax(jax_refs):
    _, refs = jax_refs
    w, b, gdref, gbref = refs["piv"]
    lu = plin.MultifrontalLU.from_matrix(pt.CSC.from_scipy(w), device="cpu")
    d = torch.tensor(w.data, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    factors, _ = lu.factor_piv(d)
    assert _perms_moved(factors) > 0
    gd, gb = torch.autograd.grad((lu.solve_piv(factors, bt) ** 2).sum(),
                                 (d, bt))
    _close(gd, gdref)
    _close(gb, gbref)


# ---------------------------------------------------------------------------
# the chain against refactor(d)(b), and solve_piv against scipy: no JAX
# ---------------------------------------------------------------------------

def _chain_against_refactor(p, d0, b0):
    """The gradients in d and b of Σ retarget_solve_plan(p, *p.factor_values(
    d))(b)² against those of Σ p.refactor(d)(b)²; the chain's d gradient."""
    grads = []
    for chain in (False, True):
        d = d0.clone().requires_grad_()
        b = b0.clone().requires_grad_()
        plan = (plin.retarget_solve_plan(p, *p.factor_values(d)) if chain
                else p.refactor(d))
        grads.append(torch.autograd.grad((plan(b) ** 2).sum(), (d, b)))
    for got, ref in zip(grads[1], grads[0]):
        _close(got, ref.numpy())
    return grads[1][0]


@pytest.mark.parametrize("kind", KINDS)
def test_chain_grad_matches_refactor_grad(kind):
    """At 240 buses: one scenario, then a (K, nnz) batch (row k against its
    own scenario) for the plans that take one, and the amalgamated panels
    (relax=8) for the supernodal plan."""
    n = 240
    a = _grid_matrix(n, 6)
    A = pt.CSC.from_scipy(a)
    p = _port_plan(kind, A)
    rng = np.random.RandomState(7)
    _chain_against_refactor(p, torch.tensor(a.data),
                            torch.tensor(rng.rand(n)))
    if kind == "supernodal":
        p8 = _port_plan(kind, A, relax=8)
        assert p8.nsnodes < p.nsnodes
        _chain_against_refactor(p8, torch.tensor(a.data),
                                torch.tensor(rng.rand(n)))
        return
    D = torch.tensor(a.data * (1 + 0.2 * rng.rand(3, a.nnz)))
    B = torch.tensor(rng.rand(3, n))
    gD = _chain_against_refactor(p, D, B)
    for k in range(3):
        d = D[k].clone().requires_grad_()
        x = plin.retarget_solve_plan(p, *p.factor_values(d))(B[k])
        g, = torch.autograd.grad((x ** 2).sum(), d)
        _close(gD[k], g.numpy())


def test_solve_piv_grad_matches_numpy_adjoint():
    """Σ solve_piv(factor_piv(d), b)² on a 200-bus matrix whose fronts swap
    rows: db = A^{-T} 2x and dd = -lam[rows] x[cols] with lam = A^{-T} 2x,
    by scipy; then a (K, nnz) batch, row k against its own scenario."""
    n = 200
    w = _weak_diagonal(n, 8)
    lu = plin.MultifrontalLU.from_matrix(pt.CSC.from_scipy(w), device="cpu")
    b = np.random.RandomState(9).rand(n)
    d = torch.tensor(w.data, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    factors, _ = lu.factor_piv(d)
    assert _perms_moved(factors) > 0
    gd, gb = torch.autograd.grad((lu.solve_piv(factors, bt) ** 2).sum(),
                                 (d, bt))
    x = spla.spsolve(w, b)
    lam = spla.spsolve(w.T.tocsc(), 2 * x)
    cols = np.repeat(np.arange(n), np.diff(w.indptr))
    _close(gb, lam)
    _close(gd, -lam[w.indices] * x[cols])

    D = torch.tensor(w.data * np.array([[1.0], [1.1]]), requires_grad=True)
    B = torch.tensor(np.stack([b, b[::-1]]))
    gD, = torch.autograd.grad(
        (lu.solve_piv(lu.factor_piv(D)[0], B) ** 2).sum(), D)
    for k in range(2):
        dk = D[k].detach().clone().requires_grad_()
        g, = torch.autograd.grad(
            (lu.solve_piv(lu.factor_piv(dk)[0], B[k]) ** 2).sum(), dk)
        _close(gD[k], g.numpy())


# ---------------------------------------------------------------------------
# gradcheck of each Function at n = N_SMALL
# ---------------------------------------------------------------------------

def _small(n=N_SMALL, cplx=False):
    a = _grid_matrix(n, 2)
    if cplx:
        a = a.astype(np.complex128)
        a.data *= 1 + 0.3j
    return a, pt.CSC.from_scipy(a)


@pytest.mark.parametrize("kind", KINDS)
def test_factor_values_gradcheck(kind):
    a, A = _small()
    p = _port_plan(kind, A)
    d = torch.tensor(a.data, requires_grad=True)
    assert torch.autograd.gradcheck(p.factor_values, (d,))
    if kind == "supernodal":  # amalgamated panels, absent cells and all
        p8 = _port_plan(kind, A, relax=8)
        assert p8.nsnodes < p.nsnodes
        assert torch.autograd.gradcheck(p8.factor_values, (d,))
    else:  # the scenario axis
        D = torch.stack([d.detach(), 1.2 * d.detach()]).requires_grad_()
        assert torch.autograd.gradcheck(p.factor_values, (D,))
    if kind == "level":  # complex values
        ac, Ac = _small(cplx=True)
        pc = _port_plan(kind, Ac)
        dc = torch.tensor(ac.data, requires_grad=True)
        assert torch.autograd.gradcheck(pc.factor_values, (dc,))


def test_factor_solve_gradcheck():
    a, A = _small()
    p = _port_plan("level", A)
    Lx, Ux = (t.detach().clone().requires_grad_()
              for t in p.factor_values(torch.tensor(a.data)))
    B = torch.randn(N_SMALL, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda L, U, B: plin.retarget_solve_plan(p, L, U)(B), (Lx, Ux, B))
    # the U diagonal of with_diag is a recorded gather
    assert torch.autograd.gradcheck(
        lambda U: plin.retarget_solve_plan(p, Lx.detach(), U, True)[1],
        (Ux,))
    D = torch.stack([torch.tensor(a.data), 1.3 * torch.tensor(a.data)])
    Lk, Uk = (t.detach().clone().requires_grad_()
              for t in p.factor_values(D))
    Bk = torch.randn(2, N_SMALL, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda L, U, B: plin.retarget_solve_plan(p, L, U)(B), (Lk, Uk, Bk))
    ac, Ac = _small(cplx=True)
    pc = _port_plan("level", Ac)
    dc = torch.tensor(ac.data, requires_grad=True)
    bc = torch.randn(N_SMALL, dtype=torch.complex128, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda d, b: plin.retarget_solve_plan(pc, *pc.factor_values(d))(b),
        (dc, bc))
    assert torch.autograd.gradcheck(lambda d: pc.refactor(d, True)[1], (dc,))


def test_front_factor_and_solve_gradcheck():
    w = _weak_diagonal(N_SMALL, 3)
    lu = plin.MultifrontalLU.from_matrix(pt.CSC.from_scipy(w), device="cpu")
    d = torch.tensor(w.data, requires_grad=True)
    B = torch.randn(N_SMALL, 2, dtype=torch.float64, requires_grad=True)
    factors, _ = lu.factor_piv(d.detach())
    assert _perms_moved(factors) > 0
    assert torch.autograd.gradcheck(
        lambda d, B: lu.solve_piv(lu.factor_piv(d)[0], B), (d, B))
    assert torch.autograd.gradcheck(
        lambda d: tuple(lu.factor_piv(d)[1].values()), (d,))
    # solve_piv in the factors themselves
    perms = [f[3] for f in factors]
    leaves = [t.clone().requires_grad_() for f in factors for t in f[:3]]

    def solve(B, *ts):
        return lu.solve_piv([tuple(ts[3 * g:3 * g + 3]) + (perms[g],)
                             for g in range(len(perms))], B)

    assert torch.autograd.gradcheck(solve, (B, *leaves))
    D = torch.stack([d.detach(), 1.1 * d.detach()]).requires_grad_()
    Bk = torch.randn(2, N_SMALL, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda D, B: lu.solve_piv(lu.factor_piv(D)[0], B), (D, Bk))


# ---------------------------------------------------------------------------
# calls without a gradient
# ---------------------------------------------------------------------------

def _same(plain, recorded):
    assert plain.is_inference() and not plain.requires_grad
    assert torch.equal(plain, recorded.detach())


def test_no_grad_calls_stay_in_inference_mode():
    a, A = _small()
    d0 = torch.tensor(a.data)
    for kind in KINDS:
        p = _port_plan(kind, A)
        for plain, rec in zip(p.factor_values(d0),
                              p.factor_values(d0.clone().requires_grad_())):
            _same(plain, rec)
        Lx, Ux = p.factor_values(d0)
        b = torch.randn(N_SMALL, dtype=torch.float64)
        x = plin.retarget_solve_plan(p, Lx, Ux)(b)
        assert x.is_inference()
        _same(x, plin.retarget_solve_plan(
            p, Lx.clone().requires_grad_(), Ux)(b))
    w = _weak_diagonal(N_SMALL, 3)
    lu = plin.MultifrontalLU.from_matrix(pt.CSC.from_scipy(w), device="cpu")
    dw = torch.tensor(w.data)
    (fp, sp_), (fr, sr) = lu.factor_piv(dw), lu.factor_piv(
        dw.clone().requires_grad_())
    for f, g in zip(fp, fr):
        for s, t in zip(f[:3], g[:3]):
            _same(s, t)
        assert torch.equal(f[3], g[3])
    for k in sp_:
        _same(sp_[k], sr[k])
    b = torch.randn(N_SMALL, dtype=torch.float64)
    _same(lu.solve_piv(fp, b), lu.solve_piv(fp, b.clone().requires_grad_()))
