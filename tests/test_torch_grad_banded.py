"""Gradients through the device block-Thomas recurrences and the device
ESC product, against ``jax.grad`` of the JAX package on the same numpy
inputs.

The JAX package writes these as ``lax.scan`` loops and XLA gathers, so
``jax.grad`` differentiates them in every float input.  The port gives
``thomas_sweeps`` / ``thomas_sweeps_sym`` a ``torch.autograd.Function``
whose backward is the adjoint sweeps through the same factors, and lets
autograd record out-of-place twins of ``thomas_factor_device(_sym)``,
``spike_tips_device`` and ``spike_reduced_factor``, and the gathers and
segmented sum of ``ESCSpGEMM``:

* the sweeps in every stack and in the right-hand side;
* the factorizations composed with the sweeps, in D, E, F and b (the
  probe of the JAX package: factor, then solve);
* the spike tips and the reduced factor in every stack;
* ``ESCSpGEMM`` in both value arrays (the capacity padding gets zero).

The stacks are those of the JAX package's banded test systems (B' + 3I of
a synthetic grid, RCM-ordered, and its non-symmetric variant), cut to a
few blocks.  float64 throughout, held to rtol 1e-8 of the largest entry
(the packages sum in other orders).  ``torch.autograd.gradcheck`` covers
complex right-hand sides (the conjugate-Wirtinger convention) and complex
ESC values.  Each JAX reference is jitted once and computed once per
module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.linalg import banded as jb
from csparse3_tpu.linalg import spike_stream as jss
from csparse3_tpu.linalg.ordering import rcm
from csparse3_tpu.ops import spgemm_device as jspd
from csparse3_tpu_torch.linalg import banded as pb
from csparse3_tpu_torch.linalg import spike_stream as pss
from csparse3_tpu_torch.ops import spgemm_device as pspd

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-8


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _t(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _stacks(sym, n=90, seed=2):
    """(D, E, F) block-tridiagonal stacks, s = 16, of the JAX package's
    banded test system: B' + 3I of synthetic_grid(n), RCM-ordered; the
    non-symmetric variant scales each entry above the diagonal by a
    factor in [0.8, 1)."""
    from csparse3_tpu.models import grids as jgrids

    g = jgrids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    d = np.arange(n)
    A = sp.coo_matrix((np.concatenate([bp, bp, -bp, -bp, np.full(n, 3.0)]),
                       (np.concatenate([g.f, g.t, g.f, g.t, d]),
                        np.concatenate([g.f, g.t, g.t, g.f, d]))),
                      shape=(n, n)).tocsc()
    if not sym:
        A = A.tocoo()
        f = 0.8 + 0.2 * np.random.RandomState(seed).rand(A.nnz)
        A = sp.csc_matrix((np.where(A.row < A.col, A.data * f, A.data),
                           (A.row, A.col)), shape=(n, n))
    Aj = jt.CSC.from_scipy(A)
    p = np.asarray(rcm(Aj))
    return jb._tridiag_blocks(n, *Aj[p, p].np_arrays(), 16, np.float64)


def _weights(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s) for s in shapes]


def _dot(ws, outs):
    return sum((w * o).sum() for w, o in zip(ws, outs))


def _jax_grad(f, *args):
    """``jax.grad`` of the scalar ``f`` in every argument, jitted."""
    return [np.asarray(g) for g in jax.jit(jax.grad(
        f, argnums=tuple(range(len(args)))))(*map(jnp.asarray, args))]


@pytest.fixture(scope="module")
def case():
    """The stacks, weights and right-hand side of each test, with the JAX
    package's gradients, computed once."""
    out = {}
    for sym in (True, False):
        D, E, F = _stacks(sym)
        nb, s = D.shape[:2]
        bb = np.random.RandomState(3).randn(nb, s, 2)
        w, = _weights([bb.shape], 4)
        jf = (jb.thomas_factor_device_sym(D, F) if sym
              else jb.thomas_factor_device(D, E, F))
        fac = [np.array(v) for v in jf]
        if sym:
            si, uh = fac
            sweeps = _jax_grad(
                lambda si, uh, b: jnp.sum(w * jb.thomas_sweeps_sym(
                    si, uh, b)), si, uh, bb)
            solve = _jax_grad(
                lambda D, F, b: jnp.sum(w * jb.thomas_sweeps_sym(
                    *jb.thomas_factor_device_sym(D, F), b)), D, F, bb)
        else:
            sweeps = _jax_grad(
                lambda eh, si, uh, b: jnp.sum(w * jb.thomas_sweeps(
                    eh, si, uh, b)), *fac, bb)
            solve = _jax_grad(
                lambda D, E, F, b: jnp.sum(w * jb.thomas_sweeps(
                    *jb.thomas_factor_device(D, E, F), b)), D, E, F, bb)
        # the factor alone, each output weighted
        wf = _weights([v.shape for v in fac], 5)
        factor = (_jax_grad(lambda D, F: _dot(
            wf, jb.thomas_factor_device_sym(D, F)), D, F) if sym else
            _jax_grad(lambda D, E, F: _dot(
                wf, jb.thomas_factor_device(D, E, F)), D, E, F))
        # the spike tips of the first 3 blocks' chunk
        rng = np.random.RandomState(6)
        Bp, Cp = rng.randn(s, s), rng.randn(s, s)
        wt = _weights([(s, s)] * 4, 7)
        chunk = [v[:3] for v in fac]
        if sym:
            tips = _jax_grad(lambda si, uh, B, C: _dot(
                wt, jb.spike_tips_device(si, uh, B, C)), *chunk, Bp, Cp)
        else:
            tips = _jax_grad(lambda eh, si, uh, B, C: _dot(
                wt, jb.spike_tips_device(si, uh, B, C, ehat=eh)),
                *chunk, Bp, Cp)
        out[sym] = dict(D=D, E=E, F=F, bb=bb, w=w, fac=fac, wf=wf, Bp=Bp,
                        Cp=Cp, wt=wt, chunk=chunk, sweeps=sweeps,
                        solve=solve, factor=factor, tips=tips)
    return out


@pytest.mark.parametrize("sym", [True, False])
def test_thomas_sweeps_grad_matches_jax(case, sym):
    c = case[sym]
    ins = [_t(v) for v in c["fac"]] + [_t(c["bb"])]
    sweep = pb.thomas_sweeps_sym if sym else pb.thomas_sweeps
    x = sweep(*ins)
    got = torch.autograd.grad((torch.as_tensor(c["w"]) * x).sum(), ins)
    for g, r in zip(got, c["sweeps"]):
        _close(g, r)


@pytest.mark.parametrize("sym", [True, False])
def test_factor_then_sweeps_grad_matches_jax(case, sym):
    c = case[sym]
    mats = [_t(c["D"]), _t(c["F"])] if sym else \
        [_t(c["D"]), _t(c["E"]), _t(c["F"])]
    bb = _t(c["bb"])
    if sym:
        x = pb.thomas_sweeps_sym(*pb.thomas_factor_device_sym(*mats), bb)
    else:
        x = pb.thomas_sweeps(*pb.thomas_factor_device(*mats), bb)
    got = torch.autograd.grad((torch.as_tensor(c["w"]) * x).sum(),
                              mats + [bb])
    for g, r in zip(got, c["solve"]):
        _close(g, r)


@pytest.mark.parametrize("sym", [True, False])
def test_thomas_factor_device_grad_matches_jax(case, sym):
    c = case[sym]
    mats = [_t(c["D"]), _t(c["F"])] if sym else \
        [_t(c["D"]), _t(c["E"]), _t(c["F"])]
    fac = (pb.thomas_factor_device_sym(*mats) if sym
           else pb.thomas_factor_device(*mats))
    for f, r in zip(fac, c["fac"]):
        _close(f, r, 1e-12)
    loss = _dot([torch.as_tensor(w) for w in c["wf"]], fac)
    for g, r in zip(torch.autograd.grad(loss, mats), c["factor"]):
        _close(g, r)


@pytest.mark.parametrize("sym", [True, False])
def test_spike_tips_device_grad_matches_jax(case, sym):
    c = case[sym]
    ins = [_t(v) for v in c["chunk"]] + [_t(c["Bp"]), _t(c["Cp"])]
    if sym:
        tips = pb.spike_tips_device(*ins)
    else:
        eh, si, uh, Bp, Cp = ins
        tips = pb.spike_tips_device(si, uh, Bp, Cp, ehat=eh)
    loss = _dot([torch.as_tensor(w) for w in c["wt"]], tips)
    for g, r in zip(torch.autograd.grad(loss, ins), c["tips"]):
        _close(g, r)


def test_spike_reduced_factor_grad_matches_jax():
    P, s = 5, 7
    rng = np.random.RandomState(11)
    tips = [0.1 * rng.rand(P, s, s) for _ in range(4)]
    w = _weights([(P - 1, 2 * s, 2 * s)] * 3, 12)
    ref = _jax_grad(lambda *t: _dot(w, jss.spike_reduced_factor(
        *t, s, np.float64)), *tips)
    ins = [_t(t) for t in tips]
    loss = _dot([torch.as_tensor(v) for v in w],
                pss.spike_reduced_factor(*ins, s))
    for g, r in zip(torch.autograd.grad(loss, ins), ref):
        _close(g, r)


def test_recurrences_stay_in_inference_mode_without_grad(case):
    """A call with no input that requires a gradient records nothing."""
    c = case[False]
    t = torch.as_tensor
    fac = pb.thomas_factor_device(t(c["D"]), t(c["E"]), t(c["F"]))
    outs = [*fac, pb.thomas_sweeps(*fac, t(c["bb"])),
            *pb.spike_tips_device(fac[1], fac[2], t(c["Bp"]), t(c["Cp"]),
                                  ehat=fac[0])]
    assert all(o.is_inference() for o in outs)


def test_complex_sweeps_gradcheck():
    """Complex stacks and right-hand side: the conjugate-Wirtinger
    gradient of torch, checked by finite differences."""
    rng = np.random.RandomState(8)
    nb, s = 3, 4
    D = rng.rand(nb, s, s) + 1j * rng.rand(nb, s, s) + 4 * s * np.eye(s)
    E, F = rng.rand(2, nb, s, s) * (1 - 0.5j)
    E[0] = 0
    fac = pb.thomas_factor_device(*(torch.as_tensor(v) for v in (D, E, F)))
    bb = torch.tensor(rng.rand(nb, s, 2) + 1j * rng.rand(nb, s, 2),
                      requires_grad=True)
    ins = [f.clone().requires_grad_() for f in fac] + [bb]
    assert torch.autograd.gradcheck(pb.thomas_sweeps, ins)
    assert torch.autograd.gradcheck(
        lambda si, uh, b: pb.thomas_sweeps_sym(si, uh, b), ins[1:])


# ---------------------------------------------------------------------------
# the device ESC product
# ---------------------------------------------------------------------------

def _hub(m=40, k=30, n=35, seed=1):
    """Two random sparse matrices with one dense hub row each (the JAX
    package's ESC test shape, cut to size)."""
    rng = np.random.RandomState(seed)
    A = sp.random(m, k, density=0.1, random_state=rng, format="lil")
    A[3, :] = rng.rand(k)
    B = sp.random(k, n, density=0.1, random_state=rng, format="csc")
    return sp.csc_matrix(A), B


@pytest.mark.parametrize("capacity", [None, 600])
def test_esc_spgemm_grad_matches_jax(capacity):
    A, B = _hub()
    ej = jspd.ESCSpGEMM(jt.CSC.from_scipy(A), jt.CSC.from_scipy(B),
                        capacity=capacity)
    ep = pspd.ESCSpGEMM(pt.CSC.from_scipy(A, device="cpu"),
                        pt.CSC.from_scipy(B, device="cpu"),
                        capacity=capacity, device="cpu")
    w, = _weights([(ep.total,)], 9)
    ref = _jax_grad(lambda a, b: jnp.sum(w * ej(a, b)[2]), A.data, B.data)
    a, b = _t(A.data), _t(B.data)
    indptr, rows, data, nnz = ep(a, b)
    assert rows.shape[0] == ep.total == ej.total > int(nnz)
    got = torch.autograd.grad((torch.as_tensor(w) * data).sum(), (a, b),
                              retain_graph=True)
    for g, r in zip(got, ref):
        _close(g, r)
    # the capacity padding passes no gradient
    for g in torch.autograd.grad(data[int(nnz):].sum(), (a, b)):
        assert not g.any()
    assert ep(A.data, B.data)[2].is_inference()


def test_esc_spgemm_complex_gradcheck():
    A, B = _hub(12, 9, 10, seed=2)
    ep = pspd.ESCSpGEMM(pt.CSC.from_scipy(A, device="cpu"),
                        pt.CSC.from_scipy(B, device="cpu"), device="cpu")
    a = torch.tensor(A.data * (1 - 0.7j), requires_grad=True)
    b = torch.tensor(B.data, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: ep(a, b)[2], (a, b))
