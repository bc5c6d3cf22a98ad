"""Parity of the port's streamed SPIKE solver (``linalg/spike_stream.py``)
and its two device pieces, ``spike_tips_device`` (``linalg/banded.py``) and
``spike_reduced_factor``, with the JAX package's, on the same numpy
inputs, at the sizes of the JAX package's own cases
(``tests/test_banded.py`` ``TestStreamedSPIKE``: symmetric, general,
complex through the embedding, pad blocks over trailing chunks, one
chunk, s equal to the bandwidth).

Tolerances, float64 throughout unless stated:
- tips and reduced-factor stacks on the same factor stacks: within 1e-10
  of the largest entry (``STACK_RTOL``): the same products in another
  order, and LAPACK inverses by another path;
- solutions against the JAX solver: within 1e-10 of max|x|
  (``SOLVE_RTOL``); float32 within 1e-4 (``F32_RTOL``);
- residuals ||A x - b|| / ||b|| below 1e-10 (float64) and 1e-4
  (float32, the JAX package's own bound).
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.linalg import banded as jb
from csparse3_tpu.linalg import spike_stream as jss
from csparse3_tpu_torch.linalg import banded as pb
from csparse3_tpu_torch.linalg import spike_stream as pss
from csparse3_tpu_torch.models import grids as pgrids

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

STACK_RTOL = 1e-10
SOLVE_RTOL = 1e-10
F32_RTOL = 1e-4


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _grid_system(n, seed):
    """B + 3I of synthetic_grid(n, seed), as triplets."""
    g = pgrids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    d = np.arange(n)
    return (np.concatenate([g.f, g.t, g.f, g.t, d]),
            np.concatenate([g.f, g.t, g.t, g.f, d]),
            np.concatenate([bp, bp, -bp, -bp, np.full(n, 3.0)]), (n, n))


def _tridiag(n, seed):
    rng = np.random.RandomState(seed)
    return sp.diags([rng.rand(n - 1), 4 + rng.rand(n), 2 * rng.rand(n - 1)],
                    [-1, 0, 1]).tocsc()


def _complex_ybus(n, seed):
    Y, _, _ = pgrids.ybus(pgrids.synthetic_grid(n, seed=seed))
    return (Y.to_scipy() + sp.eye(n) * (2.0 + 0.3j)).tocsc()


def _complex_band(n, seed):
    rng = np.random.RandomState(seed)
    return sp.diags([rng.rand(n - 8) + 1j * rng.rand(n - 8),
                     4 + rng.rand(n) + 0.5j,
                     rng.rand(n - 8) - 1j * rng.rand(n - 8)],
                    [-8, 0, 8]).tocsc()


def _pad_system(n):
    return sp.diags([-np.ones(n - 1), 4.0 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1]).tocsc()


def _symmetric(n, seed):
    r, c, v, shape = _grid_system(n, seed)
    return sp.coo_matrix((v, (r, c)), shape=shape).tocsc()


# name -> (scipy matrix, StreamedSPIKE keywords, right-hand side columns,
# complex right-hand side, solves); the second solve takes the kept tips
CASES = {
    "symmetric": (lambda: _symmetric(600, 1), dict(P=4), 3, False, 2),
    "general": (lambda: _tridiag(400, 5), dict(P=4, ordering=None), 2,
                False, 2),
    "complex": (lambda: _complex_ybus(300, 9), dict(P=4), 1, True, 1),
    "pad_blocks": (lambda: _pad_system(136), dict(P=8, ordering=None, s=8),
                   1, False, 1),
    "one_chunk": (lambda: _symmetric(400, 6), dict(P=1), 1, False, 1),
    "s_equals_bw": (lambda: _complex_band(600, 9),
                    dict(P=2, ordering=None, s=8), 1, True, 1),
}


def _rhs(n, k, cplx, seed):
    rng = np.random.RandomState(seed)
    b = rng.rand(n, k)
    if cplx:
        b = b + 1j * rng.rand(n, k)
    return b[:, 0] if k == 1 else b


@pytest.fixture(scope="module")
def jax_solutions():
    """The JAX solver's solves of each case in float64, computed once."""
    out = {}
    for name, (make, kw, k, cplx, solves) in CASES.items():
        s = make()
        sk = jss.StreamedSPIKE(jt.CSC.from_scipy(s), dtype=np.float64, **kw)
        xs = [sk(_rhs(s.shape[0], k, cplx, seed)) for seed in range(solves)]
        out[name] = (xs, getattr(sk, "_inner", None) or sk)
    return out


def _residual(s, x, b):
    return np.linalg.norm(s @ x.astype(np.result_type(x, np.float64)) - b) \
        / np.linalg.norm(b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_streamed_spike_matches_jax(name, jax_solutions):
    make, kw, k, cplx, solves = CASES[name]
    s = make()
    n = s.shape[0]
    sk = pt.StreamedSPIKE(pt.CSC.from_scipy(s, device="cpu"),
                          dtype=np.float64, device="cpu", **kw)
    inner = sk._inner or sk
    refs, ref_sk = jax_solutions[name]
    assert (inner.s, inner.m, inner.bw, inner.P, inner._sym) == (
        ref_sk.s, ref_sk.m, ref_sk.bw, ref_sk.P, ref_sk._sym)
    np.testing.assert_array_equal(inner.perm, ref_sk.perm)
    for seed, ref in enumerate(refs):
        b = _rhs(n, k, cplx, seed)
        x = sk(b)
        assert isinstance(x, np.ndarray) and x.shape == b.shape
        _close(x, ref, SOLVE_RTOL)
        assert _residual(s, x, b) < 1e-10
    if inner.P > 1:
        assert inner._tips.shape == (inner.P, 4, inner.s, inner.s)


@pytest.mark.parametrize("name", ["symmetric", "general", "complex"])
def test_streamed_spike_float32_matches_jax_float64(name, jax_solutions):
    """The default float32 solver against the JAX float64 solution."""
    make, kw, k, cplx, _ = CASES[name]
    s = make()
    b = _rhs(s.shape[0], k, cplx, 0)
    x = pt.StreamedSPIKE(pt.CSC.from_scipy(s, device="cpu"), device="cpu",
                         **kw)(b)
    assert x.dtype == (np.complex64 if cplx else np.float32)
    _close(x, jax_solutions[name][0][0], F32_RTOL)
    assert _residual(s, x, b) < 1e-4


def _chunk_stacks(sym, seed=3, m=5, s=6):
    """Factor stacks of a random diagonally dominant block-tridiagonal
    chunk (symmetric or general), float64."""
    rng = np.random.RandomState(seed)
    D = rng.rand(m, s, s) + 4 * s * np.eye(s)
    F = rng.rand(m, s, s)
    if sym:
        D = D + D.transpose(0, 2, 1)
        return pb.thomas_factor_device_sym(torch.as_tensor(D),
                                           torch.as_tensor(F))
    E = rng.rand(m, s, s)
    E[0] = 0
    return pb.thomas_factor_device(torch.as_tensor(D), torch.as_tensor(E),
                                   torch.as_tensor(F))


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("m", [1, 2, 5])
def test_spike_tips_device_matches_jax(sym, m):
    fac = _chunk_stacks(sym, m=m)
    sinv, uhat = fac[-2], fac[-1]
    ehat = None if sym else fac[0]
    rng = np.random.RandomState(m)
    Bp, Cp = rng.rand(6, 6), rng.rand(6, 6)
    got = pb.spike_tips_device(sinv, uhat, torch.as_tensor(Bp),
                               torch.as_tensor(Cp), ehat=ehat)
    ref = jb.spike_tips_device(
        jnp.asarray(sinv.numpy()), jnp.asarray(uhat.numpy()),
        jnp.asarray(Bp), jnp.asarray(Cp),
        ehat=None if ehat is None else jnp.asarray(ehat.numpy()))
    for a, b in zip(got, ref):
        _close(a, b, STACK_RTOL)
    # against the dense spikes: W = T^{-1} [B; 0 ..], V = T^{-1} [.. 0; C]
    s = 6
    Bf = np.zeros((m * s, s))
    Bf[:s] = Bp
    Cf = np.zeros((m * s, s))
    Cf[-s:] = Cp
    sweep = ((lambda bb: pb.thomas_sweeps_sym(sinv, uhat, bb)) if sym else
             (lambda bb: pb.thomas_sweeps(ehat, sinv, uhat, bb)))
    W = sweep(torch.as_tensor(Bf).view(m, s, s)).numpy()
    V = sweep(torch.as_tensor(Cf).view(m, s, s)).numpy()
    for a, b in zip(got, (W[0], W[-1], V[0], V[-1])):
        _close(a, b, STACK_RTOL)


def test_spike_reduced_factor_matches_jax():
    P, s = 5, 7
    rng = np.random.RandomState(11)
    tips = [0.1 * rng.rand(P, s, s) for _ in range(4)]
    got = pss.spike_reduced_factor(*(torch.as_tensor(t) for t in tips), s)
    ref = jss.spike_reduced_factor(*(jnp.asarray(t) for t in tips), s,
                                   np.float64)
    for a, b in zip(got, ref):
        _close(a, b, STACK_RTOL)


def test_streamed_spike_errors_match_jax():
    s = _tridiag(40, 1)
    for mod, kw in ((pt, {"device": "cpu"}), (jt, {})):
        a = mod.CSC.from_scipy(s)
        with pytest.raises(ValueError, match=">= 2 blocks"):
            mod.linalg.StreamedSPIKE(a, P=8, ordering=None, **kw)
        with pytest.raises(ValueError, match="bandwidth"):
            mod.linalg.StreamedSPIKE(
                mod.CSC.from_scipy(_complex_band(64, 1).real.tocsc()), P=2,
                ordering=None, s=4, **kw)
        with pytest.raises(ValueError, match="square"):
            mod.linalg.StreamedSPIKE(mod.CSC.from_scipy(
                sp.random(4, 5, density=0.5, format="csc")), **kw)
