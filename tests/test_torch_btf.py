"""The port's block triangular form and block-wise LU (``linalg/btf.py``)
against the JAX package's on the same numpy inputs.

The maximum transversal and the BTF permutations come from the same native
kernel in both packages and must be equal exactly; the scipy.csgraph
version (``_btf_scipy``) gives the same block sizes; ``btf_splu`` solves
(host, block back-substitution) agree with the JAX package's to 1e-10.
"""

import importlib

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

jbtf = importlib.import_module("csparse3_tpu.linalg.btf")
pbtf = importlib.import_module("csparse3_tpu_torch.linalg.btf")


def _random_reducible(n, nb, seed):
    """A random block upper triangular matrix scrambled by random
    permutations (the JAX package's test matrix)."""
    rng = np.random.RandomState(seed)
    sizes = rng.multinomial(n - nb, np.ones(nb) / nb) + 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    A = sp.lil_matrix((n, n))
    for b in range(nb):
        lo, hi = bounds[b], bounds[b + 1]
        blk = sp.random(hi - lo, hi - lo, 0.5, random_state=rng)
        A[lo:hi, lo:hi] = blk.toarray() + np.eye(hi - lo) * (2 + rng.rand())
        if hi < n:
            A[lo:hi, hi:] = sp.random(hi - lo, n - hi, 0.15,
                                      random_state=rng).toarray()
    pr, pc = rng.permutation(n), rng.permutation(n)
    return sp.csc_matrix(A.tocsr()[pr][:, pc])


def _both(a):
    return pt.CSC.from_scipy(a, device="cpu"), jt.CSC.from_scipy(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_btf_equals_reference(seed):
    As = _random_reducible(60, 5, seed)
    pa, ja = _both(As)
    p, q, blocks = pbtf.btf(pa)
    for got, ref in zip((p, q, blocks), jbtf.btf(ja)):
        np.testing.assert_array_equal(got, ref)
    B = As.toarray()[np.ix_(p, q)]
    bid = np.repeat(np.arange(len(blocks) - 1), np.diff(blocks))
    rr, cc = np.nonzero(B)
    assert (bid[rr] <= bid[cc]).all()
    assert (np.abs(np.diag(B)) > 0).all()


def test_scipy_version_matches_block_sizes():
    pa, ja = _both(_random_reducible(80, 7, 3))
    _, _, blocks = pbtf.btf(pa)
    for p, q, b in (pbtf._btf_scipy(pa), jbtf._btf_scipy(ja)):
        assert sorted(np.diff(b).tolist()) == sorted(np.diff(blocks).tolist())
    for got, ref in zip(pbtf._btf_scipy(pa), jbtf._btf_scipy(ja)):
        np.testing.assert_array_equal(got, ref)


def test_max_transversal_equals_reference():
    full = _random_reducible(40, 4, 5)
    deficient = full.tolil()
    deficient[:, 7] = 0  # structurally singular: an empty column
    deficient = deficient.tocsc()
    deficient.eliminate_zeros()
    for a, expect in ((full, 40), (deficient, 39)):
        pa, ja = _both(a)
        match, size = pbtf.max_transversal(pa)
        ref_match, ref_size = jbtf.max_transversal(ja)
        np.testing.assert_array_equal(match, ref_match)
        assert size == ref_size == expect


@pytest.mark.parametrize("seed", [0, 4])
def test_btf_splu_solves_match_reference(seed):
    As = _random_reducible(70, 6, seed)
    pa, ja = _both(As)
    lp, lj = pbtf.btf_splu(pa), jbtf.btf_splu(ja)
    assert isinstance(lp, pbtf.BTFLU)
    assert (lp.nblocks, lp.fill, lp.is_singular) == (
        lj.nblocks, lj.fill, lj.is_singular)
    rng = np.random.RandomState(seed)
    for b in (rng.randn(70), rng.randn(70, 3)):
        x, xj = lp.solve(b), lj.solve(b)
        assert isinstance(x, np.ndarray) and x.shape == b.shape
        np.testing.assert_allclose(x, xj, rtol=0,
                                   atol=1e-10 * np.abs(xj).max())
        np.testing.assert_allclose(x, spla.spsolve(As, b), rtol=1e-8,
                                   atol=1e-10)


def test_btf_splu_never_fills_across_blocks():
    pa, _ = _both(_random_reducible(90, 9, 7))
    mono = pt.linalg.splu(pa, ordering="amd")
    assert pbtf.btf_splu(pa).fill <= mono.lnz + mono.unz


def test_rectangular_raises():
    a = pt.CSC.from_scipy(sp.random(4, 5, 0.5, format="csc"), device="cpu")
    for fn in (pbtf.btf, pbtf.max_transversal, pbtf.btf_splu):
        with pytest.raises(ValueError, match="square"):
            fn(a)
