"""Slicing and submatrix extraction: the port's ``CSC.__getitem__`` cases,
``submatrix`` and the point lookups against the JAX package and scipy on
the same numpy inputs.  Everything is host numpy on both sides, so
structure and values are compared exactly."""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.ops import slicing as jsl
from csparse3_tpu_torch.ops import slicing as psl

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _pair(m=23, n=17, nnz=120, seed=0, sum_duplicates=True):
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    kw = dict(sum_duplicates=sum_duplicates)
    return (pt.from_triplets(rows, cols, vals, (m, n), **kw),
            jt.from_triplets(rows, cols, vals, (m, n), **kw))


def _same(p, j, dense):
    assert isinstance(p, pt.CSC) and p.shape == j.shape == dense.shape
    for a, b in zip(p.np_arrays(), j.np_arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p.to_scipy().toarray(), dense)


RNG = np.random.default_rng(1)
KEYS = {
    "row": (5, slice(None)),
    "col": (slice(None), 3),
    "row_slice": (slice(4, 19), slice(None)),
    "col_slice": (slice(None), slice(2, 11)),
    "window": (slice(3, 20, 2), slice(1, 15, 3)),
    "copy": (slice(None), slice(None)),
    "negative_step": (slice(None, None, -1), slice(10, 2, -2)),
    "lists": ([7, 2, 2, 22, 0], [16, 0, 5, 5]),
    "permutation": (RNG.permutation(23), RNG.permutation(17)),
    "bool_masks": (RNG.random(23) < 0.5, RNG.random(17) < 0.5),
    "int_and_list": (-1, [3, 1]),
}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_getitem_matches_jax_and_scipy(name):
    P, J = _pair()
    key = KEYS[name]
    dense = J.to_scipy().toarray()
    r, c = (np.atleast_1d(np.arange(d)[k]) for k, d in zip(key, dense.shape))
    _same(P[key], J[key], dense[np.ix_(r, c)])


def test_single_key_selects_rows():
    P, J = _pair()
    _same(P[2:9], J[2:9], J.to_scipy().toarray()[2:9])


def test_scalar_lookup_matches_jax_and_scipy():
    P, J = _pair()
    dense = J.to_scipy().toarray()
    for i, j in [(0, 0), (5, 3), (-1, -1), (22, 16), (7, 2)]:
        assert P[i, j] == J[i, j] == dense[i, j]
    # a duplicated entry of a non-canonical matrix is summed
    Pd, Jd = _pair(m=4, n=4, nnz=40, seed=2, sum_duplicates=False)
    assert not Pd.canonical
    dd = Jd.to_scipy().toarray()
    for i in range(4):
        for j in range(4):
            np.testing.assert_allclose(Pd[i, j], dd[i, j], rtol=1e-14)
            assert Pd[i, j] == Jd[i, j]
    with pytest.raises(IndexError, match="out of range"):
        P[23, 0]
    with pytest.raises(IndexError, match="2-D"):
        P[1, 2, 3]


def test_submatrix_power_flow_use():
    """B[keep, keep] and Y[perm, perm] as the power-flow solvers use them."""
    from csparse3_tpu.models import grids as jgrids
    from csparse3_tpu_torch.models import grids as pgrids

    Yp, _, _ = pgrids.ybus(pgrids.synthetic_grid(200, seed=3))
    Yj, _, _ = jgrids.ybus(jgrids.synthetic_grid(200, seed=3))
    keep = np.flatnonzero(np.arange(200) % 7 != 0)
    dense = Yj.to_scipy().toarray()
    _same(Yp[keep, keep], Yj[keep, keep], dense[np.ix_(keep, keep)])
    perm = np.random.default_rng(4).permutation(200)
    _same(psl.submatrix(Yp, perm, perm), jsl.submatrix(Yj, perm, perm),
          dense[np.ix_(perm, perm)])


@pytest.mark.parametrize("canonical", [True, False])
def test_sample_values_and_offsets_match_jax(canonical):
    P, J = _pair(sum_duplicates=canonical, seed=5)
    assert P.canonical == J.canonical == canonical
    rng = np.random.default_rng(6)
    rows, cols = rng.integers(0, 23, 200), rng.integers(0, 17, 200)
    got = psl.sample_values(P, rows, cols)
    np.testing.assert_array_equal(got, jsl.sample_values(J, rows, cols))
    np.testing.assert_allclose(got, J.to_scipy().toarray()[rows, cols],
                               rtol=1e-14)
    if canonical:
        pos = psl.sample_offsets(P, rows, cols)
        np.testing.assert_array_equal(pos, jsl.sample_offsets(J, rows, cols))
        hit = pos >= 0
        np.testing.assert_array_equal(P.np_arrays()[2][pos[hit]], got[hit])
        assert (got[~hit] == 0).all() and hit.any() and (~hit).any()
    else:
        with pytest.raises(ValueError, match="canonical"):
            psl.sample_offsets(P, rows, cols)


def test_slices_keep_an_explicit_device():
    P, _ = _pair()
    S = P.to("cpu")[2:9, [1, 3]]
    assert S.data.device.type == "cpu" and S.shape == (7, 2)
