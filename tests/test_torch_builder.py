"""Parity of the port's ``TripletBuilder`` (``LilMat`` / ``CooMat``) with
the JAX package's: the cases of ``tests/test_builder.py`` through both
builders, against each other and scipy, and overrides on top of bulk
chunks, where the port merges with one vectorized pass and the JAX package
walks the chunks in Python.

Tolerances: the CSC that ``to_csc`` gives has the JAX package's pattern
exactly and its values within 1e-14 relative (``RTOL``); the triplet lists
are the same coordinates with the same values, so the sums agree.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-14


def _same_csc(p, j):
    assert p.shape == j.shape
    pip, pix, pdt = p.np_arrays()
    jip, jix, jdt = j.np_arrays()
    np.testing.assert_array_equal(pip, jip)
    np.testing.assert_array_equal(pix, jix)
    np.testing.assert_allclose(pdt, jdt, rtol=RTOL, atol=0)


def _pair(m, n, **kw):
    return pt.LilMat(m, n, device="cpu", **kw), jt.LilMat(m, n, **kw)


def _setitem_cases(b):
    """The setitem cases of ``tests/test_builder.py`` on a builder or a
    scipy lil_matrix."""
    b[0, 0] = 2.0
    b[1, [0, 2, 4]] = 7.0
    b[2:5, 1] = 3.0
    b[3:5, 3:5] = 1.5
    b[0:2, 4:6] = np.arange(4.0).reshape(2, 2)
    b[0, 0] = 9.0
    return b


def test_setitem_cases_match_jax_and_scipy():
    p, j = _pair(6, 6)
    _setitem_cases(p)
    _setitem_cases(j)
    ref = _setitem_cases(sp.lil_matrix((6, 6)))
    _same_csc(p.to_csc(), j.to_csc())
    np.testing.assert_array_equal(p.to_dense(), ref.toarray())
    assert p.to_csc().device == torch.device("cpu")


@pytest.mark.parametrize("key", [
    (-1, 2), (slice(None), 3), ([1, 3], [0, 2]), (np.array([True, False,
                                                           True, False]), 1),
    (slice(0, 4, 2), slice(1, 3)), (2, np.array([0, 1, 3])),
])
def test_setitem_keys_and_getitem_windows_match_jax(key):
    p, j = _pair(4, 4)
    p.add_triplets([0, 1, 2], [0, 1, 2], 1.0)
    j.add_triplets([0, 1, 2], [0, 1, 2], 1.0)
    val = 5.0 if not isinstance(key[0], list) else np.array([5.0, 6.0])
    p[key] = val
    j[key] = val
    _same_csc(p.to_csc(), j.to_csc())
    np.testing.assert_array_equal(p[0:4, 0:4], j[0:4, 0:4])
    np.testing.assert_array_equal(p[key], j[key])
    assert len(p) == len(j) == p.get_nz()


def test_accumulate_then_override_matches_jax():
    p, j = _pair(3, 3)
    for b in (p, j):
        b.add(0, 0, 1.0).add(0, 0, 2.0)
        b.add_triplets([1, 2], [1, 2], [5.0, 6.0])
    assert p.try_get(0, 0) == j.try_get(0, 0) == 3.0
    for b in (p, j):
        b.insert_or_replace(0, 0, 10.0)
    _same_csc(p.to_csc(), j.to_csc())
    np.testing.assert_array_equal(p.to_dense(),
                                  [[10, 0, 0], [0, 5, 0], [0, 0, 6]])
    assert p[1, 1] == 5.0 and p.try_get(2, 0) == 0.0


def test_iadd_isub_match_jax():
    out = []
    for mod in (pt, jt):
        kw = {"device": "cpu"} if mod is pt else {}
        a = mod.LilMat(3, 3, **kw)
        a[0, 0] = 1.0
        b = mod.LilMat(3, 3, **kw)
        b.add(0, 0, 2.0)
        b.add(1, 1, 4.0)
        a += b
        first = a.to_csc()
        a -= b
        out.append((first, a.to_csc()))
    for p, j in zip(*out):
        _same_csc(p, j)
    np.testing.assert_array_equal(out[0][1].to_scipy().toarray(),
                                  [[1, 0, 0], [0, 0, 0], [0, 0, 0]])
    with pytest.raises(ValueError, match="shape mismatch"):
        a = pt.LilMat(2, 2)
        a += pt.LilMat(3, 3)


def test_bulk_ybus_assembly_matches_jax_and_scipy():
    rng = np.random.RandomState(0)
    n, e = 50, 200
    f = rng.randint(0, n, e)
    t = rng.randint(0, n, e)
    y = rng.randn(e)
    p, j = _pair(n, n)
    for b in (p, j):
        b.add_triplets(f, f, y)
        b.add_triplets(t, t, y)
        b.add_triplets(f, t, -y)
        b.add_triplets(t, f, -y)
    _same_csc(p.to_csc(), j.to_csc())
    ref = sp.coo_matrix((np.concatenate([y, y, -y, -y]),
                         (np.concatenate([f, t, f, t]),
                          np.concatenate([f, t, t, f]))), shape=(n, n))
    np.testing.assert_allclose(p.to_dense(), ref.toarray(), rtol=1e-12)
    coo = p.to_coo()
    assert isinstance(coo, pt.COO) and coo.nnz == 4 * e
    np.testing.assert_array_equal(coo.np_arrays()[0],
                                  j.to_coo().np_arrays()[0])


@pytest.mark.parametrize("overrides", [0, 1, 25, 400])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_overrides_on_bulk_chunks_match_jax(overrides, dtype):
    """Several bulk chunks with repeated coordinates, then overrides at
    coordinates that the chunks hold (and some they do not): the
    vectorized merge gives the JAX package's triplets and CSC."""
    rng = np.random.RandomState(overrides)
    m, n = 40, 30
    p, j = _pair(m, n, dtype=dtype)
    for _ in range(3):
        r = rng.randint(0, m, 500)
        c = rng.randint(0, n, 500)
        v = rng.randn(500) + (1j * rng.randn(500) if dtype == np.complex128
                              else 0)
        p.add_triplets(r, c, v)
        j.add_triplets(r, c, v)
    p.add(3, 4, 0.1).add(3, 4, 0.2)
    j.add(3, 4, 0.1).add(3, 4, 0.2)
    for _ in range(overrides):
        i, k, v = rng.randint(0, m), rng.randint(0, n), rng.randn()
        p[i, k] = v
        j[i, k] = v
    tp, tj = p.triplets(), j.triplets()
    key_p = tp[1] * m + tp[0]
    key_j = tj[1] * m + tj[0]
    np.testing.assert_array_equal(np.sort(key_p), np.sort(key_j))
    assert tp[2].dtype == tj[2].dtype == dtype
    _same_csc(p.to_csc(), j.to_csc())


def test_errors_match_jax():
    p, j = _pair(3, 4)
    for b in (p, j):
        with pytest.raises(IndexError, match="out of bounds"):
            b.add_triplets([0, 3], [1, 1], 1.0)
        with pytest.raises(ValueError, match="length mismatch"):
            b.add_triplets([0, 1], [1], 1.0)
        with pytest.raises(IndexError, match="out of range"):
            b[5, 0] = 1.0
        with pytest.raises(IndexError, match="A\\[i, j\\]"):
            b[1] = 1.0
    assert pt.CooMat is pt.TripletBuilder and pt.LilMat is pt.TripletBuilder
    e = pt.TripletBuilder(2, 2, device="cpu").to_csc()
    assert e.nnz == 0 and e.shape == (2, 2)
