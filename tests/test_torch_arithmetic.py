"""CSC arithmetic of the port against the JAX package on the same numpy
inputs: ``axpby`` / ``add`` / ``sub`` / ``scale`` and the operators that
reach them, the union and intersection binops, comparisons, zero
elimination and the row and column scalings.

Both packages do this work on the host with the same algorithm (the native
two-pointer merge for canonical float operands, numpy otherwise), so the
patterns must be equal exactly and the values to 1e-14 relative (float64),
1e-6 (float32 operands).  scipy is the third opinion.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.ops import arithmetic as jar
from csparse3_tpu_torch.ops import arithmetic as par
from csparse3_tpu_torch.utils.interop import csc_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _pair(m, n, density, seed, dtype=np.float64):
    """(port CSC, JAX CSC, scipy) of one random matrix."""
    a = sp.random(m, n, density=density, format="csc",
                  random_state=np.random.RandomState(seed)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        a = (a + 1j * a.multiply(a)).tocsc().astype(dtype)
    a.sort_indices()
    Aj = jt.CSC.from_scipy(a)
    return csc_from_arrays(a.shape[0], a.shape[1], *Aj.np_arrays()), Aj, a


def _same(p, j, rtol=1e-14):
    assert p.shape == j.shape and p.nnz == j.nnz
    (ipp, ixp, dtp), (ipj, ixj, dtj) = p.np_arrays(), j.np_arrays()
    np.testing.assert_array_equal(ipp, ipj)
    np.testing.assert_array_equal(ixp, ixj)
    assert dtp.dtype == dtj.dtype
    np.testing.assert_allclose(dtp, dtj, rtol=rtol, atol=0)


AXPBY = [(dt, al, be)
         for dt in (np.float64, np.float32, np.complex128, np.int64)
         for al, be in ((1, 1), (1, -1), (2.5, -0.5))
         # integer operands keep integer scalars
         if not (dt == np.int64 and al != 1)]


@pytest.mark.parametrize("dtype,alpha,beta", AXPBY)
def test_axpby_matches_jax_and_scipy(dtype, alpha, beta):
    if dtype == np.int64:
        Ap, Aj, a = _pair(60, 40, 0.1, 1)
        Bp, Bj, b = _pair(60, 40, 0.1, 2)

        def as_int(Xj):
            ip, ix, dt = Xj.np_arrays()
            v = np.ceil(dt * 9).astype(np.int64)
            return (csc_from_arrays(Xj.m, Xj.n, ip, ix, v),
                    jt.CSC(Xj.m, Xj.n, ip, ix, v))

        (Ap, Aj), (Bp, Bj) = as_int(Aj), as_int(Bj)
        a, b = Aj.to_scipy(), Bj.to_scipy()
    else:
        Ap, Aj, a = _pair(60, 40, 0.1, 1, dtype)
        Bp, Bj, b = _pair(60, 40, 0.1, 2, dtype)
    got, ref = par.axpby(alpha, Ap, beta, Bp), jar.axpby(alpha, Aj, beta, Bj)
    _same(got, ref, rtol=1e-6 if dtype == np.float32 else 1e-14)
    np.testing.assert_allclose(
        got.to_scipy().toarray(), (alpha * a + beta * b).toarray(),
        rtol=1e-6 if dtype == np.float32 else 1e-13, atol=0)


def test_axpby_of_non_canonical_operand_matches_jax():
    rows, cols = np.array([3, 0, 3, 1]), np.array([1, 0, 1, 2])
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    Ap = pt.from_triplets(rows, cols, vals, (4, 3), sum_duplicates=False)
    Aj = jt.from_triplets(rows, cols, vals, (4, 3), sum_duplicates=False)
    assert not Ap.canonical and not Aj.canonical
    Bp, Bj, _ = _pair(4, 3, 0.5, 3)
    _same(par.axpby(2, Ap, 1, Bp), jar.axpby(2, Aj, 1, Bj))
    with pytest.raises(ValueError, match="shape mismatch"):
        par.add(Ap, _pair(3, 4, 0.5, 3)[0])


def test_operators_match_jax():
    Ap, Aj, a = _pair(50, 50, 0.08, 4)
    Bp, Bj, b = _pair(50, 50, 0.08, 5)
    _same(Ap + Bp, Aj + Bj)
    _same(Ap - Bp, Aj - Bj)
    _same(-Ap, -Aj)
    _same(Ap * 3.0, Aj * 3.0)
    _same(3.0 * Ap, 3.0 * Aj)
    _same(Ap * Bp, Aj * Bj, rtol=1e-13)      # SpGEMM
    _same(Ap @ Bp, Aj @ Bj, rtol=1e-13)
    _same(Ap.dot(Bp), Aj.dot(Bj), rtol=1e-13)
    x = np.random.RandomState(6).rand(50)
    X = np.random.RandomState(7).rand(50, 4)
    Ac = Ap.to("cpu")
    np.testing.assert_allclose((Ac * x).numpy(), np.asarray(Aj * x),
                               rtol=1e-13)
    np.testing.assert_allclose((Ac @ X).numpy(), np.asarray(Aj @ X),
                               rtol=1e-13)
    np.testing.assert_allclose((Ac @ torch.as_tensor(X)).numpy(), a @ X,
                               rtol=1e-13)
    assert Ap.__rmul__(x) is NotImplemented
    # a matrix that was not placed takes a numpy operand to the card
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        Ap * x


def test_scale_keeps_host_cache_and_works_on_tensors():
    Ap, Aj, a = _pair(30, 20, 0.2, 8)
    s = par.scale(Ap, -2.0)
    assert s._np is not None and s._device is None  # no device needed
    _same(s, jar.scale(Aj, -2.0))
    At = pt.CSC(Ap.m, Ap.n, Ap.to("cpu").indptr, Ap.to("cpu").indices,
                Ap.to("cpu").data)
    st = par.scale(At, torch.tensor(-2.0))
    assert st._np is None and st.device.type == "cpu"
    _same(st, jar.scale(Aj, -2.0))


@pytest.mark.parametrize("name", ["elmul", "eldiv", "maximum", "minimum"])
def test_pattern_binops_match_jax(name):
    Ap, Aj, a = _pair(40, 30, 0.2, 9)
    Bp, Bj, b = _pair(40, 30, 0.2, 10)
    ip, ix, dt = Bj.np_arrays()
    Bj = jt.CSC(Bj.m, Bj.n, ip, ix, dt - 0.5)  # both signs
    Bp = csc_from_arrays(Bj.m, Bj.n, ip, ix, dt - 0.5)
    _same(getattr(par, name)(Ap, Bp), getattr(jar, name)(Aj, Bj))


@pytest.mark.parametrize("op", ["ne", "lt", "gt", "le", "ge"])
def test_compare_matches_jax(op):
    Ap, Aj, _ = _pair(40, 30, 0.2, 11)
    Bp, Bj, _ = _pair(40, 30, 0.2, 12)
    got, ref = par.compare(Ap, Bp, op), jar.compare(Aj, Bj, op)
    assert got.np_arrays()[2].dtype == np.bool_
    _same(got, ref)
    with pytest.raises(ValueError, match="unknown comparison"):
        par.compare(Ap, Bp, "eq")


def test_equal_and_eliminate_zeros_match_jax():
    Ap, Aj, a = _pair(40, 30, 0.2, 13)
    Bp, Bj, _ = _pair(40, 30, 0.2, 14)
    assert par.equal(Ap, Ap) and jar.equal(Aj, Aj)
    assert not par.equal(Ap, Bp)
    assert not par.equal(Ap, _pair(30, 40, 0.2, 13)[0])
    ip, ix, dt = Aj.np_arrays()
    dz = dt.copy()
    dz[::3] = 0.0
    zp = par.eliminate_zeros(csc_from_arrays(Aj.m, Aj.n, ip, ix, dz))
    zj = jar.eliminate_zeros(jt.CSC(Aj.m, Aj.n, ip, ix, dz))
    _same(zp, zj)
    assert zp.nnz == np.count_nonzero(dz)


@pytest.mark.parametrize("where", ["host", "tensor"])
def test_row_and_column_scaling_match_jax(where):
    Ap, Aj, a = _pair(40, 30, 0.2, 15)
    dr = np.random.RandomState(16).rand(40) + 0.5
    dc = np.random.RandomState(17).rand(30) + 0.5
    if where == "tensor":
        Ap, dr_p, dc_p = Ap.to("cpu"), torch.as_tensor(dr), torch.as_tensor(dc)
    else:
        dr_p, dc_p = dr, dc
    _same(par.scale_rows(Ap, dr_p), jar.scale_rows(Aj, dr))
    _same(par.scale_columns(Ap, dc_p), jar.scale_columns(Aj, dc))
    np.testing.assert_allclose(
        par.scale_rows(Ap, dr_p).to_scipy().toarray(),
        (sp.diags(dr) @ a).toarray(), rtol=1e-14)
