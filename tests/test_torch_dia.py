"""The DIA family: the port's banded SpMV plans, their plain kernel version
and the DIA conversions against the JAX package on the same numpy inputs.

The matrix is the RCM-ordered Ybus of ``synthetic_grid(300)``, as the JAX
package's Pallas tests build it.  On the CPU the port's plans run the plain
version of ``kernels.dia``; the CUDA kernel is held to that plain version
on a card in tests/test_torch_gpu.py.

Tolerances: float64 plans sum the same handful of nonzero products per row
as the JAX plans, in another order: rtol/atol 1e-12.  Float32 plans and the
Pallas kernel (interpret mode on the CPU) are held to 2e-5 of max|y|
(a row sums about ten float32 products of magnitude up to max|y|; the
JAX package's own Pallas tests use 2e-4).
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.kernels import dia_pallas as jdia
from csparse3_tpu.linalg.ordering import rcm as jrcm
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.ops import matvec as jmv
from csparse3_tpu_torch.kernels import dia as pdia
from csparse3_tpu_torch.ops import matvec as pmv
from csparse3_tpu_torch.utils.interop import csc_from_arrays, dia_from_arrays

F32_REL = 2e-5


def _banded(n=300, seed=0, dtype=np.complex128):
    """(port CSC, JAX CSC) of the RCM-ordered Ybus."""
    Y, _, _ = jgrids.ybus(jgrids.synthetic_grid(n, seed=seed))
    p = jrcm(Y)
    Yj = Y[p, p]
    ip, ix, dt = Yj.np_arrays()
    dt = dt.astype(dtype)
    Yj = jt.CSC(Yj.m, Yj.n, ip, ix, dt)
    return csc_from_arrays(Yj.m, Yj.n, ip, ix, dt), Yj


def _real(Yp, Yj, part="real", dtype=np.float64):
    ip, ix, dt = Yj.np_arrays()
    v = np.ascontiguousarray(getattr(dt, part)).astype(dtype)
    return csc_from_arrays(Yj.m, Yj.n, ip, ix, v), jt.CSC(Yj.m, Yj.n, ip, ix, v)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def test_csc_to_dia_and_back_match_jax():
    Yp, Yj = _banded()
    dp, dj = pt.csc_to_dia(Yp), jt.csc_to_dia(Yj)
    assert dp.shape == dj.shape and dp.nnz == dj.nnz
    for a, b in zip(dp.np_arrays(), dj.np_arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dp.to_scipy().toarray(),
                                  Yj.to_scipy().toarray())
    back_p, back_j = pt.dia_to_csc(dp), jt.dia_to_csc(dj)
    for a, b in zip(back_p.np_arrays(), back_j.np_arrays()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(back_p.np_arrays(), Yp.np_arrays()):
        np.testing.assert_array_equal(a, b)
    # scipy round trip and the array carrier
    d2 = pt.DIA.from_scipy(Yj.to_scipy())
    np.testing.assert_array_equal(d2.to_csc().to_scipy().toarray(),
                                  Yj.to_scipy().toarray())
    d3 = dia_from_arrays(dj.m, dj.n, *dj.np_arrays())
    np.testing.assert_array_equal(d3.to_scipy().toarray(),
                                  Yj.to_scipy().toarray())
    assert d3.to("cpu").data.dtype == torch.complex128


@pytest.mark.parametrize("shape", ["vector", "batch"])
def test_dia_spmv_matches_jax(shape):
    Yp, Yj = _banded()
    Rp, Rj = _real(Yp, Yj)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300 if shape == "vector" else (300, 3))
    got = pmv.dia_spmv(pt.csc_to_dia(Rp), _t(x)).numpy()
    ref = Rj.to_scipy() @ x
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    if shape == "vector":  # the JAX function takes vectors only
        np.testing.assert_allclose(
            got, np.asarray(jmv.dia_spmv(jt.csc_to_dia(Rj), x)),
            rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError, match="DIA"):
        pmv.dia_spmv(Rp, _t(x))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("plan", ["DIAPlan", "SymDIAPlan"])
def test_real_plans_match_jax(plan, dtype):
    Yp, Yj = _banded()
    Rp, Rj = _real(Yp, Yj, "imag", dtype)
    pp = getattr(pmv, plan)(Rp, device="cpu")
    pj = getattr(jmv, plan)(Rj)
    assert pp.ndiag == pj.ndiag and pp.slabs.dtype == _t(
        np.zeros(1, dtype)).dtype
    if plan == "DIAPlan":
        assert pp.omin == pj.omin
        np.testing.assert_array_equal(pp.slabs.numpy(), np.asarray(pj.slabs))
    rng = np.random.default_rng(2)
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == np.float64 else None
    for x in (rng.standard_normal(300), rng.standard_normal((300, 3))):
        x = x.astype(dtype)
        yp, yj = pp(_t(x)), np.asarray(pj(x))
        assert yp.shape == yj.shape and yp.dtype == _t(x).dtype
        if tol:
            np.testing.assert_allclose(yp.numpy(), yj, **tol)
            np.testing.assert_allclose(yp.numpy(), Rj.to_scipy() @ x, **tol)
        else:
            ref = Rj.to_scipy().astype(np.float64) @ x.astype(np.float64)
            scale = np.abs(ref).max()
            assert np.abs(yp.numpy() - yj).max() <= F32_REL * scale
            assert np.abs(yp.numpy() - ref).max() <= F32_REL * scale
        # on the CPU forward IS the plain version
        assert torch.equal(yp, pp.plain(_t(x)))
    with pytest.raises(ValueError, match="dimension mismatch"):
        pp(torch.zeros(299, dtype=pp.slabs.dtype))


def test_float32_plan_promotes_float64_input_on_the_cpu():
    Yp, Yj = _banded()
    Rp, Rj = _real(Yp, Yj, "real", np.float32)
    x = np.random.default_rng(3).standard_normal(300)
    yp = pmv.DIAPlan(Rp, device="cpu")(_t(x))
    yj = np.asarray(jmv.DIAPlan(Rj)(x))
    assert yp.dtype == torch.float64 and yj.dtype == np.float64
    np.testing.assert_allclose(yp.numpy(), yj, rtol=1e-12, atol=1e-12)


def test_symdia_refuses_what_the_jax_plan_refuses():
    Yp, Yj = _banded()
    Rp, Rj = _real(Yp, Yj)
    ip, ix, dt = Rj.np_arrays()
    cols = np.repeat(np.arange(Rj.n), np.diff(ip))
    bent = dt.copy()
    k = np.flatnonzero(ix > cols)[0]  # one strictly-lower entry
    bent[k] *= 1.5
    for mod, csc in ((pmv, lambda v: csc_from_arrays(300, 300, ip, ix, v)),
                     (jmv, lambda v: jt.CSC(300, 300, ip, ix, v))):
        kw = dict(device="cpu") if mod is pmv else {}
        with pytest.raises(ValueError, match="not symmetric"):
            mod.SymDIAPlan(csc(bent), **kw)
        # check=False skips the test; tol loosens it
        mod.SymDIAPlan(csc(bent), check=False, **kw)
        mod.SymDIAPlan(csc(bent), tol=10.0, **kw)
    # upper bandwidth beyond the lower one
    up = csc_from_arrays(4, 4, np.array([0, 1, 2, 3, 5]),
                         np.array([0, 1, 2, 0, 3]), np.ones(5))
    with pytest.raises(ValueError, match="bandwidth is not symmetric"):
        pmv.SymDIAPlan(up, device="cpu")
    with pytest.raises(ValueError, match="bandwidth is not symmetric"):
        jmv.SymDIAPlan(jt.CSC(4, 4, *up.np_arrays()))
    wide = csc_from_arrays(2, 3, np.array([0, 1, 1, 1]), np.array([0]),
                           np.array([1.0]))
    with pytest.raises(ValueError, match="square"):
        pmv.SymDIAPlan(wide, device="cpu")
    with pytest.raises(ValueError, match="square"):
        jmv.SymDIAPlan(jt.CSC(2, 3, *wide.np_arrays()))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("plan", ["SplitDIA", "SplitSymDIA"])
def test_split_plans_match_jax(plan, dtype):
    Yp, Yj = _banded(dtype=dtype)
    kw = dict(tol=1e-12) if plan == "SplitSymDIA" else {}
    pp = getattr(pmv, plan)(Yp, device="cpu", **kw)
    pj = getattr(jmv, plan)(Yj, **kw)
    assert pp.iscomplex and pp.re.ndiag == pj.re.ndiag
    real = np.float32 if dtype == np.complex64 else np.float64
    rng = np.random.default_rng(4)
    xr, xi = (rng.standard_normal(300).astype(real) for _ in range(2))
    z = Yj.to_scipy().astype(np.complex128) @ (xr.astype(np.float64)
                                               + 1j * xi)
    scale = np.abs(z).max()
    for got, ref, exact in zip(pp(_t(xr), _t(xi)), pj(xr, xi),
                               (z.real, z.imag)):
        assert got.dtype == _t(xr).dtype
        if real == np.float64:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got.numpy(), exact, rtol=1e-12,
                                       atol=1e-12)
        else:
            assert np.abs(got.numpy() - np.asarray(ref)).max() \
                <= F32_REL * scale
            assert np.abs(got.numpy() - exact).max() <= F32_REL * scale
    for a, b in zip(pp(_t(xr), _t(xi)), pp.plain(_t(xr), _t(xi))):
        assert torch.equal(a, b)


def test_split_plan_of_a_real_matrix_drops_the_imaginary_plan():
    Yp, Yj = _banded()
    Rp, Rj = _real(Yp, Yj)
    pp = pmv.SplitDIA(Rp, device="cpu")
    assert pp.im is None and not pp.iscomplex
    x = np.random.default_rng(5).standard_normal((2, 300))
    ref = Rj.to_scipy() @ x.T
    for k, y in enumerate(pp(_t(x[0]), _t(x[1]))):
        np.testing.assert_allclose(y.numpy(), ref[:, k], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("B", [1, 2, 3])
def test_plain_kernel_version_matches_pallas_interpret(B):
    Yp, Yj = _banded()
    Rp, Rj = _real(Yp, Yj, "real", np.float32)
    base = pmv.DIAPlan(Rp, device="cpu")
    x = np.random.RandomState(6).rand(B, 300).astype(np.float32)
    got = pdia.dia_spmv_plain(base.slabs, _t(x), base.omin)
    ref = np.asarray(jdia.dia_spmv_pallas(
        np.asarray(jmv.DIAPlan(Rj).slabs), x, omin=base.omin, tile=128,
        dchunk=16, interpret=True))
    assert got.shape == ref.shape == (B, 300) and got.dtype == torch.float32
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= F32_REL * scale
    # the dispatching wrapper takes the plain version for CPU tensors
    assert torch.equal(pdia.band_spmv(base.slabs, _t(x), base.omin), got)
    assert pdia.LAUNCHES["dia_spmv"] == 0


def test_plain_kernel_version_symmetric_equals_general():
    Yp, Yj = _banded()
    Rp, _ = _real(Yp, Yj, "imag")
    gen, sym = pmv.DIAPlan(Rp, device="cpu"), pmv.SymDIAPlan(Rp, device="cpu")
    assert sym.ndiag == (gen.ndiag + 1) // 2 and sym.omin == 0
    x = _t(np.random.default_rng(7).standard_normal((2, 300)))
    np.testing.assert_allclose(
        pdia.dia_spmv_plain(sym.slabs, x, 0, symmetric=True).numpy(),
        pdia.dia_spmv_plain(gen.slabs, x, gen.omin).numpy(),
        rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="symmetric form"):
        pdia.dia_spmv_plain(sym.slabs, x, 1, symmetric=True)


@pytest.mark.parametrize("band", ["above", "below"])
def test_band_off_the_diagonal_and_rectangular(band):
    """omin > 0 (all diagonals above the main one) and omax < 0, on a
    rectangular matrix: windows of x that start outside [0, n)."""
    m, n = (40, 55) if band == "above" else (55, 40)
    rng = np.random.default_rng(8)
    offs = [3, 4, 9] if band == "above" else [-9, -4, -3]
    rows, cols, vals = [], [], []
    for o in offs:
        i = np.arange(max(0, -o), min(m, n - o))
        rows.append(i), cols.append(i + o)
        vals.append(rng.standard_normal(len(i)))
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    Ap = pt.from_triplets(rows, cols, vals, (m, n))
    Aj = jt.from_triplets(rows, cols, vals, (m, n))
    pp, pj = pmv.DIAPlan(Ap, device="cpu"), jmv.DIAPlan(Aj)
    assert pp.omin == pj.omin == offs[0] and pp.ndiag == 7
    X = rng.standard_normal((n, 2))
    np.testing.assert_allclose(pp(_t(X)).numpy(), np.asarray(pj(X)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pp(_t(X)).numpy(), Ap.to_scipy() @ X,
                               rtol=1e-12, atol=1e-12)


def test_cuda_dia_wrappers_cast_to_float32_and_match_pallas_dia():
    Yp, Yj = _banded()
    assert pt.PallasDIA is pt.CudaDIA and pt.SplitPallasDIA is pt.SplitCudaDIA
    Rp, Rj = _real(Yp, Yj)
    pp = pt.CudaDIA(Rp, tile=128, dchunk=16, device="cpu")
    pj = jdia.PallasDIA(Rj, tile=128, dchunk=16)
    assert pp.slabs.dtype == torch.float32 and pp.ndiag == pj.ndiag
    rng = np.random.RandomState(9)
    for x in (rng.rand(300), rng.rand(300, 3)):
        yp, yj = pp(_t(x)), np.asarray(pj(x))
        assert yp.dtype == torch.float32 and yp.shape == yj.shape
        assert np.abs(yp.numpy() - yj).max() <= F32_REL * np.abs(yj).max()
    sp_ = pt.SplitCudaDIA(Yp, tile=128, device="cpu")
    sj = jdia.SplitPallasDIA(Yj, tile=128, dchunk=16)
    xr, xi = rng.rand(300), rng.rand(300)
    z = Yj.to_scipy() @ (xr + 1j * xi)
    for got, ref, exact in zip(sp_(_t(xr), _t(xi)), sj(xr, xi),
                               (z.real, z.imag)):
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - np.asarray(ref)).max() \
            <= F32_REL * np.abs(z).max()
        assert np.abs(got.numpy() - exact).max() <= F32_REL * np.abs(z).max()


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    slabs = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        pdia.dia_spmv_cuda(slabs, torch.zeros((1, 8)), -1)
    with pytest.raises(ValueError, match="CUDA device"):
        pdia.band_spmv(slabs.to("meta"), torch.zeros((1, 8)), -1)
    with pytest.raises(ValueError, match=r"\(D, m\)"):
        pdia.dia_spmv_plain(slabs, torch.zeros(8), -1)
