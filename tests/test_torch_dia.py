"""The DIA family: the port's banded SpMV plans, their plain kernel version
and the DIA conversions against the JAX package on the same numpy inputs.

The matrix is the RCM-ordered Ybus of ``synthetic_grid(300)``, as the JAX
package's Pallas tests build it.  On the CPU the port's plans run the plain
version of ``kernels.dia``; the CUDA kernel is held to that plain version
on a card in tests/test_torch_gpu.py.

A plan of a sparse band carries an occupancy index (which runs of
``RUN_ROWS`` slab values hold a nonzero) and on the CPU its forward is
``dia_spmv_runs_plain``, the plain walk of that index; ``dia_spmv_plain``,
the dense loop, is the truth both are held to.

Tolerances: float64 plans sum the same handful of nonzero products per row
as the JAX plans, in another order: rtol/atol 1e-12.  Float32 plans and the
Pallas kernel (interpret mode on the CPU) are held to 2e-5 of max|y|
(a row sums about ten float32 products of magnitude up to max|y|; the
JAX package's own Pallas tests use 2e-4).
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
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


# -- the occupancy index ------------------------------------------------------

def _diagonals(m, n, offs, seed, holes=0.0):
    """(port CSC, JAX CSC) with the given diagonals; ``holes`` is the share
    of each diagonal's entries left out."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for o in offs:
        i = np.arange(max(0, -o), min(m, n - o))
        i = i[rng.random(len(i)) >= holes]
        rows.append(i), cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(len(rows))
    return (pt.from_triplets(rows, cols, vals, (m, n)),
            jt.from_triplets(rows, cols, vals, (m, n)))


def _symmetric(n, offs, seed, holes):
    Ap, Aj = _diagonals(n, n, offs, seed, holes)
    S = Ap.to_scipy()
    S = (S + S.T).tocsc()
    S.sort_indices()
    return (csc_from_arrays(n, n, S.indptr, S.indices, S.data),
            jt.CSC(n, n, S.indptr, S.indices, S.data))


INDEX_CASES = {
    # name: (matrices, plan class)
    "rcm_ybus": (lambda: _real(*_banded(), "imag"), "DIAPlan"),
    "rcm_ybus_symmetric": (lambda: _real(*_banded(), "real"), "SymDIAPlan"),
    "holes_symmetric_m_not_a_multiple": (
        lambda: _symmetric(203, [0, 1, 5, 40, 41], 11, 0.7), "SymDIAPlan"),
    "wide_40x55": (lambda: _diagonals(40, 55, [3, 4, 9, 30], 12, 0.5),
                   "DIAPlan"),
    "tall_55x40": (lambda: _diagonals(55, 40, [-30, -9, -4, -3], 13, 0.5),
                   "DIAPlan"),
    "single_diagonal": (lambda: _diagonals(61, 61, [2], 14), "DIAPlan"),
    "tridiagonal": (lambda: _diagonals(64, 64, [-1, 0, 1], 15), "DIAPlan"),
    "one_entry": (lambda: (pt.from_triplets([20], [20], [1.5], (100, 100)),
                           jt.from_triplets([20], [20], [1.5], (100, 100))),
                  "DIAPlan"),
}


def _index_of(plan):
    """The plan's slabs (numpy) and the index ``run_index`` gives them, as
    tensors: the plan's own buffers when it kept one."""
    ra = plan.slabs.numpy()
    index = pdia.run_index(ra, plan.symmetric)
    if plan.has_runs:
        for mine, again in zip(plan.runs, index):
            np.testing.assert_array_equal(mine.numpy(), again)
    return ra, index


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_run_index_covers_every_nonzero_of_the_slabs(case):
    make, cls = INDEX_CASES[case]
    Ap, _ = make()
    plan = getattr(pmv, cls)(Ap, device="cpu")
    ra, index = _index_of(plan)
    S = pdia.RUN_ROWS
    D, m = ra.shape
    groups = -(-m // S)
    for k, (ptr, diag) in enumerate(zip(index[::2], index[1::2])):
        assert ptr.dtype == diag.dtype == np.int32
        assert ptr.shape == (groups + 1,) and ptr[0] == 0 \
            and ptr[-1] == len(diag) and (np.diff(ptr) >= 0).all()
        listed = set()
        for g in range(groups):
            ds = diag[ptr[g]:ptr[g + 1]]
            assert (np.diff(ds) > 0).all()  # ascending, no duplicates
            listed.update((g, int(d)) for d in ds)
        d, i = np.nonzero(ra)
        if k == 1:  # the mirror reads: row i + d reads slabs[d, i], d >= 1
            d, i = d[d > 0], (i + d)[d > 0]
        assert i.max(initial=0) < m
        need = set(zip((i // S).tolist(), d.tolist()))
        assert need <= listed
        # and no run is listed that holds nothing
        assert listed == need
    assert len(index) == (4 if plan.symmetric else 2)
    # a band that is dense keeps no index and walks all of it
    assert plan.has_runs == (plan.run_share <= pdia.RUN_SHARE_MAX)
    if case in ("tridiagonal", "single_diagonal"):
        # every run but those of the last rows, whose columns are past n
        assert plan.run_share > 0.9 and not plan.has_runs
    elif not case.startswith("rcm_ybus"):  # at 300 buses: near the rule's edge
        assert plan.run_share < 0.15 and plan.has_runs
    assert (plan.runs is None) == (not plan.has_runs)


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_runs_plain_equals_dense_plain_and_jax(case, B):
    make, cls = INDEX_CASES[case]
    Ap, Aj = make()
    plan = getattr(pmv, cls)(Ap, device="cpu")
    _, index = _index_of(plan)
    runs = tuple(_t(a) for a in index)
    x = np.random.default_rng(17).standard_normal((B, Ap.n))
    dense = pdia.dia_spmv_plain(plan.slabs, _t(x), plan.omin, plan.symmetric)
    walked = pdia.dia_spmv_runs_plain(plan.slabs, _t(x), plan.omin,
                                      plan.symmetric, runs)
    assert walked.shape == dense.shape == (B, Ap.m)
    np.testing.assert_allclose(walked.numpy(), dense.numpy(), rtol=1e-12,
                               atol=1e-12)
    yj = np.asarray(getattr(jmv, cls)(Aj)(x.T)).T
    np.testing.assert_allclose(walked.numpy(), yj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dense.numpy(), yj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(walked.numpy(), (Ap.to_scipy() @ x.T).T,
                               rtol=1e-12, atol=1e-12)
    # the dispatching wrapper walks the index it is given, on the CPU too
    assert torch.equal(pdia.band_spmv(plan.slabs, _t(x), plan.omin,
                                      plan.symmetric, runs), walked)
    # and a plan's forward is the version of its own route
    route = walked if plan.has_runs else dense
    assert torch.equal(plan.apply_bn(_t(x)), route)
    assert torch.equal(plan.apply_bn(_t(x), plain=True), route)
    assert not any(pdia.LAUNCHES.values())


@pytest.mark.parametrize("sym", [False, True])
def test_runs_plain_matches_pallas_interpret_in_float32(sym):
    Yp, Yj = _banded()
    Rp, Rj = _real(Yp, Yj, "real", np.float32)
    plan = (pmv.SymDIAPlan if sym else pmv.DIAPlan)(Rp, device="cpu")
    assert plan.slabs.dtype == torch.float32
    runs = tuple(_t(a) for a in _index_of(plan)[1])
    x = np.random.RandomState(18).rand(2, 300).astype(np.float32)
    got = pdia.dia_spmv_runs_plain(plan.slabs, _t(x), plan.omin, sym, runs)
    base = jmv.DIAPlan(Rj)
    ref = np.asarray(jdia.dia_spmv_pallas(
        np.asarray(base.slabs), x, omin=base.omin, tile=128, dchunk=16,
        interpret=True))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= F32_REL * np.abs(ref).max()


def test_an_all_zero_band_has_an_empty_index():
    ra = np.zeros((3, 21))
    for sym in (False, True):
        index = pdia.run_index(ra, sym)
        assert len(index) == (4 if sym else 2)
        for ptr, diag in zip(index[::2], index[1::2]):
            assert ptr.shape == (-(-21 // pdia.RUN_ROWS) + 1,) \
                and not ptr.any() and diag.shape == (0,)
        x = torch.ones((2, 21), dtype=torch.float64)
        y = pdia.dia_spmv_runs_plain(_t(ra), x, 0 if sym else -1, sym,
                                     tuple(_t(a) for a in index))
        assert y.shape == (2, 21) and not y.any()
    empty = pdia.run_index(np.zeros((0, 5)))
    assert empty[0].shape == (-(-5 // pdia.RUN_ROWS) + 1,) \
        and empty[1].shape == (0,)


def test_float_cast_leaves_the_index_alone():
    Rp, _ = _diagonals(203, 203, [-40, -5, 0, 1, 5, 41], 19, 0.7)
    wide = pmv.DIAPlan(Rp, device="cpu")
    cast = pt.CudaDIA(Rp, device="cpu")
    assert cast.slabs.dtype == torch.float32 and cast.plan.has_runs
    for a, b in zip(cast.plan.runs, wide.runs):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    # the packed run values are cast with the slabs they copy
    for a, b in zip(cast.plan.run_values, wide.run_values):
        assert a.dtype == torch.float32 and torch.equal(a, b.float())
    x = np.random.default_rng(19).standard_normal(203)
    ref = Rp.to_scipy() @ x
    assert np.abs(cast(_t(x)).numpy() - ref).max() \
        <= F32_REL * np.abs(ref).max()


def test_run_wrappers_refuse_a_malformed_index():
    slabs = torch.zeros((3, 20), dtype=torch.float64)
    x = torch.zeros((1, 20), dtype=torch.float64)
    ptr, diag = (_t(a) for a in pdia.run_index(slabs.numpy()))
    with pytest.raises(ValueError, match="occupancy index"):
        pdia.dia_spmv_runs_plain(slabs, x, -1, False, (ptr[:-1], diag))
    with pytest.raises(ValueError, match="occupancy index"):
        pdia.band_spmv(slabs, x, -1, False, (ptr.long(), diag))
    with pytest.raises(ValueError, match="occupancy index"):
        pdia.band_spmv(slabs, x, 0, True, (ptr, diag))  # no mirror lists
    with pytest.raises(ValueError, match="together with the run values"):
        pdia.dia_spmv_cuda(slabs, x, -1, False, (ptr, diag))
    with pytest.raises(ValueError, match="CUDA device"):
        pdia.dia_spmv_cuda(slabs, x, -1, False, (ptr, diag), pdia.pack_runs(
            slabs, 20, -1, False, (ptr, diag)))


# -- one index for the two slab sets of a complex matrix ----------------------

def _complex_band(n=203, seed=21, symmetric=False):
    """A complex band whose real and imaginary parts differ in pattern:
    some stored values are purely real, some purely imaginary."""
    Ap, _ = (_symmetric(n, [0, 1, 5, 40], seed, 0.6) if symmetric
             else _diagonals(n, n, [-40, -5, 0, 1, 5, 41], seed, 0.6))
    ip, ix, re = Ap.np_arrays()
    rng = np.random.default_rng(seed + 1)
    if symmetric:  # one value for an entry and its mirror
        S = Ap.to_scipy().tocoo()
        lo, hi = np.minimum(S.row, S.col), np.maximum(S.row, S.col)
        key = (lo * n + hi) % 7
        im = np.where(key == 0, 0.0, np.cos(lo + 3.0 * hi))
        re = np.where(key == 1, 0.0, S.data)
        C = sp.coo_matrix((re + 1j * im, (S.row, S.col)), (n, n)).tocsc()
        C.sort_indices()
        ip, ix, vals = C.indptr, C.indices, C.data
    else:
        im = rng.standard_normal(len(re)) * (rng.random(len(re)) > 0.2)
        vals = re * (rng.random(len(re)) > 0.2) + 1j * im
    return csc_from_arrays(n, n, ip, ix, vals), jt.CSC(n, n, ip, ix, vals)


@pytest.mark.parametrize("plan", ["SplitDIA", "SplitSymDIA", "SplitCudaDIA"])
def test_split_plans_share_the_union_of_their_indices(plan):
    sym = plan == "SplitSymDIA"
    Ap, Aj = _complex_band(symmetric=sym)
    kw = dict(tol=1e-12) if sym else {}
    pp = (pt.SplitCudaDIA(Ap, device="cpu") if plan == "SplitCudaDIA"
          else getattr(pmv, plan)(Ap, device="cpu", **kw))
    assert pp.shared_runs
    re, im = (pp.re.plan, pp.im.plan) if plan == "SplitCudaDIA" \
        else (pp.re, pp.im)
    own = [pdia.run_index(p.slabs.numpy(), sym) for p in (re, im)]
    # the patterns differ, so neither plan's own index is the shared one
    assert any(len(a) != len(b) or (a != b).any()
               for a, b in zip(own[0][1::2], own[1][1::2]))
    for a, b in zip(re.runs, im.runs):
        assert a is b  # held once
    for p in (re, im):  # each set's values packed under the shared index
        for mine, again in zip(p.run_values, pdia.pack_runs(
                p.slabs, p.n, p.omin, sym, p.runs)):
            assert torch.equal(mine, again)
        assert np.count_nonzero(p.run_values[0].numpy()) \
            == np.count_nonzero(p.slabs.numpy())
    S = pdia.RUN_ROWS
    for k, (ptr, diag) in enumerate(zip(re.runs[::2], re.runs[1::2])):
        listed = {(g, int(d)) for g in range(len(ptr) - 1)
                  for d in diag[ptr[g]:ptr[g + 1]]}
        need = set()
        for o in own:
            p, dd = o[2 * k], o[2 * k + 1]
            need |= {(g, int(d)) for g in range(len(p) - 1)
                     for d in dd[p[g]:p[g + 1]]}
        assert listed == need  # the union, nothing else
        for g in range(len(ptr) - 1):
            assert (np.diff(diag[ptr[g]:ptr[g + 1]].numpy()) > 0).all()
    rng = np.random.default_rng(23)
    real = np.float32 if plan == "SplitCudaDIA" else np.float64
    xr, xi = (rng.standard_normal(Ap.n).astype(real) for _ in range(2))
    z = Ap.to_scipy() @ (xr.astype(np.float64) + 1j * xi)
    tol = 1e-12 if real == np.float64 else F32_REL
    jp = (jdia.SplitPallasDIA(Aj, tile=128, dchunk=16)
          if plan == "SplitCudaDIA" else getattr(jmv, plan)(Aj, **kw))
    for got, ref, exact in zip(pp(_t(xr), _t(xi)), jp(xr, xi),
                               (z.real, z.imag)):
        assert got.dtype == _t(xr).dtype
        scale = np.abs(z).max()
        assert np.abs(got.numpy() - exact).max() <= tol * scale
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= tol * scale
    if plan != "SplitCudaDIA":
        for a, b in zip(pp(_t(xr), _t(xi)), pp.plain(_t(xr), _t(xi))):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="dimension mismatch"):
            pp(_t(xr[:-1]), _t(xi[:-1]))
    assert not any(pdia.LAUNCHES.values())


def test_split_plans_without_a_common_index_take_two_products():
    # a real matrix has one plan; a dense band keeps no index to share
    Rp, _ = _diagonals(64, 64, [-1, 0, 1], 15)
    assert not pmv.SplitDIA(Rp, device="cpu").shared_runs
    ip, ix, v = Rp.np_arrays()
    Cp = csc_from_arrays(64, 64, ip, ix, v * (1 + 2j))
    pp = pmv.SplitDIA(Cp, device="cpu")
    assert not pp.shared_runs and pp.re.runs is None
    x = np.random.default_rng(24).standard_normal((2, 64))
    z = Cp.to_scipy() @ (x[0] + 1j * x[1])
    for got, exact in zip(pp(_t(x[0]), _t(x[1])), (z.real, z.imag)):
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-12, atol=1e-12)


def test_merge_run_index_of_an_index_with_itself_and_with_nothing():
    ra = _diagonals(45, 45, [-3, 0, 7], 25, 0.5)[0]
    slabs = pmv.DIAPlan(ra, device="cpu").slabs.numpy()
    for sym in (False, True):
        one = pdia.run_index(np.abs(slabs[3:]) if sym else slabs, sym)
        D = slabs.shape[0] - (3 if sym else 0)
        none = pdia.run_index(np.zeros((D, 45)), sym)
        for other in (one, none):
            for a, b in zip(pdia.merge_run_index(one, other, D), one):
                assert a.dtype == np.int32
                np.testing.assert_array_equal(a, b)


# -- the packed run values -----------------------------------------------------

@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_packed_run_values_are_the_slab_values_the_runs_read(case):
    make, cls = INDEX_CASES[case]
    Ap, _ = make()
    plan = getattr(pmv, cls)(Ap, device="cpu")
    ra, index = _index_of(plan)
    runs = tuple(_t(a) for a in index)
    packed = pdia.pack_runs(plan.slabs, Ap.n, plan.omin, plan.symmetric, runs)
    assert len(packed) == (2 if plan.symmetric else 1)
    if plan.has_runs:  # what the plan keeps for its kernels
        for mine, again in zip(plan.run_values, packed):
            assert torch.equal(mine, again)
    else:
        assert plan.run_values is None
    S, (D, m) = pdia.RUN_ROWS, ra.shape
    for k, vals in enumerate(packed):
        ptr, diag = index[2 * k], index[2 * k + 1]
        assert vals.shape == (len(diag), S) and vals.dtype == plan.slabs.dtype
        want = np.zeros((len(diag), S))
        for g in range(len(ptr) - 1):
            for r in range(ptr[g], ptr[g + 1]):
                d = int(diag[r])
                for lane in range(S):
                    i = g * S + lane
                    if k == 0:  # forward: A[i, i + omin + d]
                        if i < m and 0 <= i + plan.omin + d < Ap.n:
                            want[r, lane] = ra[d, i]
                    elif i < m and i - d >= 0:  # mirror: A[i, i - d]
                        want[r, lane] = ra[d, i - d]
        np.testing.assert_array_equal(vals.numpy(), want)
    # every nonzero of the slabs is in the forward values exactly once
    assert np.count_nonzero(packed[0].numpy()) == np.count_nonzero(ra)
    # y from the packed values alone equals the dense plain product
    x = np.random.default_rng(26).standard_normal(Ap.n)
    y = np.zeros(m)
    for k, vals in enumerate(packed):
        ptr, diag = index[2 * k], index[2 * k + 1]
        g = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        rows = g[:, None] * S + np.arange(S)
        cols = rows - diag[:, None] if k else rows + plan.omin + diag[:, None]
        ok = (rows < m) & (cols >= 0) & (cols < Ap.n)
        np.add.at(y, rows[ok], vals.numpy()[ok] * x[cols[ok]])
    np.testing.assert_allclose(
        y, pdia.dia_spmv_plain(plan.slabs, _t(x[None]), plan.omin,
                               plan.symmetric)[0].numpy(),
        rtol=1e-12, atol=1e-12)


def test_packed_run_values_are_refused_without_or_against_their_index():
    Rp, _ = _diagonals(203, 203, [-40, -5, 0, 1, 5, 41], 19, 0.7)
    plan = pmv.DIAPlan(Rp, device="cpu")
    x = torch.zeros((1, 203), dtype=torch.float64)
    with pytest.raises(ValueError, match="need the occupancy index"):
        pdia.dia_spmv_cuda(plan.slabs, x, plan.omin, False, None,
                           plan.run_values)
    with pytest.raises(ValueError, match="packed run values"):
        pdia.dia_spmv_cuda(plan.slabs, x, plan.omin, False, plan.runs,
                           (plan.run_values[0][:-1],))
    with pytest.raises(ValueError, match="packed run values"):
        pdia.dia_spmv_cuda(plan.slabs, x, plan.omin, False, plan.runs,
                           (plan.run_values[0].float(),))
    with pytest.raises(ValueError, match="CUDA device"):
        pdia.dia_spmv_cuda(plan.slabs, x, plan.omin, False, plan.runs,
                           plan.run_values)
