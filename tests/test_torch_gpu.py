"""The port on a CUDA card: the band+points, DIA, triad, SpGEMM-numeric and
BSR SpMM kernels against their plain PyTorch versions, and the device
solvers against the same solves on the CPU.

Every test here needs a card and skips without one.  The file imports
neither jax nor the JAX package, so it runs where only torch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The kernel and the plain version both sum in float32, in different orders
(and the kernel contracts to FMA), so they are held to 5e-6 of max|y|.
The DIA kernel is held row by row to the rounding bound of its sums,
(k + 2) u (|A| |x|)_i for k stored diagonals, u the unit roundoff of the
dtype; the triad rounds like its plain version and must equal it bit for
bit.  The SpGEMM-numeric kernel is held output by output to (L + 1) u
sum|a||b| over the L products of the output, twice that between two
versions; the BSR kernel row by row to (K + 2) u (|A| |X|) for K stored
columns in the row's blocks.
"""

import numpy as np
import pytest
import torch

import scipy.sparse as sp

import csparse3_tpu_torch as pt
from csparse3_tpu_torch.kernels import bsr_spmm as kbsr
from csparse3_tpu_torch.kernels import dia as kdia
from csparse3_tpu_torch.kernels import spgemm as kspg
from csparse3_tpu_torch.models.grids import connectivity
from csparse3_tpu_torch.models.grids import (ieee14, rcm_grid, synthetic_grid,
                                             ybus)
from csparse3_tpu_torch.models.powerflow import (FastDecoupled,
                                                 NewtonPowerFlow,
                                                 dc_power_flow)
from csparse3_tpu_torch.utils import roofline

REL = 5e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _band(n):
    rows = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    vals = np.random.RandomState(6).rand(len(rows))
    return pt.from_triplets(rows, cols, vals, (n, n))


CASES = {
    "ybus1037": (lambda: ybus(synthetic_grid(1037, seed=3))[0],
                 dict(tile=128)),
    "groups900": (lambda: ybus(synthetic_grid(900, seed=9))[0],
                  dict(tile=128, group_span=40)),
    "band500": (lambda: _band(500), dict(tile=128)),
    "ybus20000": (lambda: ybus(synthetic_grid(20_000, seed=1))[0], {}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda, case):
    make, kw = CASES[case]
    Y = make()
    plan = pt.SplitBandPoints(Y, device=cuda, **kw)
    rng = np.random.RandomState(4)
    xr, xi = (torch.as_tensor(rng.rand(Y.n).astype(np.float32), device=cuda)
              for _ in range(2))
    yk = torch.stack(plan(xr, xi))
    torch.cuda.synchronize()
    assert plan.kernel_launches == plan.n_groups
    yp = torch.stack(plan.plain(xr, xi))
    assert plan.kernel_launches == plan.n_groups
    scale = yp.abs().max().item()
    assert (yk - yp).abs().max().item() <= REL * scale


@pytest.mark.gpu
def test_cuda_input_never_reaches_plain_version(cuda, monkeypatch):
    plan = pt.SplitBandPoints(ybus(synthetic_grid(1037, seed=3))[0],
                              device=cuda)

    def refuse(*a):
        raise AssertionError("plain version ran on a CUDA input")

    monkeypatch.setattr(plan, "plain", refuse)
    x = torch.rand(1037, device=cuda)
    for k in range(1, 4):
        plan(x, x)
        assert plan.kernel_launches == k
    with pytest.raises(ValueError, match="CUDA device"):
        plan(x.cpu(), x)


@pytest.mark.gpu
@pytest.mark.parametrize("spmv", ["ell", "bandpoints"])
def test_newton_on_cuda_matches_cpu(cuda, spmv):
    for g in (ieee14(), synthetic_grid(2000, seed=3)):
        tol = 5e-5 if spmv == "bandpoints" else 1e-10
        pf = NewtonPowerFlow(g, spmv=spmv, tol=tol, device=cuda)
        vm, va, it, res = pf.solve()
        vm_c, va_c, it_c, res_c = NewtonPowerFlow(g, spmv=spmv, tol=tol,
                                                  device="cpu").solve()
        assert res <= tol and res_c <= tol
        atol = 1e-5 if spmv == "bandpoints" else 1e-10
        np.testing.assert_allclose(vm, vm_c, rtol=0, atol=atol)
        np.testing.assert_allclose(va, va_c, rtol=0, atol=atol)
        if spmv == "bandpoints":
            assert pf._yplan.kernel_launches == it + 1


# -- K4: the DIA kernel ----------------------------------------------------------

def _offset_band(m, n, offs, seed):
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for o in offs:
        i = np.arange(max(0, -o), min(m, n - o))
        rows.append(i), cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return pt.from_triplets(rows, cols, rng.rand(len(rows)) - 0.5, (m, n))


def _rcm_ybus_real(n, seed, part):
    Y = ybus(rcm_grid(synthetic_grid(n, seed=seed))[0])[0]
    ip, ix, dt = Y.np_arrays()
    return pt.CSC(Y.m, Y.n, ip, ix, np.ascontiguousarray(getattr(dt, part)))


DIA_CASES = {
    "rcm_ybus_re": lambda: _rcm_ybus_real(3001, 2, "real"),
    "rcm_ybus_im": lambda: _rcm_ybus_real(1037, 3, "imag"),
    "above_diagonal": lambda: _offset_band(700, 900, [3, 4, 40], 5),  # omin>0
    "below_diagonal": lambda: _offset_band(900, 700, [-40, -4, -3], 6),
    "one_diagonal": lambda: _offset_band(257, 257, [0], 7),
}


def _dia_bound(plan, x2):
    """Row-wise bound on |kernel - plain|: each is a float sum of the same
    <= D products (plus the mirror's for the symmetric form)."""
    u = torch.finfo(plan.slabs.dtype).eps / 2
    ax = kdia.dia_spmv_plain(plan.slabs.abs().double(), x2.abs().double(),
                             plan.omin, plan.symmetric)
    terms = plan.ndiag * (2 if plan.symmetric else 1)
    return 2 * (terms + 2) * u * ax + torch.finfo(plan.slabs.dtype).tiny


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_kernel_matches_plain(cuda, case, dtype, B):
    a = DIA_CASES[case]()
    ip, ix, dt = a.np_arrays()
    plan = pt.DIAPlan(pt.CSC(a.m, a.n, ip, ix, dt.astype(dtype)), device=cuda)
    x = torch.as_tensor(np.random.RandomState(8).rand(a.n, B).astype(dtype),
                        device=cuda)
    before = kdia.LAUNCHES["dia_spmv"]
    yk = plan(x)
    torch.cuda.synchronize()
    assert kdia.LAUNCHES["dia_spmv"] - before == (B + 1) // 2
    yp = plan.plain(x)
    assert kdia.LAUNCHES["dia_spmv"] - before == (B + 1) // 2
    assert yk.shape == yp.shape == (a.m, B) and yk.dtype == yp.dtype
    assert ((yk - yp).abs().T <= _dia_bound(plan, x.T)).all()
    # and against scipy in float64 on the host, relative to max|y|
    ref = a.to_scipy() @ x.double().cpu().numpy()
    rel = 1e-12 if dtype == np.float64 else REL
    assert np.abs(yk.cpu().numpy() - ref).max() <= rel * np.abs(ref).max()
    # the (n,) form
    y1 = plan(x[:, 0].contiguous())
    assert torch.equal(y1, yk[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["rcm_ybus_re", "rcm_ybus_im",
                                  "one_diagonal"])
def test_symmetric_dia_kernel_matches_plain_and_general(cuda, case, dtype, B):
    a = DIA_CASES[case]()
    ip, ix, dt = a.np_arrays()
    a = pt.CSC(a.m, a.n, ip, ix, dt.astype(dtype))
    tol = 1e-12 if dtype == np.float64 else 1e-6
    sym = pt.SymDIAPlan(a, tol=tol, device=cuda)
    gen = pt.DIAPlan(a, device=cuda)
    assert sym.ndiag == (gen.ndiag + 1) // 2
    x = torch.as_tensor(np.random.RandomState(9).rand(a.n, B).astype(dtype),
                        device=cuda)
    before = kdia.LAUNCHES["dia_spmv"]
    ys = sym(x)
    torch.cuda.synchronize()
    assert kdia.LAUNCHES["dia_spmv"] - before == 1
    bound = _dia_bound(sym, x.T)
    assert ((ys - sym.plain(x)).abs().T <= bound).all()
    assert ((ys - gen(x)).abs().T <= 2 * bound).all()


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["SplitDIA", "SplitSymDIA", "SplitCudaDIA"])
def test_split_dia_on_cuda_matches_scipy(cuda, plan):
    Y = ybus(rcm_grid(synthetic_grid(3001, seed=2))[0])[0]
    kw = dict(tol=1e-12) if plan == "SplitSymDIA" else {}
    p = getattr(pt, plan)(Y, device=cuda, **kw)
    rng = np.random.RandomState(10)
    xr, xi = rng.rand(Y.n), rng.rand(Y.n)
    before = kdia.LAUNCHES["dia_spmv"]
    yr, yi = p(torch.as_tensor(xr, device=cuda),
               torch.as_tensor(xi, device=cuda))
    torch.cuda.synchronize()
    assert kdia.LAUNCHES["dia_spmv"] - before == 2  # one per real slab set
    z = Y.to_scipy() @ (xr + 1j * xi)
    f32 = plan == "SplitCudaDIA"
    assert yr.dtype == (torch.float32 if f32 else torch.float64)
    rel = REL if f32 else 1e-12
    got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
    assert np.abs(got - z).max() <= rel * np.abs(z).max()


@pytest.mark.gpu
def test_dia_cuda_input_never_reaches_plain_version(cuda, monkeypatch):
    plan = pt.DIAPlan(_rcm_ybus_real(1037, 3, "real"), device=cuda)

    def refuse(*a, **k):
        raise AssertionError("plain version ran on a CUDA input")

    monkeypatch.setattr(kdia, "dia_spmv_plain", refuse)
    x = torch.rand(1037, device=cuda, dtype=torch.float64)
    before = kdia.LAUNCHES["dia_spmv"]
    plan(x)
    assert kdia.LAUNCHES["dia_spmv"] == before + 1
    with pytest.raises(ValueError, match="CUDA device"):
        plan(x.cpu())  # slabs on the card, x on the CPU: no fallback
    with pytest.raises(TypeError, match="float64"):
        pt.DIAPlan(_offset_band(64, 64, [0, 1], 1).to(cuda),
                   device=cuda).float()(x[:64])


# -- K6: the SpGEMM numeric kernel ---------------------------------------------

def _hub_matrix(dtype):
    """300 x 200 at 3% density plus one dense-ish column (long segments)."""
    rng = np.random.RandomState(7)
    a = sp.random(300, 200, density=0.03, format="csc", random_state=rng)
    a = (a + sp.csc_matrix(
        (rng.rand(60), (rng.permutation(300)[:60], np.full(60, 5))),
        shape=(300, 200))).tocsc()
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * a.multiply(a)
    return pt.CSC.from_scipy(a.astype(dtype))


def _conn(n):
    Cf, Ct = connectivity(synthetic_grid(n, seed=1))
    return Cf - Ct


SPGEMM_CASES = {"hub": _hub_matrix,
                "conn3000": lambda dt: pt.CSC.from_scipy(
                    _conn(3000).to_scipy().astype(dt))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("case", sorted(SPGEMM_CASES))
def test_spgemm_numeric_kernel_matches_plain_and_scipy(cuda, case, dtype):
    A = SPGEMM_CASES[case](dtype)
    B = A.T
    plan = pt.spgemm_symbolic(A, B)  # device=None: the card
    assert plan.device.type == "cuda"
    av = torch.as_tensor(A.np_arrays()[2], device=cuda)
    bv = torch.as_tensor(B.np_arrays()[2], device=cuda)
    before = kspg.LAUNCHES["spgemm_numeric"]
    C = plan.numeric(av, bv)
    torch.cuda.synchronize()
    assert kspg.LAUNCHES["spgemm_numeric"] == before + 1
    plain = kspg.spgemm_numeric_plain(plan.gid, plan.pa_s, plan.pb_s, av, bv,
                                      plan.out_nnz)
    assert kspg.LAUNCHES["spgemm_numeric"] == before + 1
    assert C.data.dtype == plain.dtype == av.dtype
    # per output: L products, each rounded, summed in some order
    absum = kspg.spgemm_numeric_plain(plan.gid, plan.pa_s, plan.pb_s,
                                      av.abs().double(), bv.abs().double(),
                                      plan.out_nnz)
    L = plan.seg_ptr.diff().double()
    u = torch.finfo(av.dtype).eps / 2 * (4 if av.dtype.is_complex else 1)
    bound = (L + 1) * u * absum
    assert ((C.data - plain).abs() <= 2 * bound).all()
    sa = A.to_scipy().astype(np.complex128 if av.dtype.is_complex
                             else np.float64)
    ref = (sa @ sa.T).tocsc()
    ref.sort_indices()
    ip, ix, dt = C.np_arrays()
    np.testing.assert_array_equal(ip, ref.indptr)
    np.testing.assert_array_equal(ix, ref.indices)
    assert (np.abs(dt - ref.data) <= bound.cpu().numpy()
            + np.finfo(np.float64).tiny).all()


@pytest.mark.gpu
def test_gram_plan_and_integer_route_on_cuda(cuda):
    C = _conn(3000)
    ref = (C.to_scipy() @ C.to_scipy().T).tocsc()
    ref.sort_indices()
    gp = pt.gram_symbolic(C)
    before = kspg.LAUNCHES["spgemm_numeric"]
    G = gp.numeric(C.np_arrays()[2])
    assert kspg.LAUNCHES["spgemm_numeric"] == before + 1
    assert G.data.is_cuda
    np.testing.assert_array_equal(G.np_arrays()[1], ref.indices)
    np.testing.assert_allclose(G.np_arrays()[2], ref.data, rtol=0,
                               atol=1e-12)
    # integer values take the torch route on the card: exact, no launch
    plan = pt.spgemm_symbolic(C, C.T)
    ai = torch.as_tensor(C.np_arrays()[2].astype(np.int64), device=cuda)
    bi = torch.as_tensor(C.T.np_arrays()[2].astype(np.int64), device=cuda)
    Ci = plan.numeric(ai, bi)
    assert kspg.LAUNCHES["spgemm_numeric"] == before + 1
    assert Ci.data.dtype == torch.int64
    np.testing.assert_array_equal(Ci.np_arrays()[2], ref.data.astype(np.int64))
    # the device ESC product and the empty plan
    D = pt.spgemm_device(C, C.T)
    np.testing.assert_array_equal(D.np_arrays()[1], ref.indices)
    np.testing.assert_allclose(D.np_arrays()[2], ref.data, rtol=0, atol=1e-12)
    Z = pt.from_triplets([], [], np.zeros(0), (5, 7))
    empty = pt.spgemm_symbolic(Z, Z.T).numeric(torch.zeros(0, device=cuda),
                                               torch.zeros(0, device=cuda))
    assert empty.nnz == 0 and kspg.LAUNCHES["spgemm_numeric"] == before + 1


@pytest.mark.gpu
def test_spgemm_cuda_input_never_reaches_plain_version(cuda, monkeypatch):
    A = _hub_matrix(np.float32)
    plan = pt.spgemm_symbolic(A, A.T)

    def refuse(*a, **k):
        raise AssertionError("plain version ran on a CUDA input")

    monkeypatch.setattr(kspg, "spgemm_numeric_plain", refuse)
    av = torch.as_tensor(A.np_arrays()[2], device=cuda)
    bv = torch.as_tensor(A.T.np_arrays()[2], device=cuda)
    before = kspg.LAUNCHES["spgemm_numeric"]
    plan.numeric(av, bv)
    assert kspg.LAUNCHES["spgemm_numeric"] == before + 1
    with pytest.raises(ValueError, match="CUDA device"):
        plan.numeric(av.cpu(), bv)  # maps on the card: no fallback
    with pytest.raises(TypeError, match="int32"):
        kspg.spgemm_numeric_cuda(plan.seg_ptr.long(), plan.pa_s, plan.pb_s,
                                 av, bv)


# -- K5: the BSR SpMM kernel -----------------------------------------------------

def _rand_csc(m, n, density, seed, dtype):
    a = sp.random(m, n, density=density, format="csc",
                  random_state=np.random.RandomState(seed))
    return pt.CSC.from_scipy(a.astype(dtype))


def _diag100(dtype):  # rows 100..300 empty: empty block rows
    i = np.arange(100)
    return pt.from_triplets(i, i, np.ones(100, dtype=dtype), (300, 300))


BSR_CASES = {
    "rect_8x128": (lambda dt: _rand_csc(300, 260, 0.03, 0, dt), (8, 128)),
    "ragged_8x128": (lambda dt: _rand_csc(100, 90, 0.05, 2, dt), (8, 128)),
    "empty_rows_8x128": (_diag100, (8, 128)),
    "square_32x32": (lambda dt: _rand_csc(1000, 1000, 0.01, 3, dt), (32, 32)),
    "tall_blocks_20x3": (lambda dt: _rand_csc(333, 217, 0.05, 4, dt), (20, 3)),
    "wide_blocks_3x300": (lambda dt: _rand_csc(333, 1217, 0.02, 5, dt),
                          (3, 300)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("k", [None, 1, 37, 130, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_bsr_spmm_kernel_matches_plain_and_scipy(cuda, case, dtype, k):
    make, block = BSR_CASES[case]
    A = make(dtype)
    B = A.to_bsr(block=block).to(cuda)
    rng = np.random.RandomState(8)
    X = rng.rand(A.n).astype(dtype) if k is None else \
        rng.rand(A.n, k).astype(dtype)
    Xt = torch.as_tensor(X, device=cuda)
    before = kbsr.LAUNCHES["bsr_spmm"]
    Y = B @ Xt
    torch.cuda.synchronize()
    assert kbsr.LAUNCHES["bsr_spmm"] == before + 1
    nb = B.nnz_blocks
    Yp = kbsr.bsr_spmm_plain(B.m, B.n, B.indptr, B.indices[:nb], B.data[:nb],
                             Xt)
    assert kbsr.LAUNCHES["bsr_spmm"] == before + 1
    assert Y.shape == Yp.shape == (A.m,) + X.shape[1:] and Y.dtype == Yp.dtype
    S = A.to_scipy().astype(np.float64)
    ref = S @ X.astype(np.float64)
    # row i sums its stored nonzeros (the blocks' zeros add exactly)
    K = int(np.diff(S.tocsr().indptr).max())
    u = np.finfo(dtype).eps / 2
    bound = (K + 2) * u * (abs(S) @ np.abs(X).astype(np.float64)) \
        + np.finfo(np.float64).tiny
    assert (np.abs(Y.cpu().numpy() - ref) <= bound).all()
    assert (np.abs((Y - Yp).cpu().numpy()) <= 2 * bound).all()
    if case == "empty_rows_8x128":
        assert (Y[100:] == 0).all()


@pytest.mark.gpu
def test_spmm_block_route_and_int64_indices_on_cuda(cuda, monkeypatch):
    A = _rand_csc(500, 400, 0.02, 9, np.float32)
    X = np.random.RandomState(10).rand(400, 70).astype(np.float32)
    ref = A.to_scipy().astype(np.float64) @ X
    before = kbsr.LAUNCHES["bsr_spmm"]
    Y = pt.spmm(A, X, block=(8, 128))  # device=None: the card
    assert Y.is_cuda and kbsr.LAUNCHES["bsr_spmm"] == before + 1
    assert A._bsr_cache.data.is_cuda
    np.testing.assert_allclose(Y.cpu().numpy(), ref, rtol=1e-5, atol=1e-5)
    Y2 = pt.spmm(A, X)  # the entry-stream product: no launch
    assert kbsr.LAUNCHES["bsr_spmm"] == before + 1
    np.testing.assert_allclose(Y2.cpu().numpy(), ref, rtol=1e-5, atol=1e-5)
    B = A._bsr_cache
    Y3 = kbsr.bsr_spmm(B.m, B.n, B.indptr.long(), B.indices.long(), B.data,
                       torch.as_tensor(X, device=cuda))
    assert torch.equal(Y3, Y)

    def refuse(*a, **k):
        raise AssertionError("plain version ran on a CUDA input")

    monkeypatch.setattr(kbsr, "bsr_spmm_plain", refuse)
    B @ torch.as_tensor(X, device=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        kbsr.bsr_spmm(B.m, B.n, B.indptr, B.indices, B.data,
                      torch.as_tensor(X))
    with pytest.raises(TypeError, match="float32 or float64"):
        kbsr.bsr_spmm(B.m, B.n, B.indptr, B.indices, B.data.half(),
                      torch.as_tensor(X, device=cuda))


@pytest.mark.gpu
def test_bsr_block_ops_on_cuda_match_scipy(cuda):
    A = _rand_csc(256, 256, 0.03, 11, np.float32)
    B = A.to_bsr(block=(32, 32)).to(cuda)
    S = A.to_scipy().astype(np.float64)
    C = B @ B
    assert C.data.is_cuda
    np.testing.assert_allclose(C.todense().cpu().numpy(), (S @ S).toarray(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(B.t().todense().cpu().numpy(),
                                  S.T.toarray().astype(np.float32))
    np.testing.assert_allclose((B + B.t()).todense().cpu().numpy(),
                               (S + S.T).toarray(), rtol=1e-6, atol=1e-6)


# -- K7: the triad -----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 1023, 256 * 512, 4 * 132 * 16 * 256 * 5 + 7])
def test_triad_kernel_equals_plain(cuda, n):
    a = torch.as_tensor(np.random.RandomState(11).rand(n).astype(np.float32),
                        device=cuda)
    s = torch.full((1,), 1.2345678, dtype=torch.float32, device=cuda)
    before = roofline.LAUNCHES["triad"]
    o = roofline.triad(a, s)
    torch.cuda.synchronize()
    assert roofline.LAUNCHES["triad"] == before + 1
    assert torch.equal(o, roofline.triad_plain(a, s))
    with pytest.raises(TypeError, match="float32"):
        roofline.triad(a.double(), s)
    with pytest.raises(ValueError, match="CUDA device"):
        roofline.triad(a, s.cpu())


@pytest.mark.gpu
def test_measure_hbm_bw_is_a_plausible_device_rate(cuda):
    bw = roofline.measure_hbm_bw(mb=256, reps=5, trials=2)
    assert 0.2e12 < bw < 5e12


# -- the banded solvers on the card ----------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("spmv", ["dia", "symdia"])
def test_banded_solvers_on_cuda_match_cpu(cuda, spmv):
    g = rcm_grid(synthetic_grid(2000, seed=3))[0]
    before = kdia.LAUNCHES["dia_spmv"]
    vm, va, it, res = FastDecoupled(g, spmv=spmv).solve()  # device=None
    # two mismatches per iteration, one residual per check, one final
    assert kdia.LAUNCHES["dia_spmv"] - before == 2 * (2 * it + it + 1 + 1)
    vm_c, va_c, it_c, res_c = FastDecoupled(g, spmv=spmv,
                                            device="cpu").solve()
    assert it == it_c and res <= 1e-8
    np.testing.assert_allclose(vm, vm_c, rtol=0, atol=1e-8)
    np.testing.assert_allclose(va, va_c, rtol=0, atol=1e-8)
    before = kdia.LAUNCHES["dia_spmv"]
    vm_n, va_n, it_n, res_n = NewtonPowerFlow(g, spmv=spmv,
                                              device=cuda).solve()
    assert kdia.LAUNCHES["dia_spmv"] - before == 2 * (it_n + 1)
    assert res_n <= 1e-10
    np.testing.assert_allclose(vm, vm_n, rtol=0, atol=1e-7)
    np.testing.assert_allclose(dc_power_flow(g),
                               dc_power_flow(g, device="cpu"), rtol=0,
                               atol=1e-10)
