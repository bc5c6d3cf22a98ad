"""The port on a CUDA card: the band+points, DIA, triad, SpGEMM-numeric and
BSR SpMM kernels against their plain PyTorch versions, the device solvers
against the same solves on the CPU, and the supernodal / multifrontal
fronts (torch ops, no kernel of ours) against the CPU, the host factors
and scipy.

Every test here needs a card and skips without one.  The file imports
neither jax nor the JAX package, so it runs where only torch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The kernel and the plain version both sum in float32, in different orders
(and the kernel contracts to FMA), so they are held to 5e-6 of max|y|.
The DIA kernel is held row by row to the rounding bound of its sums,
(k + 2) u (|A| |x|)_i for k stored diagonals, u the unit roundoff of the
dtype; the triad rounds like its plain version and must equal it bit for
bit.  The DIA run kernel (the one that walks a plan's occupancy index) and
the BSR kernel with column lists are held to the same bounds, against the
dense plain version and against the plain version that walks the same
index, and two launches on one input must agree bit for bit.  The
SpGEMM-numeric kernel is held output by output to (L + 1) u
sum|a||b| over the L products of the output, twice that between two
versions; the BSR kernel row by row to (K + 2) u (|A| |X|) for K stored
columns in the row's blocks.
"""

import functools

import numpy as np
import pytest
import torch

import scipy.sparse as sp

import csparse3_tpu_torch as pt
from csparse3_tpu_torch.kernels import bandpoints as kbp
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
    assert plan.kernel_launches == 1  # whatever the number of groups
    yp = torch.stack(plan.plain(xr, xi))
    assert plan.kernel_launches == 1
    scale = yp.abs().max().item()
    assert (yk - yp).abs().max().item() <= REL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,span", [(900, 40), (900, 100), (20_000, 512)])
def test_grouped_plan_is_one_launch_equal_to_default(cuda, n, span):
    """The offset groups ride in the one launch over their joined lists,
    which are the default plan's: the same bits."""
    Y = ybus(synthetic_grid(n, seed=9))[0]
    grouped = pt.SplitBandPoints(Y, group_span=span, device=cuda)
    default = pt.SplitBandPoints(Y, device=cuda)
    assert grouped.n_groups >= 2
    rng = np.random.RandomState(5)
    xr, xi = (torch.as_tensor(rng.rand(n).astype(np.float32), device=cuda)
              for _ in range(2))
    for k in range(1, 3):
        yg, yd = grouped(xr, xi), default(xr, xi)
        assert grouped.kernel_launches == k
        assert torch.equal(yg[0], yd[0]) and torch.equal(yg[1], yd[1])
    yp = torch.stack(grouped.plain(xr, xi))
    assert grouped.kernel_launches == 2
    assert (torch.stack(yg) - yp).abs().max().item() \
        <= REL * yp.abs().max().item()


@pytest.mark.gpu
def test_cuda_input_never_reaches_plain_version(cuda, monkeypatch):
    Y = ybus(synthetic_grid(1037, seed=3))[0]

    def refuse(*a):
        raise AssertionError("plain version ran on a CUDA input")

    x = torch.rand(1037, device=cuda)
    for kw in ({}, dict(group_span=40)):
        plan = pt.SplitBandPoints(Y, device=cuda, **kw)
        monkeypatch.setattr(plan, "plain", refuse)
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


@functools.lru_cache(maxsize=None)  # read-only in every test
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
    before = dict(kdia.LAUNCHES)
    yr, yi = p(torch.as_tensor(xr, device=cuda),
               torch.as_tensor(xi, device=cuda))
    torch.cuda.synchronize()
    # one launch walks the shared index over both real slab sets
    assert p.shared_runs
    assert all(kdia.LAUNCHES[k] - before[k] == 1 for k in before)
    z = Y.to_scipy() @ (xr + 1j * xi)
    f32 = plan == "SplitCudaDIA"
    assert yr.dtype == (torch.float32 if f32 else torch.float64)
    rel = REL if f32 else 1e-12
    got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
    assert np.abs(got - z).max() <= rel * np.abs(z).max()


@pytest.mark.gpu
def test_dia_cuda_input_never_reaches_plain_version(cuda, monkeypatch):
    plan = pt.DIAPlan(_rcm_ybus_real(1037, 3, "real"), device=cuda)
    dense = pt.DIAPlan(_band(1037), device=cuda)  # tridiagonal: no index
    assert plan.has_runs and all(t.is_cuda for t in plan.runs)
    assert not dense.has_runs

    def refuse(*a, **k):
        raise AssertionError("plain version ran on a CUDA input")

    monkeypatch.setattr(kdia, "dia_spmv_plain", refuse)
    monkeypatch.setattr(kdia, "dia_spmv_runs_plain", refuse)
    x = torch.rand(1037, device=cuda, dtype=torch.float64)
    before = dict(kdia.LAUNCHES)
    plan(x)
    assert kdia.LAUNCHES["dia_spmv"] == before["dia_spmv"] + 1
    assert kdia.LAUNCHES["dia_spmv_runs"] == before["dia_spmv_runs"] + 1
    dense(x)  # the dense kernel: counted, not as a walk of an index
    assert kdia.LAUNCHES["dia_spmv"] == before["dia_spmv"] + 2
    assert kdia.LAUNCHES["dia_spmv_runs"] == before["dia_spmv_runs"] + 1
    with pytest.raises(ValueError, match="CUDA device"):
        kdia.band_spmv(plan.slabs, x[None], plan.omin, False,
                       tuple(t.cpu() for t in plan.runs), plan.run_values)
    with pytest.raises(ValueError, match="together with the run values"):
        kdia.band_spmv(plan.slabs, x[None], plan.omin, False, plan.runs)
    with pytest.raises(ValueError, match="CUDA device"):
        plan(x.cpu())  # slabs on the card, x on the CPU: no fallback
    split = pt.SplitDIA(ybus(rcm_grid(synthetic_grid(1037, seed=3))[0])[0],
                        device=cuda)
    assert split.shared_runs
    before = dict(kdia.LAUNCHES)
    split(x, x)
    assert all(kdia.LAUNCHES[k] == before[k] + 1 for k in before)
    with pytest.raises(ValueError, match="CUDA device"):
        split(x.cpu(), x.cpu())
    with pytest.raises(TypeError, match="one dtype"):
        split.float()(x, x)
    with pytest.raises(TypeError, match="float64"):
        pt.DIAPlan(_offset_band(64, 64, [0, 1], 1).to(cuda),
                   device=cuda).float()(x[:64])


# (case, symmetric form): small matrices split a group's list over eight
# lane-sets, 20k rows over four, 40k rows over two
RUN_CASES = [("rcm_ybus_re", False), ("rcm_ybus_re", True),
             ("rcm_ybus_im", False), ("rcm_ybus_im", True),
             ("above_diagonal", False), ("below_diagonal", False),
             ("one_diagonal", False), ("one_diagonal", True),
             ("rcm_ybus_20k", False), ("rcm_ybus_20k", True),
             ("rcm_ybus_40k", False), ("rcm_ybus_40k", True),
             ("rcm_ybus_70k", False), ("rcm_ybus_70k", True)]
RUN_MATRICES = dict(
    DIA_CASES,
    rcm_ybus_20k=lambda: _rcm_ybus_real(20_001, 4, "imag"),
    rcm_ybus_40k=lambda: _rcm_ybus_real(40_003, 5, "real"),
    # 70k rows and more: one lane-set per group
    rcm_ybus_70k=lambda: _rcm_ybus_real(70_001, 7, "imag"))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case,sym", RUN_CASES)
def test_dia_run_kernel_matches_plain_versions_and_repeats(cuda, case, sym,
                                                           dtype, B):
    a = RUN_MATRICES[case]()
    ip, ix, dt = a.np_arrays()
    a = pt.CSC(a.m, a.n, ip, ix, dt.astype(dtype))
    plan = (pt.SymDIAPlan(a, tol=1e-12 if dtype == np.float64 else 1e-6,
                          device=cuda) if sym else pt.DIAPlan(a, device=cuda))
    # the index of these slabs, whether or not the plan's rule kept one
    runs = tuple(torch.as_tensor(t, device=cuda) for t in kdia.run_index(
        plan.slabs.cpu().numpy(), sym))
    x = torch.as_tensor(np.random.RandomState(12).rand(B, a.n).astype(dtype),
                        device=cuda)
    # and the values it lists, packed in its order: what the kernel streams
    vals = kdia.pack_runs(plan.slabs, a.n, plan.omin, sym, runs)
    assert all(v.is_cuda for v in vals)
    before = dict(kdia.LAUNCHES)
    yk = kdia.band_spmv(plan.slabs, x, plan.omin, sym, runs, vals)
    torch.cuda.synchronize()
    for key in ("dia_spmv", "dia_spmv_runs"):
        assert kdia.LAUNCHES[key] - before[key] == (B + 1) // 2
    assert kdia.LAUNCHES["dia_spmv_split"] == before["dia_spmv_split"]
    dense = kdia.dia_spmv_plain(plan.slabs, x, plan.omin, sym)
    walked = kdia.dia_spmv_runs_plain(plan.slabs, x, plan.omin, sym, runs)
    for key in ("dia_spmv", "dia_spmv_runs"):
        assert kdia.LAUNCHES[key] - before[key] == (B + 1) // 2
    assert kdia.LAUNCHES["dia_spmv_split"] == before["dia_spmv_split"]
    assert yk.shape == dense.shape == (B, a.m) and yk.dtype == dense.dtype
    bound = _dia_bound(plan, x)
    assert ((yk - dense).abs() <= bound).all()
    assert ((yk - walked).abs() <= bound).all()
    ref = (a.to_scipy() @ x.double().cpu().numpy().T).T
    rel = 1e-12 if dtype == np.float64 else REL
    assert np.abs(yk.cpu().numpy() - ref).max() <= rel * np.abs(ref).max()
    # a fixed order of summation: the same bits at every launch
    assert torch.equal(
        kdia.band_spmv(plan.slabs, x, plan.omin, sym, runs, vals), yk)
    if plan.has_runs:  # and it is what the plan itself launches
        assert torch.equal(plan.apply_bn(x), yk)


def _complex_band(n, seed, dtype):
    """RCM-ordered Ybus whose parts differ in pattern: every seventh stored
    value (by its lower bus) is purely real, every eleventh purely
    imaginary, symmetrically."""
    Y = ybus(rcm_grid(synthetic_grid(n, seed=seed))[0])[0]
    ip, ix, dt = Y.np_arrays()
    cols = np.repeat(np.arange(Y.n), np.diff(ip))
    lo = np.minimum(ix, cols)
    dt = np.where(lo % 7 == 0, dt.real, np.where(lo % 11 == 0, 1j * dt.imag,
                                                  dt))
    return pt.CSC(Y.m, Y.n, ip, ix, dt.astype(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("n", [1037, 20_001, 40_003])
@pytest.mark.parametrize("plan", ["SplitDIA", "SplitSymDIA"])
def test_split_run_kernel_matches_plain_versions_and_repeats(cuda, plan, n,
                                                             dtype):
    Y = _complex_band(n, 6, dtype)
    f32 = dtype == np.complex64
    kw = dict(tol=1e-6 if f32 else 1e-12) if plan == "SplitSymDIA" else {}
    p = getattr(pt, plan)(Y, device=cuda, **kw)
    assert p.shared_runs and p.re.runs[1] is p.im.runs[1]
    real = np.float32 if f32 else np.float64
    rng = np.random.RandomState(14)
    xr, xi = (torch.as_tensor(rng.rand(n).astype(real), device=cuda)
              for _ in range(2))
    before = dict(kdia.LAUNCHES)
    yr, yi = p(xr, xi)
    torch.cuda.synchronize()
    assert all(kdia.LAUNCHES[k] - before[k] == 1 for k in before)
    two = kdia.split_complex_apply(p.re.apply_bn, p.im.apply_bn, xr, xi)
    assert kdia.LAUNCHES["dia_spmv_split"] - before["dia_spmv_split"] == 1
    assert kdia.LAUNCHES["dia_spmv_runs"] - before["dia_spmv_runs"] == 3
    again = p(xr, xi)
    assert torch.equal(again[0], yr) and torch.equal(again[1], yi)
    # the launch the plan makes, on the packed run values of its two parts
    xn2 = torch.stack([xr, xi], dim=1)
    y = kdia.dia_split_cuda(p.re.slabs, p.im.slabs, xn2, p.re.omin,
                            p.re.symmetric, p.re.runs,
                            (p.re.run_values, p.im.run_values))
    assert torch.equal(y[0], yr) and torch.equal(y[1], yi)
    # one launch per slab set (the same sums, folded over the lanes in
    # another order where the two kernels split the lists differently), the
    # plain walk of the index, and the dense plain version, row by row
    x2 = torch.stack([xr, xi])
    for ref in (two, p.plain(xr, xi), kdia.split_complex_apply(
            *(functools.partial(kdia.dia_spmv_plain, q.slabs, omin=q.omin,
                                symmetric=q.symmetric)
              for q in (p.re, p.im)), xr, xi)):
        bound = sum(_dia_bound(q, x2).sum(0) for q in (p.re, p.im))
        for got, want in zip((yr, yi), ref):
            assert ((got - want).abs() <= bound).all()
    z = Y.to_scipy().astype(np.complex128) @ (
        xr.double().cpu().numpy() + 1j * xi.double().cpu().numpy())
    got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
    assert np.abs(got - z).max() <= (REL if f32 else 1e-12) * np.abs(z).max()
    # a view of x that starts between two pairs is copied, not refused
    flat = torch.zeros(2 * n + 1, dtype=xr.dtype, device=cuda)
    xn2 = flat[1:].view(n, 2).copy_(torch.stack([xr, xi], dim=1))
    y = kdia.dia_split_cuda(p.re.slabs, p.im.slabs, xn2, p.re.omin,
                            p.re.symmetric, p.re.runs,
                            (p.re.run_values, p.im.run_values))
    assert torch.equal(y[0], yr) and torch.equal(y[1], yi)


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


def _dense_row_matrix(dtype):
    """600 x 3000 at 0.2% density plus one dense row: the diagonal output
    of that row in A @ A.T is one segment of 3000 products, more than one
    chunk of the kernel's staging."""
    rng = np.random.RandomState(11)
    a = sp.random(600, 3000, density=2e-3, format="csc", random_state=rng)
    a = (a + sp.csc_matrix((rng.rand(3000), (np.full(3000, 17),
                                              np.arange(3000))),
                           shape=a.shape)).tocsc()
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * a.multiply(a)
    return pt.CSC.from_scipy(a.astype(dtype))


SPGEMM_CASES = {"hub": _hub_matrix,
                "dense_row": _dense_row_matrix,
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


def _segment_maps(out_nnz, seed, hubs=()):
    """A product stream of ``out_nnz`` outputs with 0 to 3 products each
    (empty segments included), ``hubs`` = {output: products} on top: int32
    seg_ptr, pa, pb and gid as a symbolic phase lays them out."""
    rng = np.random.RandomState(seed)
    lengths = rng.choice([0, 1, 1, 1, 1, 1, 2, 3], out_nnz)
    for o, L in hubs:
        lengths[o] = L
    seg_ptr = np.zeros(out_nnz + 1, dtype=np.int32)
    seg_ptr[1:] = np.cumsum(lengths)
    P = int(seg_ptr[-1])
    gid = np.repeat(np.arange(out_nnz, dtype=np.int32), lengths)
    return (seg_ptr, rng.randint(0, 5000, P).astype(np.int32),
            rng.randint(0, 7000, P).astype(np.int32), gid)


def _values(n, dtype, seed):
    rng = np.random.RandomState(seed)
    v = rng.rand(n) - 0.5
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * (rng.rand(n) - 0.5)
    return v.astype(dtype)


# the kernel's tiles are 256 x V outputs, V by the source's size rule: 1
# below 134,657 outputs, then 2.  Sizes at each tile edge:
SEGMENT_SIZES = [(0, 1), (1, 1), (255, 1), (256, 1), (257, 1),
                 (134_655, 1), (134_657, 2), (135_167, 2), (135_168, 2),
                 (135_169, 2), (270_337, 2)]


# hub outputs, longer than anything else in their tile, next to outputs of
# one product; the last output of the 2-output plan is its last tile's only
# one
HUBS = {"hubs": (3000, ((17, 5000), (18, 1), (700, 2100))),
        "hubs2": (270_337, ((5, 3000), (100_000, 1600), (270_336, 2000)))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("out_nnz,V", SEGMENT_SIZES + [("hubs", 1),
                                                       ("hubs2", 2)])
def test_spgemm_numeric_kernel_tiles_match_plain_and_repeat(cuda, out_nnz, V,
                                                            dtype):
    """The kernel on product streams cut at every tile edge, and on hub
    outputs of thousands of products: within the per-output bound of the
    plain version and of a wider sum, bit-equal on a second launch."""
    if out_nnz in HUBS:
        out_nnz, hubs = HUBS[out_nnz]
        maps = _segment_maps(out_nnz, 3, hubs)
    else:
        maps = _segment_maps(out_nnz, out_nnz % 97)
    if out_nnz:
        assert kspg.outputs_per_thread(out_nnz) == V
    seg_ptr, pa, pb, gid = (torch.as_tensor(m, device=cuda) for m in maps)
    av = torch.as_tensor(_values(5000, dtype, 1), device=cuda)
    bv = torch.as_tensor(_values(7000, dtype, 2), device=cuda)
    before = kspg.LAUNCHES["spgemm_numeric"]
    got = kspg.spgemm_numeric_cuda(seg_ptr, pa, pb, av, bv)
    again = kspg.spgemm_numeric_cuda(seg_ptr, pa, pb, av, bv)
    torch.cuda.synchronize()
    assert kspg.LAUNCHES["spgemm_numeric"] == before + 2 * (out_nnz > 0)
    assert got.shape == (out_nnz,) and got.dtype == av.dtype
    assert torch.equal(got, again)
    plain = kspg.spgemm_numeric_plain(gid, pa, pb, av, bv, out_nnz)
    wide = torch.complex128 if av.dtype.is_complex else torch.float64
    exact = kspg.spgemm_numeric_plain(gid, pa, pb, av.to(wide), bv.to(wide),
                                      out_nnz)
    absum = kspg.spgemm_numeric_plain(gid, pa, pb, av.abs().double(),
                                      bv.abs().double(), out_nnz)
    L = seg_ptr.diff().double()
    u = torch.finfo(av.dtype).eps / 2 * (4 if av.dtype.is_complex else 1)
    bound = (L + 1) * u * absum
    assert ((got - plain).abs() <= 2 * bound).all()
    # a sum in the wider type is exact to the bound's scale; in the same
    # type it rounds like the kernel: two versions within twice the bound
    k = 2 if wide == av.dtype else 1
    assert ((got.to(wide) - exact).abs() <= k * bound).all()
    assert (got[L == 0] == 0).all()


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
    # a stream of 2-output tiles and one with a hub, through the dispatcher
    for n_out, hubs in ((270_337, ()), (3000, ((17, 5000),))):
        seg_ptr, pa, pb, gid = (torch.as_tensor(m, device=cuda) for m in
                                _segment_maps(n_out, 4, hubs))
        a = torch.rand(5000, device=cuda)
        b = torch.rand(7000, device=cuda)
        before = kspg.LAUNCHES["spgemm_numeric"]
        kspg.spgemm_numeric(seg_ptr, gid, pa, pb, a, b)
        assert kspg.LAUNCHES["spgemm_numeric"] == before + 1


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
@pytest.mark.parametrize("k", [None, 1, 37, 130, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_bsr_listed_and_raw_kernel_routes_match_plain_and_repeat(cuda, case,
                                                                 dtype, k):
    make, block = BSR_CASES[case]
    A = make(dtype)
    B = A.to_bsr(block=block).to(cuda)
    rng = np.random.RandomState(13)
    X = rng.rand(A.n).astype(dtype) if k is None else \
        rng.rand(A.n, k).astype(dtype)
    Xt = torch.as_tensor(X, device=cuda)
    nb = B.nnz_blocks
    cols = B.column_lists()
    assert all(t.is_cuda and t.dtype == torch.int32 for t in cols)
    S = A.to_scipy().astype(np.float64)
    K = int(np.diff(S.tocsr().indptr).max())
    bound = torch.as_tensor(
        2 * (K + 2) * np.finfo(dtype).eps / 2
        * (abs(S) @ np.abs(X).astype(np.float64)), device=cuda) \
        + np.finfo(np.float64).tiny
    for index_dtype in (torch.int32, torch.int64):
        args = (B.m, B.n, B.indptr.to(index_dtype),
                B.indices[:nb].to(index_dtype), B.data[:nb], Xt)
        before = kbsr.LAUNCHES["bsr_spmm"]
        raw = kbsr.bsr_spmm(*args)          # every column of every block
        listed = kbsr.bsr_spmm(*args, cols)  # the occupied columns only
        torch.cuda.synchronize()
        assert kbsr.LAUNCHES["bsr_spmm"] == before + 2
        plain = kbsr.bsr_spmm_plain(*args)
        plain_listed = kbsr.bsr_spmm_plain(*args, cols)
        assert kbsr.LAUNCHES["bsr_spmm"] == before + 2
        for got in (raw, listed):
            assert got.shape == plain.shape and got.dtype == plain.dtype
            assert ((got - plain).abs() <= bound).all()
            assert ((got - plain_listed).abs() <= bound).all()
        # one thread per output, a fixed order: the same bits every launch
        assert torch.equal(kbsr.bsr_spmm(*args, cols), listed)
        assert torch.equal(kbsr.bsr_spmm(*args), raw)
        assert torch.equal(B @ Xt, listed)
    # an X that starts off a 16-byte boundary takes the scalar loads
    if k == 256:
        flat = torch.zeros(A.n * k + 1, dtype=Xt.dtype, device=cuda)
        off = flat[1:].view(A.n, k).copy_(Xt)
        assert off.is_contiguous() and off.data_ptr() % 16 != 0
        assert ((B @ off - listed).abs() <= bound).all()


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
    B @ torch.as_tensor(X, device=cuda)  # through its column lists
    kbsr.bsr_spmm(B.m, B.n, B.indptr, B.indices, B.data,
                  torch.as_tensor(X, device=cuda), B.column_lists())
    with pytest.raises(ValueError, match="CUDA device"):
        kbsr.bsr_spmm(B.m, B.n, B.indptr, B.indices, B.data,
                      torch.as_tensor(X, device=cuda),
                      tuple(t.cpu() for t in B.column_lists()))
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
    before = dict(kdia.LAUNCHES)
    fd = FastDecoupled(g, spmv=spmv)  # device=None
    vm, va, it, res = fd.solve()
    # two mismatches per iteration, one residual per check, one final; each
    # one launch over both slab sets of Ybus
    assert fd._yplan.shared_runs
    assert all(kdia.LAUNCHES[k] - before[k] == 2 * it + it + 1 + 1
               for k in before)
    vm_c, va_c, it_c, res_c = FastDecoupled(g, spmv=spmv,
                                            device="cpu").solve()
    assert it == it_c and res <= 1e-8
    np.testing.assert_allclose(vm, vm_c, rtol=0, atol=1e-8)
    np.testing.assert_allclose(va, va_c, rtol=0, atol=1e-8)
    before = kdia.LAUNCHES["dia_spmv"]
    vm_n, va_n, it_n, res_n = NewtonPowerFlow(g, spmv=spmv,
                                              device=cuda).solve()
    assert kdia.LAUNCHES["dia_spmv"] - before == it_n + 1
    assert res_n <= 1e-10
    np.testing.assert_allclose(vm, vm_n, rtol=0, atol=1e-7)
    np.testing.assert_allclose(dc_power_flow(g),
                               dc_power_flow(g, device="cpu"), rtol=0,
                               atol=1e-10)


# -- the multifrontal path: torch ops on the card -----------------------------

def _shifted_susceptance(n, seed=1):
    """B + 3I for the series susceptances B of synthetic_grid(n, seed): the
    JAX bench's refactorization matrix."""
    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    d = np.arange(n)
    return pt.from_triplets(np.concatenate([g.f, g.t, g.f, g.t, d]),
                            np.concatenate([g.f, g.t, g.t, g.f, d]),
                            np.concatenate([bp, bp, -bp, -bp,
                                            np.full(n, 3.0)]), (n, n))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [5, 32, 70])
def test_dense_lu_nopiv_on_cuda_matches_cpu(cuda, w):
    """The torch-ops no-pivot LU (70 crosses the 32-wide panel) on the card
    against the same function on the CPU, float64: 1e-12 of max|M|."""
    from csparse3_tpu_torch.linalg.supernodal import _dense_lu_nopiv

    D = (np.random.RandomState(w).standard_normal((3, w, w))
         + 2 * w * np.eye(w))
    got = _dense_lu_nopiv(torch.as_tensor(D, device=cuda)).cpu().numpy()
    ref = _dense_lu_nopiv(torch.as_tensor(D)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("cls", ["MultifrontalRefactor", "SupernodalRefactor"])
def test_front_refactor_on_cuda_float32_and_float64(cuda, cls):
    """factor_values on the card against the host factors: float64 within
    1e-12 of the largest factor entry; float32 within 2e-5 of it and a
    solve's relative residual below 1e-4.  TF32 products (10-bit
    mantissas) miss both float32 limits: the fronts run without TF32."""
    A = _shifted_susceptance(2000)
    lu = pt.splu(A, ordering="nd", tol=0.0)
    plan = getattr(pt.linalg, cls)(lu._h, A, device=cuda)
    b = np.random.RandomState(2).rand(A.n)
    for dt, tol, res_tol in ((torch.float32, 2e-5, 1e-4),
                             (torch.float64, 1e-12, 1e-12)):
        d = torch.as_tensor(A.np_arrays()[2], dtype=dt, device=cuda)
        Lx, Ux = plan.factor_values(d)
        assert Lx.dtype == dt and Lx.device == d.device
        for got, ref in ((Lx, lu._h.Lx), (Ux, lu._h.Ux)):
            err = np.abs(got.double().cpu().numpy() - ref).max()
            assert err <= tol * np.abs(ref).max()
        x = plan.refactor(d)(torch.as_tensor(b, dtype=dt, device=cuda))
        x = x.double().cpu().numpy()
        res = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
        assert res < res_tol


@pytest.mark.gpu
def test_multifrontal_lu_on_cuda_matches_scipy_and_cpu(cuda):
    """factor_piv / solve_piv on the card: one and three right-hand sides
    against scipy (1e-8), the factors against the same factorization on
    the CPU (1e-12 of each factor's max), a row exchange forced inside a
    dense front, and the growth stats flagging a singular matrix."""
    import scipy.sparse.linalg as spla

    A = _shifted_susceptance(2000)
    data = A.np_arrays()[2]
    mf = pt.linalg.MultifrontalLU.from_matrix(A, device=cuda)
    mf_cpu = pt.linalg.MultifrontalLU.from_matrix(A, device="cpu")
    fac, stats = mf.factor_piv(torch.as_tensor(data, device=cuda))
    fac_c, stats_c = mf_cpu.factor_piv(torch.as_tensor(data))
    for f, fc in zip(fac, fac_c):
        assert torch.equal(f[3].cpu(), fc[3])
        for t, tc in zip(f[:3], fc[:3]):
            np.testing.assert_allclose(
                t.cpu().numpy(), tc.numpy(), rtol=0,
                atol=1e-12 * max(float(tc.abs().max()), 1.0))
    for k in stats:
        assert abs(float(stats[k]) - float(stats_c[k])) <= 1e-12 * abs(
            float(stats_c[k]))
    B = np.random.RandomState(4).rand(A.n, 3)
    X = mf.solve_piv(fac, torch.as_tensor(B, device=cuda)).cpu().numpy()
    x = mf.solve_piv(fac, torch.as_tensor(B[:, 0], device=cuda)).cpu().numpy()
    ref = spla.spsolve(A.to_scipy().tocsc(), B)
    np.testing.assert_allclose(X, ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(x, ref[:, 0], rtol=1e-8, atol=1e-10)

    rng = np.random.RandomState(5)
    D = rng.rand(40, 40) + np.eye(40) * 0.1
    D[3, 3] = 1e-300
    Ad = pt.CSC.from_scipy(sp.csc_matrix(D))
    md = pt.linalg.MultifrontalLU.from_matrix(Ad, ordering=None, device=cuda)
    fd, _ = md.factor_piv(torch.as_tensor(Ad.np_arrays()[2], device=cuda))
    b = rng.rand(40)
    xd = md.solve_piv(fd, torch.as_tensor(b, device=cuda)).cpu().numpy()
    np.testing.assert_allclose(xd, np.linalg.solve(D, b), rtol=1e-9,
                               atol=1e-9)
    D[5] = D[4]
    _, sb = md.factor_piv(torch.as_tensor(
        pt.CSC.from_scipy(sp.csc_matrix(D)).np_arrays()[2], device=cuda))
    assert float(sb["min_pivot"]) < 1e-10 * float(sb["max_u"])


@pytest.mark.gpu
@pytest.mark.parametrize("spmv", ["ell", "bandpoints"])
def test_newton_multifrontal_on_cuda_matches_level(cuda, spmv):
    """solver='multifrontal' on the card reaches the solver='level' state
    of the same grid (float64 'ell' at 1e-10: 1e-9; 'bandpoints' at the
    float32 floor: 1e-4), with no gate and one K1 launch per mismatch."""
    g = synthetic_grid(2000, seed=3)
    tol = 5e-5 if spmv == "bandpoints" else 1e-10
    pf = NewtonPowerFlow(g, spmv=spmv, solver="multifrontal", tol=tol,
                         device=cuda)
    vm0 = torch.as_tensor(g.vm0, dtype=torch.float64, device=cuda)
    vm, va, it, res, bad = pf.run(vm0, torch.zeros_like(vm0))
    assert not bad and res <= tol
    if spmv == "bandpoints":
        assert pf._yplan.kernel_launches == it + 1
    vm_l, va_l, it_l, res_l = NewtonPowerFlow(g, spmv=spmv, tol=tol,
                                              device=cuda).solve()
    atol = 1e-4 if spmv == "bandpoints" else 1e-9
    np.testing.assert_allclose(vm.cpu().numpy(), vm_l, rtol=0, atol=atol)
    np.testing.assert_allclose(va.cpu().numpy(), va_l, rtol=0, atol=atol)


# -- the banded block-Thomas solvers: torch ops on the card --------------------

def _banded_tol(plan, dtype):
    """How far two solves of one banded plan in ``dtype`` may differ, over
    max|x|: 1e-12 in float64; in float32 the first-order rounding bound of
    the sweeps, 2 nb s u, u = 2^-24 (each output sums nb s products in
    another order on each device)."""
    if dtype == torch.float64:
        return 1e-12
    return 2 * plan.nblocks * plan.s * 2.0 ** -24


def _close_to(got, ref, tol):
    got, ref = got.cpu().double().numpy(), ref.cpu().double().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_plans_on_cuda_match_cpu(cuda, dtype):
    """BandedLU (host factor, device sweeps), BandedRefactor (device
    factor) and BandedSolvePlan on the card against the same plans on the
    CPU, 33 right-hand sides."""
    A = _shifted_susceptance(3000)
    data = A.np_arrays()[2]
    B = np.random.RandomState(3).rand(A.n, 33)
    Bt = torch.as_tensor(B, dtype=dtype)
    lu = pt.BandedLU(A, dtype=dtype)  # device=None: the card
    lu_c = pt.BandedLU(A, dtype=dtype, device="cpu")
    x = lu(Bt.to(cuda))
    assert x.device.type == "cuda" and x.dtype == dtype
    _close_to(x, lu_c(Bt), _banded_tol(lu, dtype))
    rf = pt.BandedRefactor.from_matrix(A, dtype=dtype, device=cuda)
    rf_c = pt.BandedRefactor.from_matrix(A, dtype=dtype, device="cpu")
    for k in (1.0, 2.0):
        got = rf(torch.as_tensor(k * data, device=cuda))
        ref = rf_c(torch.as_tensor(k * data))
        assert got.device.type == "cuda" and got.dtype == dtype
        _close_to(got(Bt.to(cuda)), ref(Bt), _banded_tol(lu, dtype))
    h = pt.splu(A, "rcm", tol=0.0)._h
    bp = pt.BandedSolvePlan(h, dtype=dtype, device=cuda)
    bp_c = pt.BandedSolvePlan(h, dtype=dtype, device="cpu")
    _close_to(bp(Bt.to(cuda)), bp_c(Bt), _banded_tol(bp, dtype))
    if dtype == torch.float64:
        import scipy.sparse.linalg as spla

        np.testing.assert_allclose(x.cpu().numpy(),
                                   spla.spsolve(A.to_scipy().tocsc(), B),
                                   rtol=0, atol=1e-10 * np.abs(B).max())


@pytest.mark.gpu
def test_banded_float32_ignores_the_callers_tf32(cuda):
    """The sweeps and the device factorization run without TF32 whatever
    the caller set: with allow_tf32 = True they give the bits of the
    full-float32 run, and the caller's setting is restored."""
    A = _shifted_susceptance(3000)
    data = torch.as_tensor(A.np_arrays()[2], dtype=torch.float32, device=cuda)
    lu = pt.BandedLU(A, dtype=torch.float32, device=cuda)
    rf = pt.BandedRefactor.from_matrix(A, dtype=torch.float32, device=cuda)
    bb = lu.blocks(torch.rand(A.n, 64, device=cuda))
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        ref, ref_f = lu.solve_blocks(bb), rf(data).stacks()
        torch.backends.cuda.matmul.allow_tf32 = True
        got, got_f = lu.solve_blocks(bb), rf(data).stacks()
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.equal(got, ref)
        assert all(torch.equal(g, r) for g, r in zip(got_f, ref_f))
        # precision='high' allows TF32 (10-bit mantissas): a coarser result
        high = lu.solve_blocks(bb, precision="high")
        _close_to(high, ref, 1e-2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.gpu
def test_complex_factor_device_on_cuda_with_revalue(cuda):
    """factor_device on a complex matrix factors the complex stacks on the
    card; its refactor plan takes complex values of A's pattern (2 A gives
    half the solution)."""
    import scipy.sparse.linalg as spla

    g = synthetic_grid(2000, seed=6)
    ip, ix, dt = ybus(g)[0].np_arrays()
    cols = np.repeat(np.arange(g.n_bus), np.diff(ip))
    d = np.arange(g.n_bus)
    A = pt.from_triplets(np.concatenate([ix, d]), np.concatenate([cols, d]),
                         np.concatenate([dt, np.full(g.n_bus, 2 + 0.3j)]),
                         (g.n_bus, g.n_bus))
    lu, rf = pt.BandedLU.factor_device(A)  # device=None: the card
    lu_c, _ = pt.BandedLU.factor_device(A, device="cpu")
    assert isinstance(lu, pt.ComplexBandedSolve)
    rng = np.random.RandomState(1)
    b = rng.rand(A.n) + 1j * rng.rand(A.n)
    x = lu(b)
    assert x.device.type == "cuda" and x.dtype == torch.complex128
    xs = spla.spsolve(A.to_scipy().tocsc(), b)
    np.testing.assert_allclose(x.cpu().numpy(), xs, rtol=0,
                               atol=1e-10 * np.abs(xs).max())
    _close_to(torch.view_as_real(x), torch.view_as_real(lu_c(b)), 1e-12)
    x2 = rf(torch.as_tensor(2 * A.np_arrays()[2], device=cuda))(b)
    np.testing.assert_allclose(x2.cpu().numpy(), xs / 2, rtol=0,
                               atol=1e-10 * np.abs(xs).max())


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["blocklu", "banded"])
def test_fast_decoupled_banded_solvers_on_cuda_match_cpu(cuda, solver):
    g = rcm_grid(synthetic_grid(2000, seed=3))[0]
    fd = FastDecoupled(g, spmv="symdia", solver=solver)  # device=None
    before = kdia.LAUNCHES["dia_spmv"]
    vm, va, it, res = fd.solve()
    assert kdia.LAUNCHES["dia_spmv"] - before == 3 * it + 2
    vm_c, va_c, it_c, _ = FastDecoupled(g, spmv="symdia", solver=solver,
                                        device="cpu").solve()
    assert it == it_c and res <= 1e-8
    np.testing.assert_allclose(vm, vm_c, rtol=0, atol=1e-8)
    np.testing.assert_allclose(va, va_c, rtol=0, atol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ieee14", "rcm2000"])
def test_newton_blocklu_on_cuda_matches_cpu(cuda, name):
    g = (ieee14() if name == "ieee14"
         else rcm_grid(synthetic_grid(2000, seed=3))[0])
    pf = NewtonPowerFlow(g, spmv="dia", solver="blocklu")  # device=None
    assert pf._rp.device.type == "cuda"
    vm, va, it, res = pf.solve()
    vm_c, va_c, it_c, _ = NewtonPowerFlow(g, spmv="dia", solver="blocklu",
                                          device="cpu").solve()
    assert it == it_c and res <= 1e-10
    np.testing.assert_allclose(vm, vm_c, rtol=0, atol=1e-10)
    np.testing.assert_allclose(va, va_c, rtol=0, atol=1e-10)


# -- the batched study path: K1 and K4 on a scenario axis ----------------------

@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 16, 32, 33, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_bandpoints_kernel_is_one_launch_of_single_bits(cuda, case,
                                                                K):
    """(K, n) parts: one launch for the batch (of the batched kernel for K
    >= 2), each row the bits of its own one-vector launch, and the plain
    version's batch within REL; K = 1 is the one-vector launch."""
    make, kw = CASES[case]
    Y = make()
    plan = pt.SplitBandPoints(Y, device=cuda, **kw)
    rng = np.random.RandomState(21)
    xr, xi = (torch.as_tensor(rng.rand(K, Y.n).astype(np.float32),
                              device=cuda) for _ in range(2))
    before = plan.kernel_launches, plan.scenario_launches
    yr, yi = plan(xr, xi)
    assert plan.kernel_launches - before[0] == 1 and yr.shape == (K, Y.m)
    assert plan.scenario_launches - before[1] == (K >= 2)
    for k in range(K):
        r1, i1 = plan(xr[k], xi[k])
        assert torch.equal(yr[k], r1) and torch.equal(yi[k], i1)
    pr, pi = plan.plain(xr, xi)
    for got, want in ((yr, pr), (yi, pi)):
        scale = want.abs().max()
        assert ((got - want).abs() <= REL * scale).all()
    if K >= 2:
        # the batched launch on its own scenario-minor input
        xs = kbp.scenario_minor_pairs(xr, xi, torch.float32)
        y = torch.empty((2, K, Y.m), device=cuda)
        plan._launch_batch(xs, y)
        assert torch.equal(y[0], yr) and torch.equal(y[1], yi)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 32, 33, 256])
@pytest.mark.parametrize("n", [1, 31, 1037])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scenario_minor_pairs_kernel_is_one_launch_of_the_plain_copy(
        cuda, dtype, n, K):
    """The copy of (K, n) parts into (n, K, 2): one launch, the plain
    version's values exactly, parts of another dtype cast first."""
    rng = np.random.RandomState(24)
    xr, xi = (torch.as_tensor(rng.randn(K, n), device=cuda)
              for _ in range(2))
    want = torch.stack([xr.T.to(dtype), xi.T.to(dtype)], dim=-1)
    before = kbp.PAIR_LAUNCHES["scenario_minor_pairs"]
    got = kbp.scenario_minor_pairs(xr, xi, dtype)
    assert kbp.PAIR_LAUNCHES["scenario_minor_pairs"] - before == 1
    assert got.shape == (n, K, 2) and got.dtype == dtype
    assert got.is_contiguous() and torch.equal(got, want)
    # the parts as views of a wider tensor
    wide = torch.as_tensor(rng.randn(2, K, n + 5), device=cuda)
    got = kbp.scenario_minor_pairs(wide[0, :, 2:-3], wide[1, :, 2:-3], dtype)
    assert torch.equal(got, torch.stack(
        [wide[0, :, 2:-3].T.to(dtype), wide[1, :, 2:-3].T.to(dtype)], -1))


def _check_batched_split(p, xr, xi):
    """One launch of the split-complex run kernel for the (K, n) batch (of
    the batched kernel for K >= 2), each row bit-equal to its own one-vector
    launch and within the rounding bound of the plain walk of the index; the
    wrapper gives the same bits on a (K, n, 2) and on a scenario-minor (n,
    K, 2) input.  Returns (yr, yi)."""
    K, n = xr.shape
    before = dict(kdia.LAUNCHES)
    batched = kdia.BATCH_LAUNCHES["dia_spmv_split_batched"]
    yr, yi = p(xr, xi)
    torch.cuda.synchronize()
    assert all(kdia.LAUNCHES[k] - before[k] == 1 for k in before)
    assert (kdia.BATCH_LAUNCHES["dia_spmv_split_batched"] - batched
            == int(K >= 2))
    assert yr.shape == (K, p.re.m)
    for k in range(K):
        r1, i1 = p(xr[k], xi[k])
        assert torch.equal(yr[k], r1) and torch.equal(yi[k], i1)
    pr, pi = p.plain(xr, xi)
    for k in range(K):
        x2 = torch.stack([xr[k], xi[k]])
        bound = sum(_dia_bound(q, x2).sum(0) for q in (p.re, p.im))
        assert ((yr[k] - pr[k]).abs() <= bound).all()
        assert ((yi[k] - pi[k]).abs() <= bound).all()
    args = (p.re.omin, p.re.symmetric, p.re.runs,
            (p.re.run_values, p.im.run_values))
    for x, minor in ((torch.stack([xr, xi], dim=-1), False),
                     (kbp.scenario_minor_pairs(xr, xi, xr.dtype), True)):
        y = kdia.dia_split_cuda(p.re.slabs, p.im.slabs, x, *args,
                                scenario_minor=minor,
                                entries=p.batch_entries())
        assert y.shape == (K, 2, p.re.m)
        assert torch.equal(y[:, 0], yr) and torch.equal(y[:, 1], yi)
    return yr, yi


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 5, 16, 33, 256])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("n", [1037, 10_000, 20_001])
@pytest.mark.parametrize("plan", ["SplitDIA", "SplitSymDIA"])
def test_batched_split_run_kernel_is_one_launch_of_single_bits(cuda, plan, n,
                                                               dtype, K):
    Y = _complex_band(n, 6, dtype)
    f32 = dtype == np.complex64
    kw = dict(tol=1e-6 if f32 else 1e-12) if plan == "SplitSymDIA" else {}
    p = getattr(pt, plan)(Y, device=cuda, **kw)
    assert p.shared_runs
    real = np.float32 if f32 else np.float64
    rng = np.random.RandomState(22)
    xr, xi = (torch.as_tensor(rng.rand(K, n).astype(real), device=cuda)
              for _ in range(2))
    _check_batched_split(p, xr, xi)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [3, 32])
@pytest.mark.parametrize("plan", ["SplitDIA", "SplitSymDIA"])
def test_batched_split_run_kernel_on_groups_with_empty_lists(cuda, plan, K):
    """Buses 40-51 cut off (their rows and columns empty): three groups of
    the index list no run, forward or mirror, and their rows come out 0."""
    Y = _complex_band(1037, 6, np.complex128)
    S = Y.to_scipy().tolil()
    S[40:52, :] = 0
    S[:, 40:52] = 0
    S = S.tocsc()
    S.eliminate_zeros()
    S.sort_indices()
    kw = dict(tol=1e-12) if plan == "SplitSymDIA" else {}
    p = getattr(pt, plan)(pt.CSC(Y.m, Y.n, S.indptr, S.indices, S.data),
                          device=cuda, **kw)
    assert p.shared_runs
    for ptr in p.re.runs[::2]:
        counts = ptr.diff().cpu().numpy()
        assert (counts[10:13] == 0).all() and counts.sum() > 0
    rng = np.random.RandomState(23)
    xr, xi = (torch.as_tensor(rng.rand(K, Y.n), device=cuda)
              for _ in range(2))
    yr, yi = _check_batched_split(p, xr, xi)
    assert not yr[:, 40:52].any() and not yi[:, 40:52].any()


def _load_batch(grid, K, seed=0):
    from csparse3_tpu_torch.models.powerflow import sbus

    scale = 1 + 0.05 * np.random.RandomState(seed).randn(K)
    return sbus(grid)[None, :] * scale[:, None]


@pytest.mark.gpu
@pytest.mark.parametrize("spmv,solver", [("bandpoints", "multifrontal"),
                                         ("ell", "level"),
                                         ("dia", "blocklu")])
def test_newton_solve_batch_on_cuda_matches_cpu(cuda, spmv, solver):
    g = synthetic_grid(2000, seed=3)
    if solver == "blocklu":
        g = rcm_grid(g)[0]
    tol = 5e-5 if spmv == "bandpoints" else 1e-10
    sb = _load_batch(g, 6)
    pf = NewtonPowerFlow(g, spmv=spmv, solver=solver, tol=tol)
    launches = getattr(pf._yplan, "kernel_launches", None)
    dia_before = kdia.LAUNCHES["dia_spmv"]
    vm, va, it, res = pf.solve_batch(sb)
    assert vm.device.type == "cuda" and vm.shape == (6, g.n_bus)
    if spmv == "bandpoints":
        # one K1 launch per batched mismatch evaluation
        assert pf._yplan.kernel_launches - launches == int(it.max()) + 1
    if spmv == "dia":
        assert kdia.LAUNCHES["dia_spmv"] - dia_before == int(it.max()) + 1
    vm_c, va_c, it_c, res_c = NewtonPowerFlow(
        g, spmv=spmv, solver=solver, tol=tol, device="cpu").solve_batch(sb)
    atol = 1e-4 if spmv == "bandpoints" else 1e-9
    assert (res.cpu() <= tol).all()
    np.testing.assert_allclose(vm.cpu().numpy(), vm_c.numpy(), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(va.cpu().numpy(), va_c.numpy(), rtol=0,
                               atol=atol)
    if spmv != "bandpoints":
        assert torch.equal(it.cpu(), it_c)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["blocklu", "level"])
def test_fast_decoupled_solve_batch_on_cuda_matches_cpu(cuda, solver):
    g = rcm_grid(synthetic_grid(2000, seed=3))[0]
    sb = _load_batch(g, 40, seed=1)
    fd = FastDecoupled(g, spmv="symdia", solver=solver)
    before = kdia.LAUNCHES["dia_spmv"]
    vm, va, it = fd.solve_batch(sb)
    # the residuals of every iteration and of the final state, two
    # mismatches per step: one launch each for the whole batch
    assert kdia.LAUNCHES["dia_spmv"] - before == 3 * int(it.max()) + 1
    vm_c, va_c, it_c = FastDecoupled(g, spmv="symdia", solver=solver,
                                     device="cpu").solve_batch(sb)
    assert torch.equal(it.cpu(), it_c)
    np.testing.assert_allclose(vm.cpu().numpy(), vm_c.numpy(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(va.cpu().numpy(), va_c.numpy(), rtol=0,
                               atol=1e-8)


@pytest.mark.gpu
def test_contingencies_on_cuda_match_cpu(cuda):
    from csparse3_tpu_torch.models.contingency import (ACContingency,
                                                       DCContingency)

    g = synthetic_grid(2000, seed=3)
    ks = np.random.RandomState(2).choice(g.n_branch, 300, replace=False)
    fl, th, ok = DCContingency(g).run(ks, batch=128)
    fl_c, th_c, ok_c = DCContingency(g, device="cpu").run(ks, batch=128)
    assert fl.device.type == "cuda" and torch.equal(ok.cpu(), ok_c)
    _close_to(fl[ok], fl_c[ok_c], 1e-10)
    _close_to(th[ok], th_c[ok_c], 1e-10)
    g14 = ieee14()
    for solver in ("level", "multifrontal"):
        vm, va, it, ok = ACContingency(g14, solver=solver).run(batch=8)
        vm_c, va_c, it_c, ok_c = ACContingency(g14, solver=solver,
                                               device="cpu").run(batch=8)
        assert torch.equal(ok.cpu(), ok_c) and not ok_c.all()
        assert torch.equal(it.cpu()[ok_c], it_c[ok_c])
        np.testing.assert_allclose(vm.cpu()[ok_c].numpy(),
                                   vm_c[ok_c].numpy(), rtol=0, atol=1e-9)


@pytest.mark.gpu
def test_sensitivity_and_short_circuit_on_cuda_match_cpu(cuda):
    from csparse3_tpu_torch.models.sensitivity import (LinearContingency,
                                                       ptdf)
    from csparse3_tpu_torch.models.shortcircuit import short_circuit

    g = synthetic_grid(1000, seed=5)
    H = ptdf(g, chunk=300)
    assert H.device.type == "cuda"
    _close_to(H, ptdf(g, chunk=300, device="cpu"), 1e-10)
    fl, ok = LinearContingency(g).run()
    fl_c, ok_c = LinearContingency(g, device="cpu").run()
    assert torch.equal(ok.cpu(), ok_c)
    _close_to(fl, fl_c, 1e-9)
    res = short_circuit(g, buses=np.arange(0, 1000, 7), chunk=64)
    ref = short_circuit(g, buses=np.arange(0, 1000, 7), chunk=64,
                        device="cpu")
    assert torch.equal(res.ok.cpu(), ref.ok)
    for got, want in ((res.ifault, ref.ifault), (res.vpost, ref.vpost),
                      (res.iflow, ref.iflow)):
        _close_to(torch.view_as_real(got), torch.view_as_real(want), 1e-10)
