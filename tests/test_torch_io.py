"""The port's ``utils/io.py`` files against the JAX package's and scipy's:
each package reads what the other writes, and ``scipy.sparse.load_npz``
reads both, for the npz containers (CSC, CSR, COO), the ``SparseLU``
bundle and the ``BandedLU`` stacks; and ``utils/profiling.py``.

Tolerances: containers, factors and stacks read back bit for bit; solves
after a load equal the solves before it (the same arithmetic on the same
arrays), and the port's against the JAX package's within 1e-12 of max|x|
(``SOLVE_RTOL``): the same factors, another summation order.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.linalg import BandedLU as JBandedLU
from csparse3_tpu.utils import io as jio
from csparse3_tpu_torch.linalg import BandedLU as PBandedLU
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.utils import io as pio
from csparse3_tpu_torch.utils import profiling as pprof

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

SOLVE_RTOL = 1e-12


def _rand(m, n, density, seed):
    rng = np.random.RandomState(seed)
    a = sp.random(m, n, density=density, random_state=rng, format="csc")
    a.sum_duplicates()
    return a


def _arrays_equal(a, b):
    assert a.shape == b.shape and type(a).__name__ == type(b).__name__
    for x, y in zip(a.np_arrays(), b.np_arrays()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("fmt", ["csc", "csr", "coo"])
@pytest.mark.parametrize("compressed", [True, False])
def test_npz_files_cross_between_the_packages_and_scipy(tmp_path, fmt,
                                                        compressed):
    s = _rand(30, 20, 0.15, 1)
    conv = {"csc": lambda m: m.CSC.from_scipy(s),
            "csr": lambda m: m.CSR(30, 20, *(lambda r: (r.indptr, r.indices,
                                                        r.data))(s.tocsr())),
            "coo": lambda m: m.COO(30, 20, s.tocoo().row, s.tocoo().col,
                                   s.tocoo().data)}[fmt]
    p, j = conv(pt), conv(jt)
    pio.save_npz(tmp_path / "port.npz", p, compressed=compressed)
    jio.save_npz(tmp_path / "jax.npz", j, compressed=compressed)
    _arrays_equal(pio.load_npz(tmp_path / "jax.npz", device="cpu"), p)
    _arrays_equal(jio.load_npz(tmp_path / "port.npz"), j)
    for name in ("port.npz", "jax.npz"):
        np.testing.assert_array_equal(
            sp.load_npz(tmp_path / name).toarray(), s.toarray())
    assert pio.load_npz(tmp_path / "port.npz", device="cpu").device == \
        torch.device("cpu")


def test_npz_reads_scipy_files_and_rejects_others(tmp_path):
    s = _rand(12, 12, 0.3, 2)
    sp.save_npz(tmp_path / "scipy.npz", s.tocsr())
    got = pio.load_npz(tmp_path / "scipy.npz", device="cpu")
    assert isinstance(got, pt.CSR)
    np.testing.assert_array_equal(got.to_scipy().toarray(), s.toarray())
    sp.save_npz(tmp_path / "bsr.npz", s.tobsr(blocksize=(2, 2)))
    with pytest.raises(ValueError, match="unsupported sparse format"):
        pio.load_npz(tmp_path / "bsr.npz")
    with pytest.raises(TypeError, match="cannot save"):
        pio.save_npz(tmp_path / "x.npz", np.eye(2))


def test_lu_bundles_cross_between_the_packages(tmp_path):
    s = (_rand(40, 40, 0.1, 3) + sp.eye(40) * 5).tocsc()
    p, j = pt.CSC.from_scipy(s, device="cpu"), jt.CSC.from_scipy(s)
    lu_p, lu_j = pt.splu(p), jt.linalg.splu(j)
    pio.save_lu(tmp_path / "port_lu.npz", lu_p)
    jio.save_lu(tmp_path / "jax_lu.npz", lu_j)
    b = np.random.RandomState(4).rand(40)
    ref = lu_p.solve(b, device="cpu").numpy()
    for lu in (pio.load_lu(tmp_path / "jax_lu.npz"),
               pio.load_lu(tmp_path / "port_lu.npz")):
        assert isinstance(lu, pt.SparseLU)
        for f in lu_p._h._fields:
            np.testing.assert_array_equal(np.asarray(getattr(lu._h, f)),
                                          np.asarray(getattr(lu_p._h, f)))
        np.testing.assert_array_equal(lu.solve(b, device="cpu").numpy(), ref)
    xj = np.asarray(jio.load_lu(tmp_path / "port_lu.npz").solve(b))
    np.testing.assert_allclose(xj, ref, rtol=0,
                               atol=SOLVE_RTOL * np.abs(ref).max())
    np.testing.assert_allclose(s @ ref, b, rtol=1e-10)


def test_banded_stacks_cross_between_the_packages(tmp_path):
    n = 600
    g = pgrids.synthetic_grid(n, seed=3)
    bp = 1.0 / g.x
    d = np.arange(n)
    args = (np.concatenate([g.f, g.t, g.f, g.t, d]),
            np.concatenate([g.f, g.t, g.t, g.f, d]),
            np.concatenate([bp, bp, -bp, -bp, np.full(n, 3.0)]), (n, n))
    plan_p = PBandedLU(pt.from_triplets(*args, device="cpu"), device="cpu")
    plan_j = JBandedLU(jt.from_triplets(*args))
    pio.save_banded(tmp_path / "port_b.npz", plan_p)
    jio.save_banded(tmp_path / "jax_b.npz", plan_j)
    b = np.random.RandomState(0).rand(n)
    ref = plan_p.solve_host(b)
    for name in ("port_b.npz", "jax_b.npz"):
        got = pio.load_banded(tmp_path / name, device="cpu")
        assert (got.n, got.s, got.bw) == (plan_p.n, plan_p.s, plan_p.bw)
        np.testing.assert_array_equal(got.solve_host(b), ref)
        np.testing.assert_array_equal(got(b).numpy(), plan_p(b).numpy())
        assert got.device == torch.device("cpu")
    back = jio.load_banded(tmp_path / "port_b.npz")
    np.testing.assert_array_equal(back.solve_host(b), plan_j.solve_host(b))
    np.testing.assert_allclose(ref, plan_j.solve_host(b), rtol=0,
                               atol=SOLVE_RTOL * np.abs(ref).max())
    # a plan factored on the device has no host stacks to save
    lu, _ = PBandedLU.factor_device(pt.from_triplets(*args, device="cpu"),
                                    device="cpu")
    with pytest.raises(ValueError, match="no host stacks"):
        pio.save_banded(tmp_path / "dev.npz", lu)


def test_profiling_helpers(tmp_path):
    t = pprof.Timer()
    with t.section("x"):
        pass
    assert "x" in t.summary() and len(t.records["x"]) == 1
    assert pprof.timeit(lambda v: v + 1, torch.ones(16), iters=2,
                        warmup=1) >= 0
    assert pprof.nnz_per_sec(10, 0.0) == float("inf")
    a = pt.CSC.from_scipy(_rand(200, 200, 0.05, 5), device="cpu")
    r = pprof.compare_with_scipy(a, "spmv", iters=2, device="cpu")
    assert r["ours_s"] > 0 and r["scipy_s"] > 0 and r["nnz"] == a.nnz
    r2 = pprof.compare_with_scipy(a, "spgemm")
    assert r2["ours_s"] > 0 and r2["speedup"] > 0
    with pytest.raises(ValueError, match="unknown op"):
        pprof.compare_with_scipy(a, "lu", device="cpu")
    with pprof.trace(str(tmp_path / "trace")):
        (torch.ones(64) * 2).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
