"""Parity of the PyTorch port's containers, construction and grids with
the JAX package: the same numpy inputs through both, compared exactly for
structure and to rtol 1e-14 for values (both are the same host numpy
arithmetic)."""

import os
import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.utils.interop import csc_from_arrays, grid_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_csc(p, j, rtol=1e-14):
    assert p.shape == j.shape
    pip, pix, pdt = p.np_arrays()
    jip, jix, jdt = j.np_arrays()
    np.testing.assert_array_equal(pip, jip)
    np.testing.assert_array_equal(pix, jix)
    np.testing.assert_allclose(pdt, jdt, rtol=rtol, atol=0)


def _grids():
    return {"ieee14": (pgrids.ieee14(), jgrids.ieee14()),
            "synthetic300": (pgrids.synthetic_grid(300, seed=5),
                             jgrids.synthetic_grid(300, seed=5))}


@pytest.mark.parametrize("name", ["ieee14", "synthetic300"])
def test_ybus_matches_jax(name):
    gp, gj = _grids()[name]
    for a, b in zip(gp, gj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for p, j in zip(pgrids.ybus(gp), jgrids.ybus(gj)):
        assert_same_csc(p, j)
    for p, j in zip(pgrids.connectivity(gp), jgrids.connectivity(gj)):
        assert_same_csc(p, j)


@pytest.mark.parametrize("sum_duplicates", [True, False])
def test_from_triplets_matches_jax(sum_duplicates):
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 40, 300)
    cols = rng.integers(0, 30, 300)
    vals = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    p = pt.from_triplets(rows, cols, vals, (40, 30),
                         sum_duplicates=sum_duplicates)
    j = jt.from_triplets(rows, cols, vals, (40, 30),
                         sum_duplicates=sum_duplicates)
    assert p.canonical == j.canonical
    assert_same_csc(p, j)


def test_conversions_match_jax():
    Yp, _, _ = pgrids.ybus(pgrids.synthetic_grid(300, seed=5))
    Yj, _, _ = jgrids.ybus(jgrids.synthetic_grid(300, seed=5))
    assert_same_csc(pt.transpose(Yp), jt.transpose(Yj))
    assert_same_csc(pt.canonicalize(Yp), jt.canonicalize(Yj))
    assert_same_csc(pt.csr_to_csc(pt.csc_to_csr(Yp)), Yj)
    rp, cp, dp = pt.csc_to_csr(Yp).np_arrays()
    rj, cj, dj = jt.csc_to_csr(Yj).np_arrays()
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(dp, dj)
    dense = pt.csc_to_dense(Yp.to("cpu"))
    assert dense.dtype == torch.complex128
    np.testing.assert_array_equal(dense.numpy(), np.asarray(Yj.todense()))
    np.testing.assert_array_equal(Yp.to_scipy().toarray(), Yj.to_scipy().toarray())


def test_dense_sums_duplicates_and_ors_bool():
    rows, cols = np.array([0, 0, 1]), np.array([1, 1, 0])
    a = pt.COO(2, 2, rows, cols, np.array([1.5, 2.0, 3.0]), device="cpu")
    np.testing.assert_array_equal(a.to_dense().numpy(), [[0, 3.5], [3.0, 0]])
    b = pt.COO(2, 2, rows, cols, np.array([True, False, True]),
               device="cpu")
    np.testing.assert_array_equal(b.to_dense().numpy(),
                                  [[False, True], [True, False]])


def test_containers_upload_lazily_to_explicit_device():
    Y0, _, _ = pgrids.ybus(pgrids.ieee14())
    # no device named: the default (the card) is resolved at first use, and
    # there is none here; the host arrays need no device
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Y0.device
    assert Y0.np_arrays()[2].dtype == np.complex128
    Y = Y0.to("cpu")
    assert Y.device == torch.device("cpu")
    assert Y._np is not None and not isinstance(Y._arrays[2], torch.Tensor)
    assert Y.data.dtype == torch.complex128 and Y.indices.dtype == torch.int32
    Ym = Y.to("meta")
    assert Ym.data.device.type == "meta"
    # the host cache survives the move: no device -> host copy for np_arrays
    for a, b in zip(Ym.np_arrays(), Y.np_arrays()):
        np.testing.assert_array_equal(a, b)


def test_interop_carries_jax_state():
    gj = jgrids.synthetic_grid(300, seed=5)
    gp = grid_from_arrays(**gj._asdict())
    assert isinstance(gp, pgrids.Grid) and gp.n_bus == 300
    Yj, _, _ = jgrids.ybus(gj)
    Yp = csc_from_arrays(Yj.m, Yj.n, *Yj.np_arrays())
    assert_same_csc(Yp, Yj)
    assert_same_csc(pgrids.ybus(gp)[0], Yj)


@pytest.mark.parametrize("layout", ["ell", "stream"])
def test_spmv_plans_match_jax(layout):
    Yj, _, _ = jgrids.ybus(jgrids.synthetic_grid(300, seed=5))
    Yp = csc_from_arrays(Yj.m, Yj.n, *Yj.np_arrays())
    rng = np.random.default_rng(2)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    X = rng.standard_normal((300, 3))
    pp = pt.SpMVPlan(Yp, layout=layout, device="cpu")
    pj = jt.SpMVPlan(Yj, layout=layout)
    assert pp.layout == pj.layout == layout
    for v in (x, X):
        np.testing.assert_allclose(pp(torch.as_tensor(v)).numpy(),
                                   np.asarray(pj(v)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pt.spmv(Yp, torch.as_tensor(x)).numpy(),
                               np.asarray(jt.spmv(Yj, x)), rtol=1e-12,
                               atol=1e-12)
    sp_ = pt.SplitSpMV(Yp, layout=layout, device="cpu")
    sj = jt.SplitSpMV(Yj, layout=layout)
    xr, xi = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    for a, b in zip(sp_(torch.as_tensor(xr), torch.as_tensor(xi)),
                    sj(xr, xi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="dimension mismatch"):
        pp(torch.zeros(299, dtype=torch.complex128))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, csparse3_tpu_torch\n"
            "from csparse3_tpu_torch.ops import (arithmetic, bsr_ops, "
            "spgemm, spgemm_device)\n"
            "from csparse3_tpu_torch.kernels import bsr_spmm, spgemm\n"
            "from csparse3_tpu_torch import builder\n"
            "from csparse3_tpu_torch.linalg import spike_stream\n"
            "from csparse3_tpu_torch.ops import graph, norms, stacking\n"
            "from csparse3_tpu_torch.utils import io, misc, profiling\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'csparse3_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
