"""Parity repairs of the port's containers and orderings against the JAX
package, on the same numpy inputs:

* ``CSC ==`` is the exact compare ``equal`` (True for equal matrices built
  apart, False for a changed value or pattern), and a CSC is not hashable;
* ``CSR`` has the JAX package's delegating operators ``@ * + -`` and
  unary ``-``, with its result types: CSR (op) CSR gives a CSR, anything
  else what the CSC operator gives;
* ``ordering='mindeg'`` is the JAX package's greedy minimum degree: the
  same permutation exactly, through ``get_ordering``, ``splu`` and
  ``ldlt``.

The new modules of the port import neither jax nor the JAX package.
"""

import os
import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu import linalg as jlin
from csparse3_tpu_torch import linalg as plin

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scipy(m, n, seed, density=0.15):
    a = sp.random(m, n, density=density, format="csc",
                  random_state=np.random.RandomState(seed))
    a.sort_indices()
    return a


def _both(a):
    """(port CSC on the CPU, JAX CSC) of a scipy matrix."""
    a = a.tocsc()
    return pt.CSC.from_scipy(a, device="cpu"), jt.CSC.from_scipy(a)


# ---------------------------------------------------------------------------
# CSC ==
# ---------------------------------------------------------------------------

def _variants():
    a = _scipy(30, 25, 1)
    changed = a.copy()
    changed.data[3] += 1.0
    pattern = a.tolil()
    pattern[0, 0] = 7.0 if a[0, 0] == 0 else 0.0
    return {"same": (a, a.copy()), "value": (a, changed),
            "pattern": (a, pattern.tocsc()),
            "shape": (a, _scipy(30, 26, 1))}


@pytest.mark.parametrize("case", ["same", "value", "pattern", "shape"])
def test_csc_eq_matches_reference(case):
    x, y = _variants()[case]
    (px, jx), (py, jy) = _both(x), _both(y)
    expect = bool(jx == jy)
    assert (px == py) is expect
    assert (px != py) is (not expect)
    assert expect is (case == "same")


def test_csc_eq_other_types_and_hash():
    pa, ja = _both(_scipy(10, 10, 2))
    assert (pa == 3) is (ja == 3) is False
    assert pa.__eq__(3) is NotImplemented
    with pytest.raises(TypeError):
        hash(pa)
    with pytest.raises(TypeError):
        hash(ja)


# ---------------------------------------------------------------------------
# CSR operators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csr_pair():
    a, b = _scipy(40, 40, 3), _scipy(40, 40, 4)
    x = np.random.RandomState(5).randn(40)
    X = np.random.RandomState(6).randn(40, 3)
    ports = [pt.CSR.from_scipy(m.tocsr(), device="cpu") for m in (a, b)]
    jaxs = [jt.CSR.from_scipy(m.tocsr()) for m in (a, b)]
    return ports, jaxs, x, X


def _same_sparse(p, j, kind):
    assert type(p).__name__ == type(j).__name__ == kind
    assert p.shape == j.shape
    for u, v in zip(p.np_arrays(), j.np_arrays()):
        np.testing.assert_allclose(u, v, rtol=1e-14, atol=0)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "matmul"])
def test_csr_binary_operators_match_reference(csr_pair, op):
    (pa, pb), (ja, jb), _, _ = csr_pair
    f = {"add": lambda u, v: u + v, "sub": lambda u, v: u - v,
         "mul": lambda u, v: u * v, "matmul": lambda u, v: u @ v}[op]
    _same_sparse(f(pa, pb), f(ja, jb), "CSR")
    # CSR (op) CSC: add / sub come back as CSR, the products as CSC
    kind = "CSR" if op in ("add", "sub") else "CSC"
    _same_sparse(f(pa, pb.to_csc()), f(ja, jb.to_csc()), kind)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_csr_times_numpy_matches_reference(csr_pair, rhs):
    (pa, _), (ja, _), x, X = csr_pair
    v = x if rhs == "vector" else X
    for got, ref in ((pa @ v, ja @ v), (pa * v, ja * v)):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose((pa @ v).numpy(), pa.to_scipy() @ v,
                               rtol=1e-13, atol=1e-13)


def test_csr_scalar_and_negation_match_reference(csr_pair):
    (pa, _), (ja, _), _, _ = csr_pair
    _same_sparse(pa * 2.5, ja * 2.5, "CSC")
    _same_sparse(2.5 * pa, 2.5 * ja, "CSC")
    neg = -pa
    _same_sparse(neg, -ja, "CSR")
    assert neg.device.type == "cpu"


# ---------------------------------------------------------------------------
# mindeg
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sym_pair():
    """A structurally unsymmetric matrix with a dominant diagonal."""
    a = (_scipy(120, 120, 7, density=0.03) + sp.eye(120) * 4).tocsc()
    return _both(a)


def test_mindeg_permutation_equals_reference(sym_pair):
    pa, ja = sym_pair
    got = plin.get_ordering("mindeg", pa)
    np.testing.assert_array_equal(got, jlin.get_ordering("mindeg", ja))
    np.testing.assert_array_equal(plin.mindeg(pa), got)
    assert sorted(got.tolist()) == list(range(pa.n))
    ip, adj = plin.symmetrize_pattern(pa)
    for u, v in zip((ip, adj), jlin.ordering.symmetrize_pattern(ja)):
        np.testing.assert_array_equal(u, v)


def test_mindeg_through_splu_and_ldlt(sym_pair):
    pa, ja = sym_pair
    lp, lj = plin.splu(pa, ordering="mindeg"), jlin.splu(ja, ordering="mindeg")
    np.testing.assert_array_equal(lp.perm_c, lj.perm_c)
    np.testing.assert_array_equal(lp.perm_r, lj.perm_r)
    s = pa.to_scipy()
    ps, js = _both((s + s.T).tocsc())
    fp, fj = plin.ldlt(ps, ordering="mindeg"), jlin.ldlt(js, ordering="mindeg")
    np.testing.assert_array_equal(fp.perm, fj.perm)
    np.testing.assert_array_equal(fp.Li, fj.Li)


def test_mindeg_rejects_a_rectangular_matrix():
    with pytest.raises(ValueError, match="square"):
        plin.mindeg(pt.CSC.from_scipy(_scipy(4, 5, 0), device="cpu"))


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'csparse3_tpu'):\n"
            "    sys.modules[name] = None  # any import of them fails\n"
            "import csparse3_tpu_torch\n"
            "from csparse3_tpu_torch.linalg import (btf, cholesky, "
            "iterative, ordering)\n"
            "from csparse3_tpu_torch.models import estimation\n"
            "from csparse3_tpu_torch.ops import reductions\n"
            "from csparse3_tpu_torch.native import host_ext\n"
            "from csparse3_tpu_torch import builder\n"
            "from csparse3_tpu_torch.linalg import spike_stream\n"
            "from csparse3_tpu_torch.ops import (graph, norms, stacking, "
            "validate)\n"
            "from csparse3_tpu_torch.utils import io, misc, profiling\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("shape", [(12, 12), (9, 14)])
def test_diagonal_and_sum_duplicates_match_jax(shape):
    """``ops.reductions``: the diagonal (duplicates on it add up) and
    ``sum_duplicates`` of a matrix built with its duplicates kept."""
    rng = np.random.RandomState(21)
    k = 60
    rows = rng.randint(0, shape[0], k)
    cols = rng.randint(0, shape[1], k)
    rows[:4], cols[:4] = [1, 1, 2, 3], [1, 1, 5, 3]  # a duplicate diagonal
    vals = rng.randn(k)
    ap = pt.from_triplets(rows, cols, vals, shape, sum_duplicates=False)
    aj = jt.from_triplets(rows, cols, vals, shape, sum_duplicates=False)
    from csparse3_tpu.ops import reductions as jred
    from csparse3_tpu_torch.ops import reductions as pred
    np.testing.assert_allclose(pred.diagonal(ap.to("cpu")).numpy(),
                               np.asarray(jred.diagonal(aj)), rtol=1e-14)
    sp_, sj = pred.sum_duplicates(ap), jred.sum_duplicates(aj)
    for got, ref in zip(sp_.np_arrays(), sj.np_arrays()):
        np.testing.assert_allclose(got, ref, rtol=1e-14)
    assert sp_.nnz == sj.nnz
