"""Parity of the port's distributed SPIKE solver
(``csparse3_tpu_torch/parallel/banded.py``, ``DistBandedLU``) with the JAX
package's, on the same numpy inputs, at the sizes of the JAX package's own
cases (``tests/test_dist_banded.py``; n <= 5000).

* The host constructor at P = 1, 4 and 8: ``solve_host`` against the JAX
  package's (at P = 1, where the JAX package's ``solve_host`` raises,
  against its device solve), and the device solve against the JAX
  package's twice: from the port's own factor, and from the JAX package's
  host factor state carried over by ``utils.interop.dist_banded_from_host``.
* ``factor_device``: symmetric, nonsymmetric and complex systems, with
  ``reduced_store='sharded'`` and ``'replicated'``, each solved for one and
  for B = 8 right-hand sides (B a multiple of P: the reduced solve split
  over the columns).

Tolerances: within 1e-12 of max|x| in float64 for the host factor
(``HOST_RTOL``), 1e-10 for the device factor in float64 (``F64_RTOL``) and
1e-4 in float32 (``F32_RTOL``, the JAX package's own float32 bound).  The
JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``, the
port on ``Mesh.virtual(P, "cpu")``.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from jax.sharding import Mesh as JMesh

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu import parallel as jpar
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu_torch import parallel as ppar

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

HOST_RTOL = 1e-12
F64_RTOL = 1e-10
F32_RTOL = 1e-4


def _close(got, ref, rtol):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if ref.size == 0:
        return
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _jmesh(k):
    return JMesh(np.array(jax.devices()[:k]), ("rows",))


def _grid_system(n, seed, shift=3.0):
    """B' + 3I of synthetic_grid(n, seed) (symmetric)."""
    g = jgrids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t, np.arange(n)])
    cols = np.concatenate([g.f, g.t, g.t, g.f, np.arange(n)])
    vals = np.concatenate([bp, bp, -bp, -bp, np.full(n, shift)])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()


def _nonsymmetric(n=4096, seed=5):
    rng = np.random.RandomState(seed)
    return sp.diags([-rng.rand(n - 9), -rng.rand(n - 1), 4.0 + rng.rand(n),
                     -2 * rng.rand(n - 1), -0.3 * rng.rand(n - 9)],
                    [-9, -1, 0, 1, 9]).tocsc()


def _complex(n=1500, seed=5):
    Y, _, _ = jgrids.ybus(jgrids.synthetic_grid(n, seed=seed))
    return (Y.to_scipy() + sp.eye(n) * (2.0 + 0.3j)).tocsc()


def _pair(s):
    return jt.CSC.from_scipy(s), pt.CSC.from_scipy(s, device="cpu")


# ---------------------------------------------------------------------------
# the host constructor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_case():
    s = _grid_system(3000, seed=2)
    b = np.random.RandomState(1).rand(3000, 2)
    return s, b


@pytest.mark.parametrize("P", [1, 4, 8])
def test_host_factor_matches_jax(host_case, P):
    s, b = host_case
    ja, pa = _pair(s)
    jd = jpar.DistBandedLU(ja, mesh=_jmesh(P))
    mesh = ppar.Mesh.virtual(P, "cpu")
    pd = ppar.DistBandedLU(pa, mesh=mesh)
    assert (pd.n, pd.s, pd.bw, pd.m, pd.P) == (jd.n, jd.s, jd.bw, jd.m, jd.P)
    assert np.array_equal(pd.perm, jd.perm)
    for got, ref in zip(pd._h, jd._h):
        assert got.dtype == ref.dtype == np.float64
        _close(got, ref, HOST_RTOL)
    x_dev = jd(b)
    x_host = jd.solve_host(b) if P > 1 else x_dev
    _close(pd.solve_host(b), x_host, HOST_RTOL)
    _close(pd(b), x_dev, HOST_RTOL)
    _close(pd(b[:, 0]), x_dev[:, 0], HOST_RTOL)
    # the JAX package's factor state, solved by the port
    carried = pt.dist_banded_from_host(*jd._h, jd.perm, jd.n, jd.s, jd.bw,
                                       jd.m, jd.P, mesh)
    _close(carried.solve_host(b), x_host, HOST_RTOL)
    _close(carried(b), x_dev, HOST_RTOL)
    _close(pd(b), spla.spsolve(s, b), 1e-9)


def test_host_factor_natural_band():
    n = 4096
    s = sp.diags([-0.3 * np.ones(n - 9), -np.ones(n - 1), 4.0 * np.ones(n),
                  -np.ones(n - 1), -0.3 * np.ones(n - 9)],
                 [-9, -1, 0, 1, 9]).tocsc()
    _, pa = _pair(s)
    pd = ppar.DistBandedLU(pa, mesh=ppar.Mesh.virtual(8, "cpu"),
                           ordering=None)
    b = np.random.RandomState(2).rand(n)
    _close(pd.solve_host(b), spla.spsolve(s, b), 1e-10)
    _close(pd(b), spla.spsolve(s, b), 1e-10)


def test_guards():
    _, pa = _pair(_grid_system(400, seed=3))
    with pytest.raises(ValueError, match="chunks"):
        ppar.DistBandedLU(pa, mesh=ppar.Mesh.virtual(8, "cpu"), s=256)
    mesh = ppar.Mesh.virtual(2, "cpu")
    with pytest.raises(ValueError, match="reduced_store"):
        ppar.DistBandedLU.factor_device(pa, mesh=mesh, reduced_store="x")
    dk = ppar.DistBandedLU.factor_device(pa, mesh=mesh)
    with pytest.raises(ValueError, match="no host factor state"):
        dk.solve_host(np.ones(400))
    with pytest.raises(ValueError, match="positions"):
        pt.dist_banded_from_host(*([np.zeros(1)] * 9), 1, 8, 1, 2, 4, mesh)


# ---------------------------------------------------------------------------
# factor_device
# ---------------------------------------------------------------------------

# name -> (scipy matrix, P, keywords of factor_device, complex rhs)
DEVICE = {
    "symmetric_sharded_f32": (lambda: _grid_system(4000, seed=3), 8,
                              dict(reduced_store="sharded"), False),
    "symmetric_replicated_f64": (lambda: _grid_system(3000, seed=2), 8,
                                 dict(reduced_store="replicated",
                                      dtype=np.float64), False),
    "nonsymmetric_sharded_f64": (_nonsymmetric, 8,
                                 dict(ordering=None, s=64,
                                      reduced_store="sharded",
                                      dtype=np.float64), False),
    "nonsymmetric_replicated_f32": (_nonsymmetric, 8,
                                    dict(ordering=None, s=64,
                                         reduced_store="replicated"), False),
    "complex_sharded_f32": (_complex, 4, dict(reduced_store="sharded"),
                            True),
    "complex_replicated_f64": (_complex, 4, dict(reduced_store="replicated",
                                                 dtype=np.float64, s=72),
                               True),
}


@pytest.mark.parametrize("name", list(DEVICE))
def test_factor_device_matches_jax(name):
    make, P, kw, cplx = DEVICE[name]
    s = make()
    n = s.shape[0]
    ja, pa = _pair(s)
    jd = jpar.DistBandedLU.factor_device(ja, mesh=_jmesh(P), **kw)
    pd = ppar.DistBandedLU.factor_device(
        pa, mesh=ppar.Mesh.virtual(P, "cpu"), **kw)
    assert (pd.n, pd.s, pd.m, pd.P) == (jd.n, jd.s, jd.m, jd.P)
    assert pd._sym == jd._sym == (name.startswith("symmetric"))
    assert pd._r_sharded == (kw["reduced_store"] == "sharded")
    f32 = kw.get("dtype") is None
    rtol = F32_RTOL if f32 else F64_RTOL
    rng = np.random.RandomState(0)
    for B in (1, 8):
        b = rng.rand(n, B)
        if cplx:
            b = b + 1j * rng.rand(n, B)
        b = b[:, 0] if B == 1 else b
        if f32 and not cplx:
            b = b.astype(np.float32)
        x = pd(b)
        assert x.shape == b.shape and np.iscomplexobj(x) == cplx
        _close(x, jd(b), rtol)
        res = (np.linalg.norm(s @ x.astype(np.complex128 if cplx else
                                           np.float64) - b)
               / np.linalg.norm(b))
        assert res < (1e-4 if f32 else 1e-10)
