"""Parity of the port's Schur-complement direct solve
(``csparse3_tpu_torch/parallel/schur.py``) with the JAX package's, on the
same numpy inputs: the host build and ``solve_host``, the one-device
``device_plan().solve`` and the mesh ``dist_solve``, on the JAX package's
own test system (B' + 3I of a synthetic grid in RCM order, as
``tests/test_schur.py``, here at n = 600).

Tolerances, float64: the interface, its size and the shard interiors
exact; solutions within 1e-10 of max|x| (``SOLVE_RTOL``), the JAX package
jitted once per module on the 8 virtual CPU devices of
``tests/conftest.py``, the port on ``Mesh.virtual(S, "cpu")``.
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
from csparse3_tpu.linalg.ordering import rcm
from csparse3_tpu.models.grids import synthetic_grid
from csparse3_tpu_torch import parallel as ppar

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

N = 600
SOLVE_RTOL = 1e-10


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _grid_matrix(n, seed=2):
    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = jt.from_triplets(rows, cols, vals, (n, n))
    A = jt.add(B, jt.diags(np.full(n, 3.0)))
    p = rcm(A)
    return A[p, p].to_scipy().tocsc()


@pytest.fixture(scope="module")
def refs():
    """Per shard count S: (scipy matrix, JAX SchurLU, port SchurLU, the
    JAX package's host, one-device and mesh solutions of b (N, 3))."""
    s = _grid_matrix(N)
    b = np.random.RandomState(0).randn(N, 3)
    out = {}
    for S in (4, 8):
        jl = jpar.SchurLU(jt.CSC.from_scipy(s), S=S)
        pl = ppar.SchurLU(pt.CSC.from_scipy(s, device="cpu"), S=S)
        plan = jl.device_plan()
        mesh = JMesh(np.array(jax.devices()[:S]), ("shards",))
        one = np.asarray(jax.jit(plan)(b)) if S == 4 else None
        dist = np.asarray(jax.jit(lambda v: plan.dist_solve(v, mesh))(b))
        out[S] = (s, b, jl, pl, jl.solve_host(b), one, dist)
    return out


@pytest.mark.parametrize("S", [4, 8])
def test_host_build_and_solve_match_jax(refs, S):
    s, b, jl, pl, host, _, _ = refs[S]
    assert pl.n_interface == jl.n_interface and 0 < pl.n_interface < N
    assert np.array_equal(pl.gamma, jl.gamma)
    assert pl.mi == jl.mi
    assert all(np.array_equal(a, c) for a, c in zip(pl.interiors,
                                                     jl.interiors))
    assert not pl.is_singular and pl.fill == jl.fill
    _close(pl.solve_host(b), host, SOLVE_RTOL)
    _close(pl.solve_host(b[:, 0]), host[:, 0], SOLVE_RTOL)
    _close(pl.solve_host(b), spla.spsolve(s, b), 1e-9)


def test_device_plan_solve_matches_jax(refs):
    s, b, _, pl, _, one, _ = refs[4]
    plan = pl.device_plan(device="cpu")
    assert plan.device == torch.device("cpu")
    _close(plan.solve(b), one, SOLVE_RTOL)
    _close(plan(b[:, 1]), one[:, 1], SOLVE_RTOL)


@pytest.mark.parametrize("S", [4, 8])
def test_dist_solve_matches_jax(refs, S):
    s, b, _, pl, _, _, dist = refs[S]
    plan = pl.device_plan(device="cpu")
    mesh = ppar.Mesh.virtual(S, "cpu", axis="shards")
    x = plan.dist_solve(b, mesh)
    assert x.device == torch.device("cpu")
    _close(x, dist, SOLVE_RTOL)
    _close(plan.dist_solve(b[:, 2], mesh), dist[:, 2], SOLVE_RTOL)
    # the mesh's own axis name, given explicitly
    rows = ppar.Mesh.virtual(S, "cpu")
    _close(plan.dist_solve(b, rows, axis="rows"), dist, SOLVE_RTOL)


def test_dist_solve_checks_mesh(refs):
    pl = refs[4][3]
    plan = pl.device_plan(device="cpu")
    b = np.ones(N)
    with pytest.raises(ValueError, match="has 8 devices but the plan was "
                                         "built for S=4 shards"):
        plan.dist_solve(b, ppar.Mesh.virtual(8, "cpu", axis="shards"))
    with pytest.raises(ValueError, match="axis"):
        plan.dist_solve(b, ppar.Mesh.virtual(4, "cpu"))


def test_interface_cap_raises():
    s = _grid_matrix(N)
    p = np.random.RandomState(0).permutation(N)
    a = pt.CSC.from_scipy(s[p][:, p], device="cpu")
    with pytest.raises(ValueError, match="interface has .* rows"):
        ppar.SchurLU(a, S=8, max_interface=50)


def test_fully_decoupled_raises():
    blocks = sp.block_diag([sp.eye(50) * 2.0, sp.eye(50) * 3.0]).tocsc()
    with pytest.raises(ValueError, match="no cross-shard entries"):
        ppar.SchurLU(pt.CSC.from_scipy(blocks, device="cpu"), S=2)
