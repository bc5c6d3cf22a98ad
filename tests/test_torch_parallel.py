"""Parity of the port's distributed layer (``csparse3_tpu_torch/parallel``:
the mesh collectives, ``partition_rows``, ``dist_spmv`` / ``dist_spmm``,
``dist_cg`` / ``dist_bicgstab`` with ``BlockJacobi`` / ``DiagJacobi``)
with the JAX package's on the same numpy inputs.

The JAX side runs on the 8 virtual CPU devices that ``tests/conftest.py``
sets up, each distributed call jitted once (eager ``shard_map`` retraces
on every call); the port runs on ``Mesh.virtual(S, "cpu")``.  The systems
are the JAX package's own test systems (``tests/test_parallel.py``).

Tolerances, float64 throughout:
- collectives: exact (copies, and sums of integer-valued floats);
- partitions: integer leaves exact, values bitwise;
- products: within 1e-12 of max|y| (``SPMV_RTOL``);
- Krylov solves: x within 1e-10 of max|x| (``SOLVE_RTOL``) and the same
  iteration count; one iteration apart only where the JAX package's last
  residual lies within 1e-3 relative of the stop threshold (the partial
  dots are added in another order).

F10: the JAX package's ``dist_cg`` drops a ``DiagJacobi`` (it passes only
a ``BlockJacobi`` into its loop); the port applies it, and its iterates
are held to the JAX package's single-device ``cg(M=jacobi_prec(A))``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu import parallel as jpar
from csparse3_tpu.linalg import iterative as jit_
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu_torch import parallel as ppar
from csparse3_tpu_torch.parallel import mesh as pmesh
from csparse3_tpu_torch.utils import interop

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

S = 8
SPMV_RTOL = 1e-12
SOLVE_RTOL = 1e-10
STOP_SLACK = 1e-3


def _jmesh(k=S, axis="rows"):
    return JMesh(np.array(jax.devices()[:k]), (axis,))


def _pmesh(k=S, axis="rows"):
    return ppar.Mesh.virtual(k, "cpu", axis=axis)


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def banded_spd(n, bw=5, seed=0):
    """SPD banded matrix (Laplacian-like), as ``tests/test_parallel.py``."""
    rng = np.random.RandomState(seed)
    diags, offs = [], []
    for off in range(1, bw + 1):
        v = -rng.rand(n - off)
        diags += [v, v]
        offs += [off, -off]
    a = sp.diags(diags, offs, shape=(n, n), format="csc")
    d = -np.asarray(a.sum(axis=1)).ravel() + 0.1
    return (a + sp.diags(d)).tocsc()


def _nonsymmetric():
    a = banded_spd(96, bw=3, seed=13).tolil()
    a[0, 5] += 0.3
    a[40, 44] -= 0.2
    return a.tocsc()


def _jacobi_system():
    """The JAX package's DiagJacobi test system: tridiagonal, n = 4096,
    a strongly varying diagonal."""
    n = 4096
    rng = np.random.RandomState(3)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    dv = 4.0 + 10.0 * rng.rand(n)
    vals = np.concatenate([dv, -np.ones(n - 1), -np.ones(n - 1)])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc(), rng


def _pair(s):
    return jt.CSC.from_scipy(s), pt.CSC.from_scipy(s, device="cpu")


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def _shard_mapped(fn, xs):
    f = jax.jit(jax.shard_map(fn, mesh=_jmesh(xs.shape[0]),
                              in_specs=JP("rows"), out_specs=JP("rows")))
    return np.asarray(f(jnp.asarray(xs)))


def _positions(xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ppermute_matches_lax(shift):
    xs = np.random.RandomState(0).rand(S, 5, 2)
    ref = _shard_mapped(lambda x: jax.lax.ppermute(
        x, "rows", [(i, (i + shift) % S) for i in range(S)]), xs)
    got = torch.stack(pmesh.ppermute(_positions(xs), shift))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_matches_lax(tiled):
    xs = np.random.RandomState(1).rand(S, 3, 2)
    ref = _shard_mapped(lambda x: jax.lax.all_gather(
        x[0], "rows", tiled=tiled)[None], xs)
    out = pmesh.all_gather(_positions(xs), tiled=tiled)
    assert np.array_equal(torch.stack(out).numpy(), ref)
    # positions on one device share the replicated result
    assert all(o is out[0] for o in out)


def test_psum_matches_lax():
    xs = np.random.RandomState(2).randint(-50, 50, (S, 4)).astype(float)
    ref = _shard_mapped(lambda x: jax.lax.psum(x, "rows"), xs)
    out = pmesh.psum(_positions(xs))
    assert np.array_equal(torch.stack(out).numpy(), ref)
    assert all(o is out[0] for o in out)


def test_mesh_layout_and_checks():
    m = ppar.Mesh(["cpu", "cpu", "cpu"], axis="shards")
    assert m.size == 3 and m.shape == {"shards": 3}
    assert m.axis_names == ("shards",)
    assert m.distinct == (torch.device("cpu"),)
    assert m.check_axis(None) == "shards" == m.check_axis("shards")
    with pytest.raises(ValueError, match="axis"):
        m.check_axis("rows")
    v = _pmesh(4)
    assert v.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        ppar.Mesh.virtual(0, "cpu")
    r = pmesh.replicate(torch.ones(3), v.devices)
    assert list(r) == [torch.device("cpu")]


def test_mesh_default_is_the_card():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in ppar.Mesh().devices)
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            ppar.Mesh()


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------

# name -> (scipy matrix, strategy asked for, strategy and k expected)
PARTS = {
    "ring_k1": (lambda: banded_spd(96, bw=3), None, "ring", 1),
    "ring_k2": (lambda: banded_spd(64, bw=12, seed=4), None, "ring", 2),
    "allgather_dense": (lambda: sp.random(
        64, 64, density=0.5, random_state=np.random.RandomState(3),
        format="csc"), None, "allgather", None),
    "allgather_forced": (lambda: banded_spd(100, bw=4, seed=1), "allgather",
                         "allgather", 1),
    "padded_rows": (lambda: banded_spd(50), None, "ring", 1),
}


@pytest.mark.parametrize("name", list(PARTS))
def test_partition_matches_jax(name):
    make, strategy, want, k = PARTS[name]
    ja, pa = _pair(make())
    jp_ = jpar.partition_rows(ja, S, strategy=strategy)
    pp_ = ppar.partition_rows(pa, S, strategy=strategy)
    assert pp_.strategy == jp_.strategy == want
    if k is not None:
        assert pp_.k == k
    assert (pp_.m, pp_.n, pp_.S, pp_.mloc, pp_.k, pp_.m_pad) == (
        jp_.m, jp_.n, jp_.S, jp_.mloc, jp_.k, jp_.m_pad)
    for name_ in ("e_rows", "e_cols", "e_vals"):
        ref = np.asarray(getattr(jp_, name_))
        got = getattr(pp_, name_)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name_
    # the vector helpers, on numpy and on tensors
    x = np.arange(pa.m, dtype=float)
    assert pp_.pad_vector(x).shape == (pp_.m_pad,)
    assert np.array_equal(pp_.trim_vector(pp_.pad_vector(x)), x)
    xt = torch.as_tensor(x)
    assert torch.equal(pp_.trim_vector(pp_.pad_vector(xt)), xt)


def test_partition_placement_checks_mesh():
    _, pa = _pair(banded_spd(96, bw=3))
    part = ppar.partition_rows(pa, S)
    with pytest.raises(ValueError, match="positions"):
        part.local(_pmesh(4))
    with pytest.raises(ValueError, match="square"):
        ppar.partition_rows(pt.CSC.from_scipy(sp.random(
            4, 5, density=0.5, format="csc"), device="cpu"), 2)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _complex_ybus(n, seed):
    Y, _, _ = jgrids.ybus(jgrids.synthetic_grid(n, seed=seed))
    return Y.to_scipy().tocsc()


# name -> (scipy matrix, strategy, right-hand sides (0: a vector), complex x)
SPMV = {
    "ring_k1_vector": (lambda: banded_spd(100, bw=4, seed=1), "ring", 0,
                       False),
    "ring_k2_spmm": (lambda: banded_spd(64, bw=12, seed=4), None, 5, False),
    "allgather_vector": (lambda: banded_spd(100, bw=4, seed=1), "allgather",
                         0, False),
    "allgather_complex_ybus": (lambda: _complex_ybus(120, 4), "allgather", 0,
                               True),
    "ring_complex_spmm": (lambda: _complex_ybus(120, 4), None, 3, True),
}


@pytest.mark.parametrize("name", list(SPMV))
def test_dist_spmv_matches_jax(name):
    make, strategy, B, cplx = SPMV[name]
    s = make()
    ja, pa = _pair(s)
    n = s.shape[0]
    rng = np.random.RandomState(5)
    x = rng.rand(n, B) if B else rng.rand(n)
    if cplx:
        x = x + 1j * rng.rand(*x.shape)
    jp_ = jpar.partition_rows(ja, S, strategy=strategy)
    pp_ = ppar.partition_rows(pa, S, strategy=strategy)
    mesh = _jmesh()
    ref = np.asarray(jax.jit(lambda p, v: jpar.dist_spmv(p, v, mesh))(
        jp_, jnp.asarray(x)))
    fn = ppar.dist_spmm if B else ppar.dist_spmv
    got = fn(pp_, x, _pmesh())
    assert got.shape == (pp_.m_pad,) + x.shape[1:]
    _close(got, ref, SPMV_RTOL)
    _close(pp_.trim_vector(got), s @ x, SPMV_RTOL)
    # the JAX partition's own fields, carried into the port
    carried = interop.row_partition_from_arrays(
        jp_.m, jp_.n, jp_.S, jp_.mloc, jp_.k, jp_.strategy,
        *(np.asarray(leaf) for leaf in (jp_.e_rows, jp_.e_cols, jp_.e_vals)))
    _close(fn(carried, x, _pmesh()), ref, SPMV_RTOL)


def test_spmv_local_composes():
    """The per-position product, from per-position slices."""
    s = banded_spd(96, bw=3)
    _, pa = _pair(s)
    part = ppar.partition_rows(pa, S)
    mesh = _pmesh()
    x = torch.as_tensor(part.pad_vector(np.random.RandomState(0).rand(96)))
    ys = ppar.spmv_local(part, mesh.scatter(x, part.mloc), mesh)
    assert len(ys) == S and all(y.shape == (part.mloc,) for y in ys)
    _close(torch.cat(ys)[:96], s @ x[:96].numpy(), SPMV_RTOL)


def test_dist_spmv_checks_axis():
    _, pa = _pair(banded_spd(96, bw=3))
    with pytest.raises(ValueError, match="axis"):
        ppar.dist_spmv(ppar.partition_rows(pa, S), np.ones(96), _pmesh(),
                       axis="shards")


# ---------------------------------------------------------------------------
# Krylov solves
# ---------------------------------------------------------------------------

# name -> (scipy matrix, solver, preconditioner, tol)
SOLVES = {
    "cg_plain": (lambda: banded_spd(100, bw=3, seed=11), "cg", None, 1e-10),
    "cg_block_jacobi": (lambda: banded_spd(128, bw=4, seed=12), "cg",
                        "block", 1e-10),
    "bicgstab_block_jacobi": (_nonsymmetric, "bicgstab", "block", 1e-10),
    "bicgstab_plain": (lambda: _jacobi_system()[0], "bicgstab", None, 1e-10),
}


def _same_count(got, ref, res_ref, bnorm, tol):
    if got == ref:
        return
    stop = bnorm * tol
    assert abs(got - ref) == 1 and abs(res_ref - stop) / stop < STOP_SLACK, (
        got, ref)


@pytest.mark.parametrize("name", list(SOLVES))
def test_dist_krylov_matches_jax(name):
    make, solver, prec, tol = SOLVES[name]
    s = make()
    ja, pa = _pair(s)
    n = s.shape[0]
    b = np.random.RandomState(7).rand(n)
    jp_ = jpar.partition_rows(ja, S)
    pp_ = ppar.partition_rows(pa, S)
    jpr = jpar.BlockJacobi.build(ja, jp_) if prec else None
    ppr = ppar.BlockJacobi.build(pa, pp_) if prec else None
    mesh = _jmesh()
    jfn = {"cg": jpar.dist_cg, "bicgstab": jpar.dist_bicgstab}[solver]
    pfn = {"cg": ppar.dist_cg, "bicgstab": ppar.dist_bicgstab}[solver]
    xj, rj, ij = jax.jit(lambda p, pr, v: jfn(p, v, mesh, prec=pr, tol=tol))(
        jp_, jpr, jnp.asarray(b))
    xp, rp, ip_ = pfn(pp_, b, _pmesh(), prec=ppr, tol=tol)
    assert isinstance(ip_, int) and xp.shape == (n,)
    _same_count(ip_, int(ij), float(rj), np.linalg.norm(b), tol)
    _close(xp, xj, SOLVE_RTOL)
    rel = np.linalg.norm(s @ xp.numpy() - b) / np.linalg.norm(b)
    assert rel < 10 * tol


def test_block_jacobi_plans_are_per_position():
    """One host factor a position, at its own size, applied per position."""
    s = banded_spd(128, bw=4, seed=12)
    _, pa = _pair(s)
    part = ppar.partition_rows(pa, S)
    prec = ppar.BlockJacobi.build(pa, part)
    assert len(prec.lus) == S and all(lu.n == part.mloc for lu in prec.lus)
    mesh = _pmesh()
    r = torch.as_tensor(np.random.RandomState(1).rand(part.m_pad))
    zs = prec.apply_local(mesh.scatter(r, part.mloc))
    for q, z in enumerate(zs):
        blk = s[q * 16:(q + 1) * 16, q * 16:(q + 1) * 16].toarray()
        _close(z, np.linalg.solve(blk, r[q * 16:(q + 1) * 16].numpy()),
               SOLVE_RTOL)


@pytest.fixture(scope="module")
def jacobi_refs():
    """The JAX package on the DiagJacobi test system: its single-device
    ``cg`` with and without ``jacobi_prec``, and its ``dist_cg`` with a
    ``DiagJacobi`` (which the fault drops)."""
    s, rng = _jacobi_system()
    b = rng.rand(s.shape[0])
    ja = jt.CSC.from_scipy(s)
    plan = jt.SpMVPlan(ja)
    M = jit_.jacobi_prec(ja)
    single = jax.jit(lambda v: jit_.cg(plan, v, M=M, tol=1e-10,
                                       maxiter=500))(jnp.asarray(b))
    jp_ = jpar.partition_rows(ja, S)
    mesh = _jmesh()
    dist = {
        name: jax.jit(lambda p, pr, v: jpar.dist_cg(
            p, v, mesh, prec=pr, tol=1e-10, maxiter=500))(
                jp_, pr, jnp.asarray(b))
        for name, pr in (("plain", None),
                         ("diag", jpar.DiagJacobi.build(ja, jp_)))}
    return s, b, single, dist


def test_diag_jacobi_preconditions_F10(jacobi_refs):
    s, b, (xs, rs, its), dist = jacobi_refs
    # the fault in the JAX package: its DiagJacobi changes nothing
    assert int(dist["diag"][2]) == int(dist["plain"][2])
    _, pa = _pair(s)
    part = ppar.partition_rows(pa, S)
    prec = ppar.DiagJacobi.build(pa, part)
    assert prec.dinv.shape == (S, part.mloc)
    x0, _, it0 = ppar.dist_cg(part, b, _pmesh(), tol=1e-10, maxiter=500)
    x1, r1, it1 = ppar.dist_cg(part, b, _pmesh(), prec=prec, tol=1e-10,
                               maxiter=500)
    # the port preconditions: the JAX package's single-device Jacobi CG
    assert it1 < it0
    assert it0 == int(dist["plain"][2])
    _same_count(it1, int(its), float(rs), np.linalg.norm(b), 1e-10)
    _close(x1, xs, SOLVE_RTOL)
    for x in (x0, x1):
        assert np.linalg.norm(s @ x.numpy() - b) / np.linalg.norm(b) < 1e-9
