"""Gradients through the port's distributed layer
(``csparse3_tpu_torch/parallel``), against ``jax.grad`` of the JAX
package on the same numpy inputs.

* ``dist_spmv`` / ``dist_spmm`` / ``spmv_local``: in x and in the
  partition's values, a tensor of the (S, G, E) / (S, E) layout given by
  ``RowPartition.with_values`` (the JAX package's ``e_vals`` pytree leaf),
  compared entry by entry, padding slots included; the ring strategy at
  halo radius k = 1 and 2 and the all-gather strategy;
* ``SchurSolvePlan.solve`` / ``__call__`` / ``dist_solve``: in b, on the
  JAX package's Schur test system made structurally non-symmetric (its
  backward needs the interior solves transposed; the symmetric system
  would hide a missing transpose);
* ``DistBandedLU.solve_blocks``: in the block right-hand sides, for the
  host factor and for ``factor_device`` (symmetric, non-symmetric, and
  the real embedding of a complex matrix).

The systems are those of the JAX package's own tests
(``tests/test_parallel.py``, ``test_schur.py``, ``test_dist_banded.py``)
cut to a few hundred rows.  The JAX side runs on the 8 virtual CPU
devices of ``tests/conftest.py``, each gradient jitted once; the port on
``Mesh.virtual(S, "cpu")``.  float64, rtol 1e-8 of the largest entry.
``torch.autograd.gradcheck`` covers complex right-hand sides (the
conjugate-Wirtinger convention), which the JAX package's real systems do
not reach.
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
from csparse3_tpu.linalg.ordering import rcm
from csparse3_tpu.models.grids import synthetic_grid
from csparse3_tpu_torch import parallel as ppar

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-8


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _jmesh(k, axis="rows"):
    return JMesh(np.array(jax.devices()[:k]), (axis,))


def _pair(s):
    return jt.CSC.from_scipy(s), pt.CSC.from_scipy(s, device="cpu")


def banded_spd(n, bw=5, seed=0):
    """SPD banded matrix, as ``tests/test_parallel.py``."""
    rng = np.random.RandomState(seed)
    diags, offs = [], []
    for off in range(1, bw + 1):
        v = -rng.rand(n - off)
        diags += [v, v]
        offs += [off, -off]
    a = sp.diags(diags, offs, shape=(n, n), format="csc")
    d = -np.asarray(a.sum(axis=1)).ravel() + 0.1
    return (a + sp.diags(d)).tocsc()


# ---------------------------------------------------------------------------
# dist_spmv / dist_spmm / spmv_local
# ---------------------------------------------------------------------------

def _unstructured(n=160, seed=4):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=0.04, random_state=rng, format="csc")
    return (a + sp.eye(n)).tocsc()


#: name: (matrix, S, strategy, halo radius, right-hand-side columns)
SPMV = {
    "ring_k1": (lambda: banded_spd(200, bw=5), 8, "ring", 1, None),
    "ring_k2": (lambda: banded_spd(200, bw=40, seed=1), 8, "ring", 2, None),
    "allgather": (_unstructured, 8, "allgather", None, None),
    "ring_k1_spmm": (lambda: banded_spd(200, bw=5, seed=2), 8, "ring", 1,
                     3),
}


@pytest.fixture(scope="module")
def spmv_refs():
    """Per case: the port's partition, x, the loss weights and the JAX
    package's gradients in x and in e_vals."""
    out = {}
    for name, (make, S, strategy, k, B) in SPMV.items():
        ja, pa = _pair(make())
        jp = jpar.partition_rows(ja, S)
        pp = ppar.partition_rows(pa, S)
        assert jp.strategy == pp.strategy == strategy
        assert k is None or jp.k == k
        rng = np.random.RandomState(7)
        shape = (ja.m,) if B is None else (ja.m, B)
        x = rng.randn(*shape)
        w = rng.randn(pp.m_pad, *shape[1:])
        mesh = _jmesh(S)

        def loss(ev, x):
            part = type(jp)(jp.m, jp.n, jp.S, jp.mloc, jp.k, jp.strategy,
                            jp.e_rows, jp.e_cols, ev)
            return jnp.sum(w * jpar.dist_spmv(part, x, mesh))

        gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp.e_vals,
                                                         jnp.asarray(x))
        out[name] = (pp, x, w, np.asarray(gx), np.asarray(gv))
    return out


@pytest.mark.parametrize("entry", ["dist_spmv", "spmv_local"])
@pytest.mark.parametrize("name", sorted(SPMV))
def test_dist_spmv_grad_matches_jax(spmv_refs, name, entry):
    pp, x, w, gx_ref, gv_ref = spmv_refs[name]
    mesh = ppar.Mesh.virtual(pp.S, "cpu")
    xt = torch.tensor(x, requires_grad=True)
    ev = torch.tensor(pp.e_vals, requires_grad=True)
    part = pp.with_values(ev)
    if entry == "dist_spmv":
        f = ppar.dist_spmm if x.ndim == 2 else ppar.dist_spmv
        y = f(part, xt, mesh)
    else:
        xs = mesh.scatter(part.pad_vector(xt), part.mloc)
        y = torch.cat(ppar.spmv_local(part, xs, mesh))
    gx, gv = torch.autograd.grad((torch.as_tensor(w) * y).sum(), (xt, ev))
    _close(gx, gx_ref)
    _close(gv, gv_ref)


def test_dist_spmv_without_grad_stays_in_inference_mode(spmv_refs):
    pp, x, _, _, _ = spmv_refs["ring_k1"]
    mesh = ppar.Mesh.virtual(pp.S, "cpu")
    assert ppar.dist_spmv(pp, x, mesh).is_inference()
    # values held as a tensor that needs no gradient: the same
    part = pp.with_values(torch.as_tensor(pp.e_vals))
    assert ppar.dist_spmv(part, torch.as_tensor(x), mesh).is_inference()
    with pytest.raises(ValueError, match="values of shape"):
        pp.with_values(torch.zeros(3))


@pytest.fixture(scope="module")
def jacobi_refs():
    """The port's partition, x, weights, and per preconditioner the port's
    and the JAX package's gradient of ``apply_local`` under ``shard_map``
    in x (the JAX side of both in one jitted program)."""
    ja, pa = _pair(banded_spd(200, bw=5, seed=3))
    jp, pp = jpar.partition_rows(ja, 8), ppar.partition_rows(pa, 8)
    rng = np.random.RandomState(4)
    x, w = rng.randn(2, pp.m_pad)
    mesh = _jmesh(8)
    names = ("BlockJacobi", "DiagJacobi")
    jprecs = [getattr(jpar, name).build(ja, jp) for name in names]

    def loss(v):
        return sum(jnp.sum(w * jax.shard_map(
            lambda p, u: p.apply_local(u), mesh=mesh,
            in_specs=(p.specs("rows"), JP("rows")),
            out_specs=JP("rows"))(p, v)) * (k + 1)
            for k, p in enumerate(jprecs))

    ref = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))
    return pp, x, w, ref, [getattr(ppar, name).build(pa, pp)
                           for name in names]


def test_jacobi_apply_local_grad_matches_jax(jacobi_refs):
    """``BlockJacobi.apply_local`` (a solve per position) and
    ``DiagJacobi.apply_local`` (a scaling), as one weighted loss."""
    pp, x, w, ref, precs = jacobi_refs
    mesh = ppar.Mesh.virtual(pp.S, "cpu")
    xt = torch.tensor(x, requires_grad=True)
    loss = sum((torch.as_tensor(w) * torch.cat(p.apply_local(
        mesh.scatter(xt, pp.mloc)))).sum() * (k + 1)
        for k, p in enumerate(precs))
    g, = torch.autograd.grad(loss, xt)
    _close(g, ref)


# ---------------------------------------------------------------------------
# SchurSolvePlan
# ---------------------------------------------------------------------------

def _grid_matrix(n, seed=2):
    """B' + 3I of synthetic_grid(n), RCM-ordered, as
    ``tests/test_schur.py``."""
    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = jt.from_triplets(rows, cols, vals, (n, n))
    A = jt.add(B, jt.diags(np.full(n, 3.0)))
    p = rcm(A)
    return A[p, p].to_scipy().tocsc()


def _nonsymmetric_grid(n, seed=2):
    """The grid matrix with entries added above the diagonal only: a
    structurally non-symmetric matrix (A^T's interiors differ from A's)."""
    a = _grid_matrix(n, seed).tolil()
    rng = np.random.RandomState(seed)
    for i in range(0, n - 3, 7):
        a[i, i + 3] += 0.2 * rng.rand()
    return a.tocsc()


@pytest.fixture(scope="module")
def schur_refs():
    """The port's SchurLU of the non-symmetric system, b (N, 2), weights,
    and the JAX package's gradient of the one-device and the mesh solve in
    b (each compile takes 5-10 s: one system, two shards)."""
    n, S = 300, 2
    ja, pa = _pair(_nonsymmetric_grid(n))
    plan = jpar.SchurLU(ja, S=S).device_plan()
    rng = np.random.RandomState(3)
    b, w = rng.randn(n, 2), rng.randn(n, 2)
    mesh = _jmesh(S, "shards")
    one = jax.jit(jax.grad(lambda b: jnp.sum(w * plan.solve(b))))(b)
    dist = jax.jit(jax.grad(lambda b: jnp.sum(
        w * plan.dist_solve(b, mesh))))(b)
    return (ppar.SchurLU(pa, S=S), b, w, np.asarray(one), np.asarray(dist))


@pytest.mark.parametrize("entry", ["solve", "__call__", "dist_solve"])
def test_schur_solve_grad_matches_jax(schur_refs, entry):
    pl, b, w, one, dist = schur_refs
    plan = pl.device_plan(device="cpu")
    bt = torch.tensor(b, requires_grad=True)
    if entry == "dist_solve":
        mesh = ppar.Mesh.virtual(pl.S, "cpu", axis="shards")
        x, ref = plan.dist_solve(bt, mesh), dist
    else:
        x, ref = getattr(plan, entry)(bt), one
    g, = torch.autograd.grad((torch.as_tensor(w) * x).sum(), bt)
    _close(g, ref)


def test_schur_complex_rhs_gradcheck(schur_refs):
    """A complex b on the non-symmetric system: A^{-H} g, the conjugate
    of the transposed solve, for one device, a mesh, and one column."""
    pl = schur_refs[0]
    plan = pl.device_plan(device="cpu")
    mesh = ppar.Mesh.virtual(pl.S, "cpu", axis="shards")
    rng = np.random.RandomState(5)
    b = torch.tensor(rng.randn(pl.n, 2) + 1j * rng.randn(pl.n, 2),
                     requires_grad=True)
    assert torch.autograd.gradcheck(plan.solve, (b,), fast_mode=True)
    assert torch.autograd.gradcheck(lambda v: plan.dist_solve(v, mesh),
                                    (b[:, 0].detach().requires_grad_(),),
                                    fast_mode=True)
    assert plan.solve(b.detach()).is_inference()


# ---------------------------------------------------------------------------
# DistBandedLU.solve_blocks
# ---------------------------------------------------------------------------

def _grid_system(n, seed, shift=3.0):
    """B' + 3I of synthetic_grid(n, seed), as ``tests/test_dist_banded.py``
    (symmetric)."""
    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t, np.arange(n)])
    cols = np.concatenate([g.f, g.t, g.t, g.f, np.arange(n)])
    vals = np.concatenate([bp, bp, -bp, -bp, np.full(n, shift)])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()


def _nonsymmetric(n=400, seed=5):
    rng = np.random.RandomState(seed)
    return sp.diags([-rng.rand(n - 9), -rng.rand(n - 1), 4.0 + rng.rand(n),
                     -2 * rng.rand(n - 1), -0.3 * rng.rand(n - 9)],
                    [-9, -1, 0, 1, 9]).tocsc()


def _complex(n=150, seed=5):
    from csparse3_tpu.models import grids as jgrids

    Y, _, _ = jgrids.ybus(jgrids.synthetic_grid(n, seed=seed))
    return (Y.to_scipy() + sp.eye(n) * (2.0 + 0.3j)).tocsc()


#: name: (matrix, constructor, P)
BANDED = {
    "host_grid": (lambda: _grid_system(400, 2), "host", 4),
    "host_nonsymmetric": (_nonsymmetric, "host", 4),
    "device_grid": (lambda: _grid_system(400, 2), "device", 4),
    "device_nonsymmetric": (_nonsymmetric, "device", 4),
    "device_complex": (_complex, "device", 4),
}


def _build(pkg, a, how, mesh):
    if how == "host":
        return pkg.DistBandedLU(a, mesh=mesh)
    return pkg.DistBandedLU.factor_device(a, mesh=mesh, dtype=np.float64)


@pytest.fixture(scope="module")
def banded_refs():
    """Per case: the port's factor, the block right-hand side (nb, s, 2),
    weights, and the JAX package's gradient of ``solve_blocks`` in it."""
    out = {}
    for name, (make, how, P) in BANDED.items():
        ja, pa = _pair(make())
        jd = _build(jpar, ja, how, _jmesh(P))
        pd = _build(ppar, pa, how, ppar.Mesh.virtual(P, "cpu"))
        assert (pd.m, pd.s, pd.P) == (jd.m, jd.s, jd.P)
        rng = np.random.RandomState(9)
        nb = jd.m * P
        bb, w = rng.randn(2, nb, jd.s, 2)
        g = jax.jit(jax.grad(lambda bb: jnp.sum(w * jd.solve_blocks(bb))))(
            jnp.asarray(bb))
        out[name] = (pd, bb, w, np.asarray(g))
    return out


@pytest.mark.parametrize("name", sorted(BANDED))
def test_dist_banded_solve_blocks_grad_matches_jax(banded_refs, name):
    pd, bb, w, ref = banded_refs[name]
    m = pd.m
    bbs = [torch.tensor(bb[p * m:(p + 1) * m], requires_grad=True)
           for p in range(pd.P)]
    xs = pd.solve_blocks(bbs)
    loss = sum((torch.as_tensor(w[p * m:(p + 1) * m]) * x).sum()
               for p, x in enumerate(xs))
    got = torch.cat(torch.autograd.grad(loss, bbs))
    _close(got, ref)
    assert all(x.is_inference() for x in pd.solve_blocks(
        [b.detach() for b in bbs]))


def test_dist_banded_complex_rhs_gradcheck(banded_refs):
    """Complex block right-hand sides through the real host factor: the
    conjugate-Wirtinger gradient, by finite differences."""
    pd = banded_refs["host_nonsymmetric"][0]
    rng = np.random.RandomState(2)
    bbs = [torch.tensor(rng.randn(pd.m, pd.s, 1) + 1j * rng.randn(
        pd.m, pd.s, 1), requires_grad=True) for _ in range(pd.P)]
    assert torch.autograd.gradcheck(
        lambda *b: tuple(pd.solve_blocks(list(b))), bbs, fast_mode=True)
