"""Gradients of the port's products and solves against ``jax.grad`` of the
JAX package on the same numpy inputs.

The JAX package differentiates its XLA code; the port gives each product
and each solve a ``torch.autograd.Function`` (``ops/matvec.py``,
``linalg/lu.py``) whose backward is the transposed product or the
transposed solve through the same factors.  The four gradients the JAX
package's own tests take:

* ``SpMVPlan`` with respect to x (``tests/test_matvec.py``), here also
  with respect to the plan's values (the ELL padding gets zero);
* ``RefactorPlan.refactor(d)(b)`` with respect to the matrix values d
  (``tests/test_refactor.py``), also against central differences;
* ``SolvePlan`` with respect to b (``tests/test_refactor.py``);
* ``MultifrontalRefactor.refactor(d)(b)`` with respect to d in float32
  (``tests/test_multifrontal.py``);

plus the eager ``spmv`` / ``spmm``.  float64 cases agree to rtol 1e-8 (the
two packages sum in different orders); the float32 multifrontal case to
rtol 1e-4: the port factors in float32, the JAX package promotes to the
host factors' float64.  ``torch.autograd.gradcheck`` covers what the JAX
package has no test of: (n, k) and batched right-hand sides, complex
values (the conjugate-Wirtinger convention), the supernodal refactor (in
its fast mode, random projections of the Jacobian, for the refactor
solves).  A call with no input that requires a gradient stays under
inference mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu import linalg as jlin
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu_torch import linalg as plin
from csparse3_tpu_torch.models import grids as pgrids

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-8


def _rand(m, n, density, seed):
    a = sp.random(m, n, density=density, format="csc",
                  random_state=np.random.RandomState(seed))
    a.sum_duplicates()
    return a


def _grid_system(mod, grids, n, seed):
    """B' + 3I of synthetic_grid(n, seed) in either package."""
    g = grids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    eye = mod.from_triplets(np.arange(n), np.arange(n), np.full(n, 3.0),
                            (n, n))
    return mod.from_triplets(rows, cols, vals, (n, n)) + eye


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spmv_case():
    """The JAX package's SpMVPlan case (20 x 20, seed 5) with its gradients
    of sum(plan(x) ** 2) in the plan's values and in x."""
    a = _rand(20, 20, 0.2, 5)
    x = np.random.RandomState(5).randn(20)
    plan = jt.SpMVPlan(jt.CSC.from_scipy(a))
    leaves, treedef = jax.tree_util.tree_flatten(plan)

    def loss(vals, x):
        p = jax.tree_util.tree_unflatten(treedef, leaves[:-1] + [vals])
        return jnp.sum(p(x) ** 2)

    gv, gx = jax.grad(loss, argnums=(0, 1))(plan.vals, jnp.asarray(x))
    return a, x, np.asarray(gv), np.asarray(gx)


def test_spmv_plan_grad_matches_jax(spmv_case):
    a, x, gv_ref, gx_ref = spmv_case
    plan = pt.SpMVPlan(pt.CSC.from_scipy(a), device="cpu")
    assert plan.layout == "ell"
    plan.vals.requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    gv, gx = torch.autograd.grad((plan(xt) ** 2).sum(), (plan.vals, xt))
    _close(gx, gx_ref)
    _close(gx, 2 * a.T @ (a @ x))
    live = plan.live_slots()
    _close(gv[live], gv_ref[live.numpy()])
    assert not gv[~live].any()


@pytest.mark.parametrize("layout", ["ell", "stream"])
def test_spmv_plan_gradcheck(layout):
    a = _rand(12, 9, 0.3, 8)
    plan = pt.SpMVPlan(pt.CSC.from_scipy(a), layout=layout, device="cpu")
    X = torch.randn(9, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(plan, (X,))
    if layout == "stream":
        v0 = plan.vals.detach().clone().requires_grad_()

        def with_vals(v, X):
            plan.vals = v
            return plan(X)

        assert torch.autograd.gradcheck(with_vals, (v0, X))


@pytest.fixture(scope="module")
def eager_case():
    a = _rand(30, 25, 0.15, 11)
    A = jt.CSC.from_scipy(a)
    ip, ix, d = A.np_arrays()
    rng = np.random.RandomState(12)
    x, X = rng.randn(25), rng.randn(25, 4)

    def loss(prod):
        return lambda d, x: jnp.sum(prod(jt.CSC(30, 25, ip, ix, d), x) ** 2)

    refs = {name: jax.jit(jax.grad(loss(prod), argnums=(0, 1)))(
                jnp.asarray(d), jnp.asarray(v))
            for name, prod, v in (("spmv", jt.spmv, x), ("spmm", jt.spmm, X))}
    return (ip, ix, d), x, X, refs


@pytest.mark.parametrize("name", ["spmv", "spmm"])
def test_eager_product_grads_match_jax(eager_case, name):
    (ip, ix, d), x, X, refs = eager_case
    dt = torch.tensor(d, requires_grad=True)
    v = torch.tensor(x if name == "spmv" else X, requires_grad=True)
    a = pt.CSC(30, 25, torch.as_tensor(ip), torch.as_tensor(ix), dt,
               device="cpu")
    prod = pt.spmv if name == "spmv" else pt.spmm
    gd, gv = torch.autograd.grad((prod(a, v) ** 2).sum(), (dt, v))
    _close(gd, refs[name][0])
    _close(gv, refs[name][1])


def test_eager_products_gradcheck_complex():
    a = _rand(10, 8, 0.4, 13)
    ip, ix, d = a.indptr, a.indices, a.data * (1 + 0.7j)

    def f(d, x):
        return pt.spmv(pt.CSC(10, 8, torch.as_tensor(ip),
                              torch.as_tensor(ix), d, device="cpu"), x)

    dt = torch.tensor(d, requires_grad=True)
    for x in (torch.randn(8, dtype=torch.complex128, requires_grad=True),
              torch.randn(8, 2, dtype=torch.float64, requires_grad=True)):
        assert torch.autograd.gradcheck(f, (dt, x))


def test_no_grad_inputs_stay_in_inference_mode():
    a = pt.CSC.from_scipy(_rand(10, 10, 0.3, 14), device="cpu")
    x = torch.randn(10, dtype=torch.float64)
    for y in (pt.spmv(a, x), pt.SpMVPlan(a, device="cpu")(x)):
        assert y.is_inference() and not y.requires_grad
    b = torch.randn(10, dtype=torch.float64)
    A = pt.CSC.from_scipy((_rand(10, 10, 0.3, 15) + sp.eye(10) * 4).tocsc(),
                          device="cpu")
    assert plin.splu(A).solve_plan(device="cpu")(b).is_inference()


@pytest.mark.parametrize("name", ["spmv", "ell"])
def test_inplace_change_of_x_after_forward_raises(name):
    """Only the values require a gradient; x is saved all the same, so
    autograd's version check catches x changed before the backward."""
    a = pt.CSC.from_scipy(_rand(10, 10, 0.3, 16), device="cpu")
    x = torch.randn(10, dtype=torch.float64)
    if name == "ell":
        plan = pt.SpMVPlan(a, device="cpu")
        vals = plan.vals.requires_grad_()
        y = plan(x)
    else:
        vals = a.data.detach().clone().requires_grad_()
        y = pt.spmv(pt.CSC(10, 10, a.indptr, a.indices, vals,
                           device="cpu"), x)
    x.add_(1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        torch.autograd.grad(y.sum(), vals)


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refactor_case():
    """The JAX package's refactor-gradient case (B' + 3I of a synthetic
    grid, seed 1, b from RandomState(0), d the matrix values) at 60 buses
    where the JAX test takes 200, for the suite's clock."""
    n = 60
    Aj = _grid_system(jt, jgrids, n, 1)
    b = np.random.RandomState(0).rand(n)
    data = np.asarray(Aj.np_arrays()[2])
    rp = jlin.splu(Aj).refactor_plan(Aj)
    grad = jax.jit(jax.grad(lambda rp, d: jnp.sum(rp.refactor(d)(b) ** 2),
                            argnums=1))(rp, jnp.asarray(data))
    return n, b, data, np.asarray(grad)


def test_refactor_values_grad_matches_jax(refactor_case):
    n, b, data, gref = refactor_case
    A = _grid_system(pt, pgrids, n, 1)
    np.testing.assert_array_equal(A.np_arrays()[2], data)
    rp = plin.splu(A).refactor_plan(A, device="cpu")
    bt = torch.tensor(b)

    def loss(d):
        return (rp.refactor(d)(bt) ** 2).sum()

    d = torch.tensor(data, requires_grad=True)
    g, = torch.autograd.grad(loss(d), d)
    _close(g, gref)
    eps = 1e-6
    for k in (0, 7, 50):
        up, dn = data.copy(), data.copy()
        up[k] += eps
        dn[k] -= eps
        fd = (float(loss(torch.tensor(up))) - float(loss(torch.tensor(dn))))
        np.testing.assert_allclose(float(g[k]), fd / (2 * eps), rtol=1e-5)


@pytest.fixture(scope="module")
def rhs_case():
    a = (_rand(80, 80, 0.06, 9) + sp.diags(np.full(80, 4.0))).tocsc()
    b = np.random.RandomState(1).rand(80)
    plan = jlin.splu(jt.CSC.from_scipy(a)).solve_plan()
    g = jax.jit(jax.grad(lambda p, bb: jnp.sum(p(bb) ** 2), argnums=1))(
        plan, jnp.asarray(b))
    return a, b, np.asarray(g)


def test_solve_rhs_grad_matches_jax(rhs_case):
    a, b, gref = rhs_case
    plan = plin.splu(pt.CSC.from_scipy(a)).solve_plan(device="cpu")
    bt = torch.tensor(b, requires_grad=True)
    g, = torch.autograd.grad((plan(bt) ** 2).sum(), bt)
    _close(g, gref)
    x = spla.spsolve(a, b)
    _close(g, 2.0 * spla.spsolve(a.T.tocsc(), x))


@pytest.fixture(scope="module")
def multifrontal_case():
    """The JAX package's multifrontal case (B' + 3I of a synthetic grid,
    seed 7, float32 values and b) at 30 buses where the JAX test takes 120:
    its jitted gradient compiles one front group at a time."""
    n = 30
    Aj = _grid_system(jt, jgrids, n, 7)
    mf = jlin.MultifrontalRefactor(jlin.splu(Aj, ordering="amd",
                                             tol=0.0)._h, Aj)
    d0 = np.asarray(Aj.np_arrays()[2], np.float32)
    b = np.random.RandomState(1).rand(n).astype(np.float32)
    g = jax.jit(jax.grad(lambda mf, d: jnp.sum(mf.refactor(d)(b) ** 2),
                         argnums=1))(mf, jnp.asarray(d0))
    return n, d0, b, np.asarray(g)


def test_multifrontal_values_grad_matches_jax(multifrontal_case):
    n, d0, b, gref = multifrontal_case
    A = _grid_system(pt, pgrids, n, 7)
    mf = plin.MultifrontalRefactor(plin.splu(A, ordering="amd",
                                             tol=0.0)._h, A, device="cpu")
    d = torch.tensor(d0, requires_grad=True)
    g, = torch.autograd.grad((mf.refactor(d)(torch.tensor(b)) ** 2).sum(), d)
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    _close(g, gref, rtol=1e-4)


def _small(n=16, cplx=False):
    A = _grid_system(pt, pgrids, n, 2)
    ip, ix, d = A.np_arrays()
    d = d * (1 + 0.3j) if cplx else d
    return pt.CSC(n, n, ip, ix, d, device="cpu")


@pytest.mark.parametrize("kind", ["level", "supernodal", "multifrontal"])
def test_refactor_solve_gradcheck(kind):
    A = _small()
    if kind == "level":
        plan = plin.splu(A).refactor_plan(A, device="cpu")
    else:
        cls = (plin.SupernodalRefactor if kind == "supernodal"
               else plin.MultifrontalRefactor)
        plan = cls(plin.splu(A, ordering="amd", tol=0.0)._h, A,
                   device="cpu")
    d = torch.tensor(A.np_arrays()[2], requires_grad=True)
    B = torch.randn(16, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda d, B: plan.refactor(d)(B), (d, B),
                                    fast_mode=True)


def test_batched_and_complex_solve_gradcheck():
    A = _small()
    rp = plin.splu(A).refactor_plan(A, device="cpu")
    d = torch.tensor(A.np_arrays()[2])
    D = torch.stack([d, 1.3 * d]).requires_grad_()
    Bk = torch.randn(2, 16, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda D, B: rp.refactor(D)(B), (D, Bk),
                                    fast_mode=True)
    Ac = _small(12, cplx=True)
    lu = plin.splu(Ac)
    rpc = lu.refactor_plan(Ac, device="cpu")
    dc = torch.tensor(Ac.np_arrays()[2], requires_grad=True)
    bc = torch.randn(12, dtype=torch.complex128, requires_grad=True)
    assert torch.autograd.gradcheck(lambda d, b: rpc.refactor(d)(b), (dc, bc),
                                    fast_mode=True)
    assert torch.autograd.gradcheck(lu.solve_plan(device="cpu"), (bc,))


def test_plans_built_under_inference_mode_still_differentiate():
    A = _small()
    with torch.inference_mode():
        rp = plin.splu(A).refactor_plan(A, device="cpu")
        rp.refactor(torch.tensor(A.np_arrays()[2]))  # a refactor in between
    d = torch.tensor(A.np_arrays()[2], requires_grad=True)
    b = torch.randn(16, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda d, b: rp.refactor(d)(b), (d, b),
                                    fast_mode=True)
    with torch.inference_mode():
        plan = rp.refactor(d)
    assert plan.values is None and plan._adjoint_fn is None
