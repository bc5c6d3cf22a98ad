"""Gradients through the plans that run hand kernels on the card, against
``jax.grad`` of the JAX package on the same numpy inputs.

The JAX package's plans are XLA code, so ``jax.grad`` differentiates them.
The port gives each a ``torch.autograd.Function`` whose backward is the
product with the transposed operand (through the same kernel on a card,
its plain version here) or the transposed solve through the same factors,
and leaves the values' gradients to plain torch, as XLA's autodiff leaves
them in the JAX package:

* ``DIAPlan`` / ``SymDIAPlan`` / ``SplitDIA`` / ``SplitSymDIA``: x and the
  dense slabs (the JAX ``SymDIAPlan`` pads its slabs to whole scan steps;
  the first D rows are the port's);
* ``SplitSpMV``: the parts and both plans' ELL values (live slots; the
  padding gets zero in the port);
* ``SpGEMMPlan.numeric`` and ``GramPlan.numeric``: the value arrays;
* ``BSR @ X`` (X and the block values, ragged edges included), ``spmm(A, X,
  block=)`` (X; the JAX package has no block option, so its entry-stream
  ``spmm``) and ``BSRMatMatPlan.numeric``;
* ``BandedLU`` (b), ``BandedRefactor`` (b and the values),
  ``BandedSolvePlan`` (b) and ``LDLTSolvePlan`` (b).

float64 throughout, held to rtol 1e-8 of the largest entry (the packages
sum in different orders).  ``torch.autograd.gradcheck`` covers what the
JAX package has no real-valued counterpart of: complex values (the
conjugate-Wirtinger convention), (n, B) and batched inputs, and the
symmetric plans' mirrored slab gradient.  ``SplitBandPoints`` (K1-K3: its
JAX plan is always a ``pallas_call``, which ``jax.grad`` refuses) gives no
gradient in either package.  The JAX references are computed once per
module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu import linalg as jlin
from csparse3_tpu.kernels import bandpoints as jbp
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.ops import bsr_ops as jbsr
from csparse3_tpu.ops import spgemm as jspg
from csparse3_tpu_torch import linalg as plin
from csparse3_tpu_torch.kernels import bandpoints as pbp
from csparse3_tpu_torch.kernels import dia as pdia
from csparse3_tpu_torch.ops import bsr_ops as pbsr
from csparse3_tpu_torch.ops.matvec import bsr_adjoint

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-8
N = 60
# buses of the banded plans' Ybus: at 60 its band is too full for an
# occupancy index (44% of the runs), at 300 it keeps one (20%)
N_BAND = 300


def _close(got, ref, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _t(a, grad=True):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _rcm_ybus(n=N_BAND, seed=3):
    """The RCM-ordered Ybus of synthetic_grid(n) (JAX CSC): complex
    symmetric, a sparse band."""
    g, _ = jgrids.rcm_grid(jgrids.synthetic_grid(n, seed=seed))
    return jgrids.ybus(g)[0]


def _real(Y, part="real"):
    ip, ix, v = Y.np_arrays()
    return jt.CSC(Y.m, Y.n, ip, ix, np.ascontiguousarray(getattr(v, part)))


def _port(A):
    ip, ix, v = A.np_arrays()
    return pt.CSC(A.m, A.n, ip, ix, v, device="cpu")


def _rect_band(m=40, n=50, seed=4):
    """A rectangular band with offsets -3 .. 5, dense in its band (no
    occupancy index)."""
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for o in range(-3, 6):
        i = np.arange(max(0, -o), min(m, n - o))
        rows.append(i)
        cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return jt.from_triplets(rows, cols, rng.randn(len(rows)), (m, n))


def _jax_grads(loss, plan, *args):
    """JAX: the gradients of ``loss(plan, *args)`` in the plan's float
    leaves (a list, in pytree order; its index arrays are left out) and in
    each of ``args``, jitted."""
    leaves, tree = jax.tree_util.tree_flatten(plan)
    fl = [i for i, v in enumerate(leaves)
          if np.issubdtype(np.asarray(v).dtype, np.inexact)]

    def f(vals, *args):
        ls = list(leaves)
        for i, v in zip(fl, vals):
            ls[i] = v
        return loss(jax.tree_util.tree_unflatten(tree, ls), *args)

    g = jax.jit(jax.grad(f, argnums=tuple(range(1 + len(args)))))(
        [jnp.asarray(leaves[i]) for i in fl], *map(jnp.asarray, args))
    return [np.asarray(v) for v in g[0]], *map(np.asarray, g[1:])


# the JAX symmetric plans unroll `chunk` diagonals per scan step: 8 keeps
# the jitted gradient's compile to seconds (64, the default, takes minutes
# for the split form); the port ignores `chunk`
JAX_SYM_CHUNK = 8


# ---------------------------------------------------------------------------
# banded plans (K4 on a card)
# ---------------------------------------------------------------------------

BAND_CASES = {
    # square RCM Ybus: an occupancy index on both the plan and its transpose
    "dia_ybus": (lambda: _real(_rcm_ybus()), "DIAPlan"),
    # rectangular, dense band: the dense route, m != n
    "dia_rect": (_rect_band, "DIAPlan"),
    "symdia_ybus": (lambda: _real(_rcm_ybus(), "imag"), "SymDIAPlan"),
}


@pytest.fixture(scope="module")
def band_refs():
    out = {}
    for name, (make, cls) in BAND_CASES.items():
        A = make()
        rng = np.random.RandomState(len(name))
        kw = dict(chunk=JAX_SYM_CHUNK) if cls == "SymDIAPlan" else {}
        for shape in ("vec", "mat"):
            x = rng.randn(A.n) if shape == "vec" else rng.randn(A.n, 3)
            (gs,), gx = _jax_grads(lambda p, x: jnp.sum(p(x) ** 2),
                                   getattr(jt, cls)(A, **kw), x)
            out[name, shape] = (A, x, gs, gx)
    return out


@pytest.mark.parametrize("shape", ["vec", "mat"])
@pytest.mark.parametrize("name", sorted(BAND_CASES))
def test_band_plan_grads_match_jax(band_refs, name, shape):
    A, x, gs_ref, gx_ref = band_refs[name, shape]
    plan = getattr(pt, BAND_CASES[name][1])(_port(A), device="cpu")
    if name == "dia_ybus":
        assert plan.has_runs and plan.transposed().has_runs
    if name == "dia_rect":
        assert not plan.has_runs
    plan.slabs.requires_grad_()
    xt = _t(x)
    gs, gx = torch.autograd.grad((plan(xt) ** 2).sum(), (plan.slabs, xt))
    _close(gx, gx_ref)
    S = A.to_scipy()
    _close(gx, 2 * S.T @ (S @ x))
    D = plan.ndiag
    _close(gs, gs_ref.reshape(-1, A.m)[:D])


def test_transpose_band_matches_scipy():
    for A in (_real(_rcm_ybus(30, 5)), _rect_band(), _rect_band(50, 40, 7)):
        plan = pt.DIAPlan(_port(A), device="cpu")
        ref = A.to_scipy().T.toarray()
        for fn in (pdia.transpose_band, pdia.transpose_band_plain):
            slabs, omin = fn(plan.slabs, plan.m, plan.n, plan.omin)
            assert slabs.shape == (plan.ndiag, plan.n)
            dense = np.zeros((plan.n, plan.m))
            for d in range(plan.ndiag):
                for j in range(plan.n):
                    if 0 <= j + omin + d < plan.m:
                        dense[j, j + omin + d] = slabs[d, j]
            np.testing.assert_array_equal(dense, ref)
        t = plan.transposed()
        assert (t.m, t.n) == (plan.n, plan.m) and plan.transposed() is t
        y = np.random.RandomState(1).randn(plan.m)
        _close(t(torch.tensor(y)), A.to_scipy().T @ y, 1e-14)


SPLIT_CASES = {"SplitDIA": _rcm_ybus, "SplitSymDIA": _rcm_ybus}


@pytest.fixture(scope="module")
def split_refs():
    out = {}
    for name, make in SPLIT_CASES.items():
        Y = make()
        rng = np.random.RandomState(7)
        xr, xi, w = rng.randn(Y.n), rng.randn(Y.n), rng.randn(Y.n)
        kw = dict(chunk=JAX_SYM_CHUNK) if name == "SplitSymDIA" else {}

        def loss(plan, xr, xi):
            yr, yi = plan(xr, xi)
            return jnp.sum(yr ** 2) + jnp.sum(w * yi ** 2)

        (gre, gim), gxr, gxi = _jax_grads(loss, getattr(jt, name)(Y, **kw),
                                          xr, xi)
        out[name] = (Y, xr, xi, w, gre, gim, gxr, gxi)
    return out


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_band_grads_match_jax(split_refs, name):
    Y, xr, xi, w, gre_ref, gim_ref, gxr_ref, gxi_ref = split_refs[name]
    plan = getattr(pt, name)(_port(Y), device="cpu")
    assert plan.shared_runs
    for p in (plan.re, plan.im):
        p.slabs.requires_grad_()
    xrt, xit = _t(xr), _t(xi)
    yr, yi = plan(xrt, xit)
    loss = (yr ** 2).sum() + (torch.tensor(w) * yi ** 2).sum()
    gre, gim, gxr, gxi = torch.autograd.grad(
        loss, (plan.re.slabs, plan.im.slabs, xrt, xit))
    _close(gxr, gxr_ref)
    _close(gxi, gxi_ref)
    D, m = plan.re.ndiag, plan.re.m
    _close(gre, gre_ref.reshape(-1, m)[:D])
    _close(gim, gim_ref.reshape(-1, m)[:D])
    # the adjoint pair: one shared index, im negated
    re, im, shared = plan.adjoint()
    assert shared
    np.testing.assert_array_equal(im.run_vals.numpy(),
                                  -pdia.pack_runs(
                                      im.slabs.neg(), im.n, im.omin,
                                      im.symmetric, im.runs)[0].numpy())


@pytest.fixture(scope="module")
def splitspmv_ref():
    Y = _rcm_ybus(40, 2)
    rng = np.random.RandomState(8)
    xr, xi = rng.randn(Y.n), rng.randn(Y.n)

    def loss(plan, xr, xi):
        yr, yi = plan(xr, xi)
        return jnp.sum(yr ** 2) + jnp.sum(yr * yi)

    (gre, gim), gxr, gxi = _jax_grads(loss, jt.SplitSpMV(Y), xr, xi)
    return Y, xr, xi, gre, gim, gxr, gxi


def test_split_spmv_grads_match_jax(splitspmv_ref):
    Y, xr, xi, gre_ref, gim_ref, gxr_ref, gxi_ref = splitspmv_ref
    plan = pt.SplitSpMV(_port(Y), device="cpu")
    assert plan.re.layout == "ell"
    for p in (plan.re, plan.im):
        p.vals.requires_grad_()
    xrt, xit = _t(xr), _t(xi)
    yr, yi = plan(xrt, xit)
    gre, gim, gxr, gxi = torch.autograd.grad(
        (yr ** 2).sum() + (yr * yi).sum(),
        (plan.re.vals, plan.im.vals, xrt, xit))
    _close(gxr, gxr_ref)
    _close(gxi, gxi_ref)
    live = plan.re.live_slots()
    for got, ref in ((gre, gre_ref), (gim, gim_ref)):
        _close(got[live], ref[live.numpy()])
        assert not got[~live].any()


def test_band_plans_gradcheck():
    """Complex values, (n, B) inputs, the symmetric forms' mirrored slab
    gradient and a batch (K, n) of the split forms."""
    torch.manual_seed(0)
    A = _rect_band(12, 15, 9)
    ip, ix, v = A.np_arrays()
    Ac = pt.CSC(12, 15, ip, ix, v * (1 + 0.6j), device="cpu")
    plan = pt.DIAPlan(Ac, device="cpu")
    s0 = plan.slabs.detach().clone().requires_grad_()
    xc = torch.randn(15, 2, dtype=torch.complex128, requires_grad=True)

    def with_slabs(plan):
        def f(s, x):
            plan.slabs = s
            return plan(x)
        return f

    assert torch.autograd.gradcheck(with_slabs(plan), (s0, xc))
    Y = _rcm_ybus(16, 1)
    sym = pt.SymDIAPlan(_port(_real(Y)), device="cpu")
    s1 = sym.slabs.detach().clone().requires_grad_()
    X = torch.randn(16, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(with_slabs(sym), (s1, X))
    for cls in (pt.SplitDIA, pt.SplitSymDIA):
        split = cls(_port(Y), device="cpu")
        xr = torch.randn(3, 16, dtype=torch.float64, requires_grad=True)
        xi = torch.randn(3, 16, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(split, (xr, xi))


def test_band_plans_built_under_inference_mode_still_differentiate():
    A = _port(_real(_rcm_ybus(20, 6)))
    with torch.inference_mode():
        plan = pt.DIAPlan(A, device="cpu")
        split = pt.SplitDIA(_port(_rcm_ybus(20, 6)), device="cpu")
    x = torch.randn(20, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(plan, (x,))
    assert torch.autograd.gradcheck(split, (x, x.detach().clone()
                                            .requires_grad_()))
    with torch.no_grad():
        y = plan(x)
    assert y.is_inference() and not y.requires_grad


# ---------------------------------------------------------------------------
# sparse products (K6 on a card)
# ---------------------------------------------------------------------------

def _conn(n, seed):
    g = jgrids.synthetic_grid(n, seed=seed)
    Cf, Ct = jgrids.connectivity(g)
    return Cf - Ct


@pytest.fixture(scope="module")
def spgemm_refs():
    C = _conn(N, 1)
    ip, ix, _ = C.np_arrays()
    rng = np.random.RandomState(3)
    a = rng.randn(len(ix))
    Cj = jt.CSC(C.m, C.n, ip, ix, a)
    Ctj = jt.transpose(Cj)
    b = rng.randn(Ctj.nnz)
    plan = jt.spgemm_symbolic(Cj, Ctj)
    w = rng.randn(plan.template.nnz)

    def loss(a, b):
        return jnp.sum(w * plan.numeric(a, b).data ** 2)

    ga, gb = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(a),
                                                    jnp.asarray(b))
    gplan = jspg.gram_symbolic(Cj)
    wg = rng.randn(gplan.template.nnz)
    gg = jax.jit(jax.grad(lambda a: jnp.sum(wg * gplan.numeric(a).data
                                            ** 2)))(jnp.asarray(a))
    return Cj, Ctj, a, b, w, wg, np.asarray(ga), np.asarray(gb), \
        np.asarray(gg)


def test_spgemm_plan_grads_match_jax(spgemm_refs):
    Cj, Ctj, a, b, w, _, ga_ref, gb_ref, _ = spgemm_refs
    plan = pt.spgemm_symbolic(_port(Cj), _port(Ctj), device="cpu")
    at, bt = _t(a), _t(b)
    out = plan.numeric(at, bt)
    ga, gb = torch.autograd.grad((torch.tensor(w) * out.data ** 2).sum(),
                                 (at, bt))
    _close(ga, ga_ref)
    _close(gb, gb_ref)
    # the maps sorted by entry: every product once, each run one entry
    seg_ptr, gid, _, _ = plan.grad_maps(0, len(a))
    assert int(seg_ptr[-1]) == plan.n_products
    assert torch.equal(gid, torch.repeat_interleave(
        torch.arange(len(a), dtype=torch.int32), seg_ptr.long().diff()))


def test_gram_plan_grads_match_jax(spgemm_refs):
    Cj, _, a, _, _, wg, _, _, gg_ref = spgemm_refs
    plan = pt.gram_symbolic(_port(Cj), device="cpu")
    at = _t(a)
    g, = torch.autograd.grad(
        (torch.tensor(wg) * plan.numeric(at).data ** 2).sum(), at)
    _close(g, gg_ref)


def test_spgemm_plans_gradcheck_complex():
    C = _conn(12, 2)
    ip, ix, v = C.np_arrays()
    rng = np.random.RandomState(5)
    A = pt.CSC(C.m, C.n, ip, ix, v, device="cpu")
    At = pt.transpose(A)
    plan = pt.spgemm_symbolic(A, At, device="cpu")
    gplan = pt.gram_symbolic(A, device="cpu")
    a = torch.tensor(rng.randn(len(ix)) * (1 + 0.4j), requires_grad=True)
    b = torch.tensor(rng.randn(len(ix)) * (1 - 0.3j), requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: plan.numeric(a, b).data,
                                    (a, b))
    assert torch.autograd.gradcheck(lambda a: gplan.numeric(a).data, (a,))
    with torch.no_grad():
        assert gplan.numeric(a).data.is_inference()


# ---------------------------------------------------------------------------
# block products (K5 on a card)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bsr_refs():
    S = sp.random(30, 44, density=0.15, format="csc",
                  random_state=np.random.RandomState(6))
    Aj = jt.CSC.from_scipy(S)
    Bj = Aj.to_bsr(block=(4, 8))
    rng = np.random.RandomState(2)
    X = rng.randn(44, 5)
    ip, ix, data = (np.asarray(a) for a in (Bj.indptr, Bj.indices, Bj.data))

    def loss(data, X):
        B = jt.BSR(Bj.m, Bj.n, Bj.R, Bj.C, ip, ix, data)
        return jnp.sum((B @ X) ** 2)

    gd, gX = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(data),
                                                    jnp.asarray(X))
    gS = jax.jit(jax.grad(lambda X: jnp.sum(jt.spmm(Aj, X) ** 2)))(
        jnp.asarray(X))
    # block x block: A (30 x 44, 4 x 8 blocks) @ B (44 x 24, 8 x 6 blocks)
    S2 = sp.random(44, 24, density=0.2, format="csc",
                   random_state=np.random.RandomState(7))
    B2j = jt.CSC.from_scipy(S2).to_bsr(block=(8, 6))
    mm = jbsr.BSRMatMatPlan(Bj, B2j)
    a_d, b_d = np.asarray(Bj.data), np.asarray(B2j.data)
    gmm = jax.jit(jax.grad(lambda a, b: jnp.sum(mm.numeric(a, b).data ** 2),
                           argnums=(0, 1)))(jnp.asarray(a_d),
                                            jnp.asarray(b_d))
    return (S, X, data, np.asarray(gd), np.asarray(gX), np.asarray(gS),
            (S2, a_d, b_d, np.asarray(gmm[0]), np.asarray(gmm[1])))


def test_bsr_product_grads_match_jax(bsr_refs):
    S, X, data, gd_ref, gX_ref, _, _ = bsr_refs
    B = pt.CSC.from_scipy(S, device="cpu").to_bsr(block=(4, 8))
    np.testing.assert_array_equal(B.np_arrays()[2], data)
    d = _t(data)
    B = pt.BSR(B.m, B.n, B.R, B.C, *B.np_arrays()[:2], d)
    Xt = _t(X)
    gd, gX = torch.autograd.grad(((B @ Xt) ** 2).sum(), (d, Xt))
    _close(gX, gX_ref)
    _close(gX, 2 * S.T @ (S @ X))
    _close(gd, gd_ref)
    # the adjoint in A's own blocks against the block transpose
    adj = bsr_adjoint(B)
    assert (adj.R, adj.C) == (4, 8) and adj.shape == (44, 30)
    G = torch.randn(30, 3, dtype=torch.float64)
    with torch.no_grad():
        _close(adj @ G, pbsr.bsr_transpose(B) @ G, 1e-14)


def test_block_spmm_grad_matches_jax(bsr_refs):
    S, X, _, _, _, gS_ref, _ = bsr_refs
    A = pt.CSC.from_scipy(S, device="cpu")
    Xt = _t(X)
    g, = torch.autograd.grad((pt.spmm(A, Xt, block=(4, 8)) ** 2).sum(), Xt)
    _close(g, gS_ref)


def test_bsr_matmat_plan_grads_match_jax(bsr_refs):
    S, *_, (S2, a_d, b_d, ga_ref, gb_ref) = bsr_refs
    A = pt.CSC.from_scipy(S, device="cpu").to_bsr(block=(4, 8))
    B2 = pt.CSC.from_scipy(S2, device="cpu").to_bsr(block=(8, 6))
    plan = pbsr.BSRMatMatPlan(A, B2, device="cpu")
    at, bt = _t(a_d), _t(b_d)
    ga, gb = torch.autograd.grad((plan.numeric(at, bt).data ** 2).sum(),
                                 (at, bt))
    _close(ga, ga_ref)
    _close(gb, gb_ref)


def test_bsr_product_gradcheck_complex():
    S = sp.random(10, 13, density=0.3, format="csc",
                  random_state=np.random.RandomState(8))
    B = pt.CSC.from_scipy(S, device="cpu").to_bsr(block=(3, 4))
    ip, ix, data = B.np_arrays()
    d = torch.tensor(data * (1 + 0.5j), requires_grad=True)
    X = torch.randn(13, 2, dtype=torch.complex128, requires_grad=True)

    def f(d, X):
        return pt.BSR(10, 13, 3, 4, ip, ix, d) @ X

    assert torch.autograd.gradcheck(f, (d, X))
    x = torch.randn(13, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: B @ x, (x,))


# ---------------------------------------------------------------------------
# banded and LDL^T solves
# ---------------------------------------------------------------------------

def _b3i(mod, n, seed):
    """B' + 3I of synthetic_grid(n, seed) in the JAX package's CSC (the
    port's built from its arrays)."""
    g = jgrids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    eye = jt.from_triplets(np.arange(n), np.arange(n), np.full(n, 3.0),
                           (n, n))
    return jt.from_triplets(rows, cols, vals, (n, n)) + eye


@pytest.fixture(scope="module")
def solve_refs():
    A = _b3i(jt, N, 1)
    data = np.asarray(A.np_arrays()[2])
    b = np.random.RandomState(0).rand(N)
    sq = jax.jit(jax.grad(lambda p, b: jnp.sum(p(b) ** 2), argnums=1))
    lu = jlin.BandedLU(A)
    rf = jlin.BandedRefactor.from_matrix(A)
    gd, gb = jax.jit(jax.grad(lambda d, b: jnp.sum(rf(d)(b) ** 2),
                              argnums=(0, 1)))(jnp.asarray(data),
                                               jnp.asarray(b))
    bsp = jlin.splu(A, "rcm", tol=0.0).banded_solve_plan()
    ld = jlin.ldlt(A).solve_plan()
    return A, data, b, {
        "BandedLU": np.asarray(sq(lu, jnp.asarray(b))),
        "BandedRefactor": (np.asarray(gd), np.asarray(gb)),
        "BandedSolvePlan": np.asarray(sq(bsp, jnp.asarray(b))),
        "LDLTSolvePlan": np.asarray(jax.grad(
            lambda b: jnp.sum(ld(b) ** 2))(jnp.asarray(b)))}


@pytest.mark.parametrize("name", ["BandedLU", "BandedSolvePlan",
                                  "LDLTSolvePlan"])
def test_solve_rhs_grads_match_jax(solve_refs, name):
    A, _, b, refs = solve_refs
    Ap = _port(A)
    plan = {"BandedLU": lambda: plin.BandedLU(Ap, device="cpu"),
            "BandedSolvePlan": lambda: plin.splu(Ap, "rcm", tol=0.0)
            .banded_solve_plan(device="cpu"),
            "LDLTSolvePlan": lambda: plin.ldlt(Ap).solve_plan(
                device="cpu")}[name]()
    bt = _t(b)
    g, = torch.autograd.grad((plan(bt) ** 2).sum(), bt)
    _close(g, refs[name])
    S = A.to_scipy().tocsc()
    x = sp.linalg.spsolve(S, b)
    _close(g, 2 * sp.linalg.spsolve(S.T.tocsc(), x))


def test_banded_refactor_grads_match_jax(solve_refs):
    A, data, b, refs = solve_refs
    rf = plin.BandedRefactor.from_matrix(_port(A), device="cpu")
    d, bt = _t(data), _t(b)
    gd, gb = torch.autograd.grad((rf(d)(bt) ** 2).sum(), (d, bt))
    _close(gd, refs["BandedRefactor"][0])
    _close(gb, refs["BandedRefactor"][1])


def test_banded_solves_gradcheck():
    """A batched refactor (K, nnz), (n, B) right-hand sides, complex values
    (``factor_device`` of a complex matrix), and no grad outside autograd."""
    Aj = _b3i(jt, 16, 2)
    A = _port(Aj)
    rf = plin.BandedRefactor.from_matrix(A, device="cpu")
    d = torch.tensor(A.np_arrays()[2])
    D = torch.stack([d, 1.2 * d]).requires_grad_()
    Bk = torch.randn(2, 16, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda D, B: rf(D)(B), (D, Bk))
    B = torch.randn(16, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda d, B: rf(d)(B),
                                    (d.clone().requires_grad_(), B))
    ip, ix, v = A.np_arrays()
    Ac = pt.CSC(16, 16, ip, ix, v * (1 + 0.3j), device="cpu")
    lu, rfc = plin.BandedLU.factor_device(Ac, device="cpu")
    dc = torch.tensor(v * (1 + 0.3j), requires_grad=True)
    bc = torch.randn(16, dtype=torch.complex128, requires_grad=True)
    assert torch.autograd.gradcheck(lambda d, b: rfc(d)(b), (dc, bc))
    assert torch.autograd.gradcheck(lu.solve, (bc,))
    ldc = plin.ldlt(Ac).solve_plan(device="cpu")
    assert torch.autograd.gradcheck(ldc, (bc,))
    with torch.no_grad():
        assert rf(d)(B).is_inference() and ldc(bc).is_inference()


# ---------------------------------------------------------------------------
# K1-K3: no gradient in either package
# ---------------------------------------------------------------------------

def test_split_band_points_gives_no_gradient():
    Yj = jgrids.ybus(jgrids.synthetic_grid(64, seed=3))[0]
    jplan = jbp.SplitBandPoints(Yj, tile=128)
    x = np.random.RandomState(1).rand(Yj.n).astype(np.float32)
    with pytest.raises(Exception):
        jax.grad(lambda xr: jnp.sum(jplan(xr, jnp.asarray(x))[0]))(
            jnp.asarray(x))
    pplan = pbp.SplitBandPoints(pt.CSC(Yj.m, Yj.n, *Yj.np_arrays(),
                                       device="cpu"), device="cpu", tile=128)
    xr = torch.tensor(x, requires_grad=True)
    yr, _ = pplan(xr, torch.tensor(x))
    assert not yr.requires_grad and yr.grad_fn is None
    with pytest.raises(RuntimeError):
        torch.autograd.grad(yr.sum(), xr)
