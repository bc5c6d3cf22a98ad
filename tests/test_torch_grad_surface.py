"""Gradients of the smaller differentiable entries of the public surface,
against ``jax.grad`` of the JAX package on the same numpy inputs.

The gradient checklist (``tests/test_torch_grad_checklist.py``) found
these by asking ``jax.grad`` of every public callable: the JAX package's
CSC is a pytree, so an operation written in jnp over its ``data`` leaf
differentiates in it.  The port's counterparts take a CSC whose values are
a tensor that requires a gradient:

* value-wise operations and reductions (``scale``, ``scale_rows``,
  ``scale_columns``, ``diagonal``, ``sum``, ``norm``), which are plain
  torch ops;
* the format conversions (``transpose``, ``csc_to_coo``, ``csc_to_csr``,
  ``csr_to_csc``, the dense forms and the container methods over them),
  which reorder on the host and gather the values in the same order;
* the triangular plans' ``solve`` in b (``_TriSolve``: the transposed
  level loop through the same buffers), ``refine`` (through a solve plan
  and a product plan), the Jacobi and ILU(0) preconditioners;
* ``sbus``, ``branch_admittances`` and ``reorder_grid`` over grid fields
  given as tensors, and ``FastDecoupled.mismatch`` / ``residual`` /
  ``step`` in (vm, va);
* ``RowPartition.pad_vector`` / ``trim_vector``.

One parametrized test holds each to its JAX reference (float64, rtol 1e-8
of the largest entry; a few entries are complex, compared as torch's
conjugate-Wirtinger gradient against the conjugate of ``jax.grad``).
Each JAX reference is jitted (eager level loops take seconds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.linalg import iterative as jit_
from csparse3_tpu.linalg import trisolve as jts
from csparse3_tpu.models import grids as jgr
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu.ops import construct as jco
from csparse3_tpu.ops import reductions as jred
from csparse3_tpu_torch.linalg import iterative as pit
from csparse3_tpu_torch.linalg import trisolve as pts
from csparse3_tpu_torch.models import grids as pgr
from csparse3_tpu_torch.models import powerflow as ppf
from csparse3_tpu_torch.ops import construct as pco
from csparse3_tpu_torch.ops import reductions as pred

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-8
N = 40


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _matrix():
    rng = np.random.RandomState(0)
    s = (sp.random(N, N, 0.1, random_state=rng) + 4 * sp.eye(N)).tocsc()
    s.sum_duplicates()
    s.sort_indices()
    return s


S = _matrix()
RNG = np.random.RandomState(1)
B = RNG.randn(N)
B2 = RNG.randn(N, 2)


def _jc(d):
    return jt.CSC(N, N, S.indptr, S.indices, d)


def _pc(d):
    return pt.CSC(N, N, S.indptr, S.indices, d, device="cpu")


#: name: (JAX function, port function, inputs); each function maps the
#: inputs to one array whose weighted sum is the loss
OPS = {
    "scale": (lambda d: jt.scale(_jc(d), 2.5).data,
              lambda d: pt.scale(_pc(d), 2.5).data, (S.data,)),
    "scale_rows": (lambda d, r: jt.scale_rows(_jc(d), r).data,
                   lambda d, r: pt.scale_rows(_pc(d), r).data, (S.data, B)),
    "scale_columns": (lambda d, r: jt.scale_columns(_jc(d), r).data,
                      lambda d, r: pt.scale_columns(_pc(d), r).data,
                      (S.data, B)),
    "diagonal": (lambda d: jred.diagonal(_jc(d)),
                 lambda d: pred.diagonal(_pc(d)), (S.data,)),
    "sum_axis0": (lambda d: jred.sum(_jc(d), axis=0),
                  lambda d: pred.sum(_pc(d), axis=0), (S.data,)),
    "sum_axis1": (lambda d: jred.sum(_jc(d), axis=1),
                  lambda d: pred.sum(_pc(d), axis=1), (S.data,)),
    "norm_1": (lambda d: jt.norm(_jc(d), 1), lambda d: pt.norm(_pc(d), 1),
               (S.data,)),
    "norm_fro": (lambda d: jt.norm(_jc(d), "fro"),
                 lambda d: pt.norm(_pc(d), "fro"), (S.data,)),
    "transpose": (lambda d: jco.transpose(_jc(d)).data,
                  lambda d: pco.transpose(_pc(d)).data, (S.data,)),
    "csc_to_coo": (lambda d: jco.csc_to_coo(_jc(d)).data,
                   lambda d: pco.csc_to_coo(_pc(d)).data, (S.data,)),
    "csc_to_csr": (lambda d: jco.csc_to_csr(_jc(d)).data,
                   lambda d: pco.csc_to_csr(_pc(d)).data, (S.data,)),
    "csr_to_csc": (lambda d: jco.csr_to_csc(jco.csc_to_csr(_jc(d))).data,
                   lambda d: pco.csr_to_csc(pco.csc_to_csr(_pc(d))).data,
                   (S.data,)),
    "csc_to_dense": (lambda d: jco.csc_to_dense(_jc(d)),
                     lambda d: pco.csc_to_dense(_pc(d)), (S.data,)),
    "coo_to_dense": (lambda d: jco.coo_to_dense(jco.csc_to_coo(_jc(d))),
                     lambda d: pco.coo_to_dense(pco.csc_to_coo(_pc(d))),
                     (S.data,)),
    "CSC.t": (lambda d: _jc(d).t().data, lambda d: _pc(d).t().data,
              (S.data,)),
    "CSC.todense": (lambda d: _jc(d).todense(), lambda d: _pc(d).todense(),
                    (S.data,)),
    "CSC.astype": (lambda d: _jc(d).astype(np.complex128).data.real,
                   lambda d: _pc(d).astype(np.complex128).data.real,
                   (S.data,)),
    "CSC.conj": (lambda d: _jc(d * (1 + 2j)).conj().data.imag,
                 lambda d: _pc(d * (1 + 2j)).conj().data.imag, (S.data,)),
    "CSC.copy": (lambda d: _jc(d).copy().data, lambda d: _pc(d).copy().data,
                 (S.data,)),
    "CSC.diagonal": (lambda d: _jc(d).diagonal(),
                     lambda d: _pc(d).diagonal(), (S.data,)),
    "CSC.sum": (lambda d: _jc(d).sum(axis=1), lambda d: _pc(d).sum(axis=1),
                (S.data,)),
    "CSC.norm": (lambda d: _jc(d).norm(), lambda d: _pc(d).norm(),
                 (S.data,)),
    "CSC.to_csr": (lambda d: _jc(d).to_csr().data,
                   lambda d: _pc(d).to_csr().data, (S.data,)),
    "CSC.to_coo": (lambda d: _jc(d).to_coo().data,
                   lambda d: _pc(d).to_coo().data, (S.data,)),
    "CSR.todense": (lambda d: _jc(d).to_csr().todense(),
                    lambda d: _pc(d).to_csr().todense(), (S.data,)),
    "CSR.to_csc": (lambda d: _jc(d).to_csr().to_csc().data,
                   lambda d: _pc(d).to_csr().to_csc().data, (S.data,)),
    "COO.to_dense": (lambda d: _jc(d).to_coo().to_dense(),
                     lambda d: _pc(d).to_coo().to_dense(), (S.data,)),
}


#: the solvers' matrix: smaller, so that the JAX references compile few
#: levels
NS = 16
SS = _matrix()[:NS, :NS].tocsc()


def _tri(pkg, lower, tail):
    """A triangular plan of ``pkg`` over the L or U factor of SS."""
    lu = (jt.linalg.splu(jt.CSC.from_scipy(SS)) if pkg is jts
          else pt.linalg.splu(pt.CSC.from_scipy(SS, device="cpu")))
    F = lu.L if lower else lu.U
    kw = {} if pkg is jts else {"device": "cpu"}
    if tail:
        return pkg.DenseTailTriSolvePlan(NS, *F.np_arrays(), lower=lower,
                                         tail=8, block=4, **kw)
    return pkg.TriSolvePlan(NS, *F.np_arrays(), lower=lower, **kw)


def _solvers():
    """{name: (JAX function, port function, inputs)} of the plans."""
    out = {}
    for lower in (True, False):
        for tail in (False, True):
            cls = "DenseTailTriSolvePlan" if tail else "TriSolvePlan"
            jp, pp = _tri(jts, lower, tail), _tri(pts, lower, tail)
            out[f"{cls}.solve_{'L' if lower else 'U'}"] = (
                jp.solve, pp.solve, (B2[:NS],))
    ja, pa = jt.CSC.from_scipy(SS), pt.CSC.from_scipy(SS, device="cpu")
    out["jacobi_prec"] = (jit_.jacobi_prec(ja), pit.jacobi_prec(pa),
                          (B[:NS],))
    out["ilu0_prec"] = (jit_.ilu0_prec(ja), pit.ilu0_prec(pa, device="cpu"),
                        (B[:NS],))
    # refinement of a float32 factor's solves in float64
    s32 = SS.astype(np.float32)
    jplan = jt.linalg.splu(jt.CSC.from_scipy(s32)).solve_plan()
    pplan = pt.linalg.splu(pt.CSC.from_scipy(s32, device="cpu")).solve_plan(
        device="cpu")
    jmv, pmv = jt.SpMVPlan(ja), pt.SpMVPlan(pa, device="cpu")
    out["refine"] = (lambda b: jit_.refine(jplan, jmv, b, iters=2),
                     lambda b: pit.refine(pplan, pmv, b, iters=2), (B[:NS],))
    return out


def _models():
    g, pg = jgr.ieee14(), pgr.ieee14()
    jf, pf = jpf.FastDecoupled(g), ppf.FastDecoupled(pg, device="cpu")
    vm = 1.0 + 0.02 * RNG.randn(14)
    va = 0.05 * RNG.randn(14)
    sb = jpf.sbus(g)
    sbr, sbi = sb.real, sb.imag
    perm = np.random.RandomState(2).permutation(14)
    return {
        "sbus": (lambda pd: jpf.sbus(g._replace(pd=pd)).real,
                 lambda pd: ppf.sbus(pg._replace(pd=pd)).real, (g.pd,)),
        "branch_admittances": (
            lambda x: jnp.stack(jgr.branch_admittances(
                g._replace(x=x))).imag,
            lambda x: torch.stack(pgr.branch_admittances(
                pg._replace(x=x))).imag, (g.x,)),
        "reorder_grid": (
            lambda pd: jgr.reorder_grid(g._replace(pd=pd), perm).pd,
            lambda pd: pgr.reorder_grid(pg._replace(pd=pd), perm).pd,
            (g.pd,)),
        "FastDecoupled.mismatch": (
            lambda vm, va: jnp.stack(jf.mismatch(vm, va)),
            lambda vm, va: torch.stack(pf.mismatch(vm, va)), (vm, va)),
        "FastDecoupled.residual": (jf.residual, pf.residual, (vm, va)),
        "FastDecoupled.step": (
            lambda vm, va: jnp.stack(jf.step((vm, va, sbr, sbi))[:2]),
            lambda vm, va: torch.stack(pf.step(
                (vm, va, torch.as_tensor(sbr), torch.as_tensor(sbi)))[:2]),
            (vm, va)),
    }


def _partition():
    """``RowPartition.pad_vector`` / ``trim_vector`` around a scaling."""
    jp = jt.parallel.partition_rows(jt.CSC.from_scipy(S), 3)
    pp = pt.parallel.partition_rows(pt.CSC.from_scipy(S, device="cpu"), 3)
    return {"RowPartition.pad_vector_trim_vector": (
        lambda x: jp.trim_vector(2.0 * jp.pad_vector(x)),
        lambda x: pp.trim_vector(2.0 * pp.pad_vector(x)), (B2,))}


CASES = {**OPS, **_solvers(), **_models(), **_partition()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_surface_grad_matches_jax(name):
    jf, pf, args = CASES[name]
    shape = jax.eval_shape(jf, *map(jnp.asarray, args)).shape
    w = np.random.RandomState(len(name)).randn(*shape)
    ref = jax.jit(jax.grad(lambda *a: jnp.sum(w * jf(*a)), argnums=tuple(
        range(len(args)))))(*map(jnp.asarray, args))
    ins = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    out = pf(*ins)
    got = torch.autograd.grad((torch.as_tensor(np.asarray(w)) * out).sum(),
                              ins)
    for g, r in zip(got, ref):
        _close(g, r)


def test_without_grad_the_entries_stay_in_inference_mode():
    """Inputs that require no gradient give inference tensors: no tape."""
    for name in ("TriSolvePlan.solve_L", "DenseTailTriSolvePlan.solve_U",
                 "refine", "FastDecoupled.residual"):
        _, pf, args = CASES[name]
        assert pf(*map(torch.as_tensor, args)).is_inference(), name
    pf = ppf.FastDecoupled(pgr.ieee14(), device="cpu")
    vm = torch.ones(14, dtype=torch.float64)
    assert all(t.is_inference() for t in pf.step(
        (vm, 0 * vm, pf._sbr, pf._sbi))[:2])


def test_complex_tri_solve_gradcheck():
    """A complex right-hand side on a real plan: the conjugate-Wirtinger
    gradient F^{-H} g, by finite differences."""
    b = torch.tensor(B2[:NS] + 1j * RNG.randn(NS, 2), requires_grad=True)
    for lower in (True, False):
        for tail in (False, True):
            plan = _tri(pts, lower, tail)
            assert torch.autograd.gradcheck(plan.solve, (b,),
                                            fast_mode=True)
