"""Parity of the port's banded block-Thomas solvers with the JAX package's
``linalg/banded.py``: ``BandedLU``, ``BandedRefactor``, ``BandedSolvePlan``,
``factor_device`` (real and complex), the four device recurrences, and the
solvers built on them (``FastDecoupled(solver='blocklu' | 'banded')``,
``NewtonPowerFlow(solver='blocklu')``), on the same numpy inputs.

Tolerances (float64 throughout, JAX on the CPU with x64):
- block size, bandwidth, block count, orderings and index maps: equal;
- host stacks: the same numpy code on the same input, within 1e-12 of
  the largest entry (``STACK_RTOL``);
- the device recurrences on the same stacks: within 1e-12 of the largest
  entry (``STACK_RTOL``): the same products in another summation order;
- solves: within 1e-10 of max|x| of each other and of scipy
  (``SOLVE_RTOL``): inverses computed by different LAPACK paths;
- power-flow states: within 1e-8 (``STATE_ATOL``), equal iteration counts.

Deviation by design (F4 repaired): the JAX package's ``factor_device`` on
a complex matrix factors the real 2n-system of the split-complex embedding
and returns the ``BandedRefactor`` of that embedding, which takes no
complex values; the port factors the complex stacks and its refactor plan
takes the complex values of A's own pattern
(``test_complex_refactor_takes_complex_values``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu as cst
import csparse3_tpu_torch as pt
from csparse3_tpu.linalg import banded as jb
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu_torch.linalg import banded as pb
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import powerflow as ppf

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

STACK_RTOL = 1e-12
SOLVE_RTOL = 1e-10
STATE_ATOL = 1e-8


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _shifted_susceptance(n, seed, upper_scale=False):
    """B + 3I for the series susceptances B of synthetic_grid(n, seed), as
    the JAX package's tests build it; ``upper_scale`` multiplies each entry
    above the diagonal by a factor in [0.8, 1) (non-symmetric, still
    diagonally dominant)."""
    g = pgrids.synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    d = np.arange(n)
    A = pt.from_triplets(np.concatenate([g.f, g.t, g.f, g.t, d]),
                         np.concatenate([g.f, g.t, g.t, g.f, d]),
                         np.concatenate([bp, bp, -bp, -bp, np.full(n, 3.0)]),
                         (n, n), device="cpu")
    if not upper_scale:
        return A
    ip, ix, dt = A.np_arrays()
    cols = np.repeat(np.arange(n), np.diff(ip))
    f = 0.8 + 0.2 * np.random.RandomState(seed).rand(len(dt))
    return pt.CSC(n, n, ip, ix, np.where(ix < cols, dt * f, dt),
                  device="cpu")


def _complex_system(n, seed):
    """Ybus of synthetic_grid(n, seed) plus (2 + 0.3j) I."""
    g = pgrids.synthetic_grid(n, seed=seed)
    ip, ix, dt = pgrids.ybus(g)[0].np_arrays()
    cols = np.repeat(np.arange(n), np.diff(ip))
    d = np.arange(n)
    return pt.from_triplets(np.concatenate([ix, d]), np.concatenate([cols, d]),
                            np.concatenate([dt, np.full(n, 2.0 + 0.3j)]),
                            (n, n), device="cpu")


def _tridiagonal(n):
    rng = np.random.RandomState(n)
    r = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    c = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    v = np.concatenate([4.0 + rng.rand(n), -rng.rand(2 * n - 2)])
    return pt.from_triplets(r, c, v, (n, n), device="cpu")


SYSTEMS = {
    "sym600": (lambda: _shifted_susceptance(600, 2), "rcm"),
    "unsym500": (lambda: _shifted_susceptance(500, 8, upper_scale=True),
                 "rcm"),
    "tridiag257": (lambda: _tridiagonal(257), None),
}


def _jax_csc(a):
    return cst.CSC(a.m, a.n, *a.np_arrays())


@pytest.fixture(scope="module")
def plans():
    """{name: (A, JAX CSC, ordering, port BandedLU, JAX BandedLU)}."""
    out = {}
    for name, (make, ordering) in SYSTEMS.items():
        A = make()
        Aj = _jax_csc(A)
        out[name] = (A, Aj, ordering,
                     pb.BandedLU(A, ordering=ordering, device="cpu"),
                     jb.BandedLU(Aj, ordering=ordering))
    return out


@pytest.fixture(scope="module")
def jax_call():
    """Each JAX reference jitted once per module, with the plan as an
    argument."""
    return {
        "solve": jax.jit(lambda p, b: p(b)),
        "sweeps": jax.jit(jb.thomas_sweeps),
        "sweeps_sym": jax.jit(jb.thomas_sweeps_sym),
        "factor": jax.jit(jb.thomas_factor_device),
        "factor_sym": jax.jit(jb.thomas_factor_device_sym),
        "refactor": jax.jit(lambda r, d: r(d)),
    }


# -- layout ---------------------------------------------------------------------

@pytest.mark.parametrize("bw,s", [(0, 8), (1, 8), (7, 8), (9, 16), (95, 96),
                                  (96, 128), (228, 256), (432, 512),
                                  (756, 768)])
def test_block_size_rule(bw, s):
    """A multiple of 128 once the bandwidth reaches 96, else of 8."""
    assert pb._block_size(bw, None) == s
    assert pb._block_size(bw, s + 8) == s + 8
    assert pb._block_size(bw, max(bw, 1)) == max(bw, 1)
    if bw:
        with pytest.raises(ValueError,
                           match=f"block size {bw - 1} < matrix bandwidth"):
            pb._block_size(bw, bw - 1)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_layout_and_ordering_match_jax(plans, name):
    A, Aj, ordering, lp, lj = plans[name]
    assert (lp.n, lp.s, lp.bw, lp.nblocks) == (lj.n, lj.s, lj.bw, lj.nblocks)
    np.testing.assert_array_equal(lp.perm_host(), lj._h[3])
    rp = pb.BandedRefactor.from_matrix(A, ordering=ordering, device="cpu")
    rj = jb.BandedRefactor.from_matrix(Aj, ordering=ordering)
    assert rp._aux == rj._aux
    np.testing.assert_array_equal(rp._idx.numpy(), np.asarray(rj._idx))
    np.testing.assert_array_equal(rp._pad_idx.numpy(),
                                  np.asarray(rj._pad_idx))
    np.testing.assert_array_equal(rp._perm.numpy(), np.asarray(rj._perm))


def test_block_size_guard_raises_like_jax(plans):
    A, Aj, _, lp, _ = plans["sym600"]
    msg = f"block size 8 < matrix bandwidth {lp.bw}"
    for make in (lambda: pb.BandedLU(A, s=8, device="cpu"),
                 lambda: jb.BandedLU(Aj, s=8),
                 lambda: pb.BandedRefactor.from_matrix(A, s=8, device="cpu"),
                 lambda: jb.BandedRefactor.from_matrix(Aj, s=8)):
        with pytest.raises(ValueError, match=msg):
            make()


def test_singular_block_raises():
    n = 64
    A = pt.from_triplets(np.arange(n - 1), np.arange(1, n), -np.ones(n - 1),
                         (n, n), device="cpu")
    with pytest.raises(np.linalg.LinAlgError):
        pb.BandedLU(A, ordering=None, device="cpu")


# -- host stacks and the device recurrences ---------------------------------------

@pytest.mark.parametrize("name", ["sym600", "unsym500"])
def test_host_stacks_match_jax(plans, name):
    A, _, _, lp, lj = plans[name]
    ap = A[lp.perm_host(), lp.perm_host()]
    assert pb.is_symmetric_csc(A.n, *ap.np_arrays()) == (name == "sym600")
    for got, ref in zip(lp._h[:3], lj._h[:3]):
        assert got.dtype == np.asarray(ref).dtype == np.float64
        _close(got, ref, STACK_RTOL)


def _tridiag_of(plan, A):
    perm = plan.perm_host()
    return pb._tridiag_blocks(A.n, *A[perm, perm].np_arrays(), plan.s,
                              np.float64)


@pytest.mark.parametrize("fn", ["sweeps", "sweeps_sym", "factor",
                                "factor_sym"])
def test_device_recurrences_match_jax(plans, jax_call, fn):
    """Each device recurrence of the port against the JAX package's on the
    same stacks: the sweeps on a plan's host stacks (through
    ``banded_from_stacks``), the factorizations on the block-tridiagonal
    stacks of the ordered matrix."""
    name = "sym600" if fn.endswith("sym") else "unsym500"
    A, _, _, lp, lj = plans[name]
    D, E, F = _tridiag_of(lp, A)
    for got, ref in zip((D, E, F), jb._tridiag_blocks(
            A.n, *A[lp.perm_host(), lp.perm_host()].np_arrays(), lp.s,
            np.float64)):
        np.testing.assert_array_equal(got, ref)
    t = torch.as_tensor
    if fn == "factor":
        got = pb.thomas_factor_device(t(D), t(E), t(F))
        ref = jax_call["factor"](D, E, F)
    elif fn == "factor_sym":
        got = pb.thomas_factor_device_sym(t(D), t(F))
        ref = jax_call["factor_sym"](D, F)
    else:
        bb = np.random.RandomState(5).rand(lp.nblocks, lp.s, 7)
        if fn == "sweeps":
            plan = pt.banded_from_stacks(*lj._h, lj.n, lj.s, lj.bw,
                                         device="cpu")
            got = [plan.solve_blocks(t(bb))]
            ref = [jax_call["sweeps"](*lj._h[:3], bb)]
        else:
            si, uh = jax_call["factor_sym"](D, F)
            si, uh = np.array(si), np.array(uh)
            got = [pb.thomas_sweeps_sym(t(si), t(uh), t(bb))]
            ref = [jax_call["sweeps_sym"](si, uh, bb)]
    for g, r in zip(got, ref):
        _close(g, r, STACK_RTOL)
    if fn == "factor":
        # the device factorization agrees with the host one
        for g, r in zip(got, lp._h[:3]):
            _close(g, r, STACK_RTOL)


# -- plans --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_banded_lu_33_rhs_matches_jax_and_scipy(plans, jax_call, name):
    A, _, _, lp, lj = plans[name]
    B = np.random.RandomState(1).rand(A.n, 33)
    x = lp(B)
    assert x.dtype == torch.float64 and x.device.type == "cpu"
    _close(x, jax_call["solve"](lj, jnp.asarray(B)), SOLVE_RTOL)
    _close(x, spla.spsolve(A.to_scipy().tocsc(), B), SOLVE_RTOL)
    _close(lp.solve_host(B), lj.solve_host(B), STACK_RTOL)
    # one right-hand side as a vector, numpy or tensor
    _close(lp(B[:, 3]), x[:, 3], STACK_RTOL)
    _close(lp(torch.as_tensor(B[:, 3])), x[:, 3], STACK_RTOL)
    # the JAX plan's stacks solve the same through banded_from_stacks
    plan = pt.banded_from_stacks(*lj._h, lj.n, lj.s, lj.bw, device="cpu")
    _close(plan(B), x, SOLVE_RTOL)
    _close(plan.solve_host(B), lj.solve_host(B), STACK_RTOL)


def test_banded_lu_float32_stacks(plans):
    """dtype= stores the stacks in float32 (factored in float64); float64
    right-hand sides promote the sweeps to float64, as in the JAX package."""
    A, Aj, _, _, _ = plans["sym600"]
    lp = pb.BandedLU(A, dtype=torch.float32, device="cpu")
    lj = jb.BandedLU(Aj, dtype=np.float32)
    for got, ref in zip(lp._h[:3], lj._h[:3]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    b = np.random.RandomState(2).rand(A.n)
    x32 = lp(b.astype(np.float32))
    assert x32.dtype == torch.float32
    xs = spla.spsolve(A.to_scipy().tocsc(), b)
    _close(x32.double(), xs, 1e-5)
    _close(lp(b), lj.solve_host(b), SOLVE_RTOL)


@pytest.mark.parametrize("name", ["sym600", "unsym500"])
def test_banded_refactor_matches_jax_and_reuses(plans, jax_call, name):
    """``BandedRefactor.from_matrix`` and ``refactor_plan`` factor A's
    values like the JAX package's; 2 A then gives half the solution."""
    A, Aj, ordering, lp, lj = plans[name]
    data = A.np_arrays()[2]
    B = np.random.RandomState(3).rand(A.n, 4)
    xs = spla.spsolve(A.to_scipy().tocsc(), B)
    rp = pb.BandedRefactor.from_matrix(A, ordering=ordering, device="cpu")
    rj = jb.BandedRefactor.from_matrix(Aj, ordering=ordering)
    for k in (1.0, 2.0):
        got = rp(k * data)
        ref = jax_call["refactor"](rj, jnp.asarray(k * data))
        for g, r in zip(got.stacks()[:3], (ref._ehat, ref._sinv,
                                           ref._uhat)):
            _close(g, r, STACK_RTOL)
        _close(got(B), xs / k, SOLVE_RTOL)
        _close(got(B), jax_call["solve"](ref, jnp.asarray(B)), SOLVE_RTOL)
    lu2 = lp.refactor_plan(A)(2 * torch.as_tensor(data))
    _close(lu2(B), xs / 2, SOLVE_RTOL)
    with pytest.raises(ValueError, match="no host stacks"):
        lu2.solve_host(B)


def test_factor_device_matches_jax(plans):
    A, Aj, _, lp, _ = plans["unsym500"]
    lu, rf = pt.BandedLU.factor_device(A, device="cpu")
    lj, _ = jb.BandedLU.factor_device(Aj)
    assert isinstance(lu, pt.BandedLU) and (lu.s, lu.bw) == (lj.s, lj.bw)
    B = np.random.RandomState(4).rand(A.n, 5)
    _close(lu(B), lj(jnp.asarray(B)), SOLVE_RTOL)
    _close(lu(B), lp(B), SOLVE_RTOL)


@pytest.mark.parametrize("name", ["sym600", "unsym500"])
def test_banded_solve_plan_matches_jax(name, plans):
    A, Aj, _, _, _ = plans[name]
    sp_, sj = pt.splu(A, "rcm", tol=0.0), cst.linalg.splu(Aj, "rcm", tol=0.0)
    pp = sp_.banded_solve_plan(device="cpu")
    pj = sj.banded_solve_plan()
    assert (pp.n, pp.s, pp.nblocks) == (pj.n, pj.s, pj.nblocks)
    for f in ("linv", "lsub", "uinv", "usup"):
        _close(getattr(pp, f), getattr(pj, f), STACK_RTOL)
    B = np.random.RandomState(6).rand(A.n, 9)
    x = pp(B)
    _close(x, pj(jnp.asarray(B)), SOLVE_RTOL)
    _close(x, spla.spsolve(A.to_scipy().tocsc(), B), SOLVE_RTOL)
    _close(pp(B[:, 0]), x[:, 0], STACK_RTOL)


def test_banded_solve_plan_guard_raises_like_jax(plans):
    """Factors that are not banded enough for the block size (an AMD
    ordering scatters the band) raise the JAX package's ValueError."""
    A, Aj, _, _, _ = plans["sym600"]
    lp, lj = pt.splu(A, ordering="amd"), cst.linalg.splu(Aj, ordering="amd")
    h = lp._h
    bw = max(pb.bandwidth(h.Lp, h.Li), pb.bandwidth(h.Up, h.Ui))
    s = max(8, (bw // 2) // 8 * 8)
    msg = f"block size {s} < factor bandwidth {bw}"
    with pytest.raises(ValueError, match=msg):
        lp.banded_solve_plan(s=s, device="cpu")
    with pytest.raises(ValueError, match=msg):
        lj.banded_solve_plan(s=s)


# -- complex ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def complex_pair():
    A = _complex_system(300, seed=6)
    return A, _jax_csc(A)


def test_complex_banded_lu_uploads_and_matches_jax(complex_pair):
    """Complex stacks solve on the device (the JAX package keeps them on
    the host): equal stacks, and the device solve matches JAX's host one."""
    A, Aj = complex_pair
    lp, lj = pb.BandedLU(A, device="cpu"), jb.BandedLU(Aj)
    for got, ref in zip(lp._h[:3], lj._h[:3]):
        assert got.dtype == np.complex128
        _close(got, ref, STACK_RTOL)
    rng = np.random.RandomState(0)
    b = rng.rand(A.n) + 1j * rng.rand(A.n)
    x = lp(b)
    assert x.dtype == torch.complex128
    _close(x, lj.solve_host(b), SOLVE_RTOL)
    _close(x, spla.spsolve(A.to_scipy().tocsc(), b), SOLVE_RTOL)


def test_complex_factor_device_matches_jax(complex_pair):
    A, Aj = complex_pair
    lu, rf = pt.BandedLU.factor_device(A, device="cpu")
    lj, _ = jb.BandedLU.factor_device(Aj)
    assert isinstance(lu, pt.ComplexBandedSolve)
    np.testing.assert_array_equal(lu.perm_c, lj.perm_c)
    rng = np.random.RandomState(3)
    b = rng.rand(A.n) + 1j * rng.rand(A.n)
    x = lu(b)
    assert x.dtype == torch.complex128 and x.shape == (A.n,)
    _close(x, lj(b), SOLVE_RTOL)
    _close(x, spla.spsolve(A.to_scipy().tocsc(), b), SOLVE_RTOL)
    B = rng.rand(A.n, 3) + 0.5j
    _close(lu.solve(B), lj.solve(B), SOLVE_RTOL)


def test_complex_refactor_takes_complex_values(complex_pair):
    """F4 repaired: the refactor plan of a complex factor_device takes the
    complex values of A's own pattern; 2 A gives half the solution.  The
    JAX package's plan is that of the real 2n-system."""
    A, Aj = complex_pair
    _, rf = pt.BandedLU.factor_device(A, device="cpu")
    _, rj = jb.BandedLU.factor_device(Aj)
    assert rf._aux[0] == A.n and rj._aux[0] == 2 * A.n
    assert rf._idx.numel() == A.nnz
    data = A.np_arrays()[2]
    rng = np.random.RandomState(8)
    b = rng.rand(A.n) + 1j * rng.rand(A.n)
    x = spla.spsolve(A.to_scipy().tocsc(), b)
    lu2 = rf(2 * data)
    assert lu2.dtype == torch.complex128
    _close(lu2(b), x / 2, SOLVE_RTOL)
    _close(rf(torch.as_tensor(data))(b), x, SOLVE_RTOL)


# -- the solvers ----------------------------------------------------------------------

def _grids(name):
    if name == "ieee14":
        return pgrids.ieee14(), jgrids.ieee14()
    return (pgrids.rcm_grid(pgrids.synthetic_grid(200, seed=7))[0],
            jgrids.rcm_grid(jgrids.synthetic_grid(200, seed=7))[0])


@pytest.mark.parametrize("solver", ["blocklu", "banded"])
@pytest.mark.parametrize("name", ["ieee14", "rcm200"])
def test_fast_decoupled_banded_solvers_match_jax(name, solver):
    gp, gj = _grids(name)
    fp = ppf.FastDecoupled(gp, spmv="dia", solver=solver, device="cpu")
    vm_p, va_p, it_p, res_p = fp.solve()
    vm_j, va_j, it_j, res_j = jpf.FastDecoupled(gj, spmv="dia",
                                                solver=solver).solve()
    assert it_p == it_j and 0 < it_p < fp.max_iter
    assert res_p <= 1e-8 and res_j <= 1e-8
    np.testing.assert_allclose(vm_p, vm_j, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(va_p, va_j, rtol=0, atol=STATE_ATOL)
    kind = pt.BandedLU if solver == "blocklu" else pt.BandedSolvePlan
    assert isinstance(fp._bp_plan, kind) and isinstance(fp._bpp_plan, kind)
    # the answer is the level solver's
    vm_l, va_l, _, _ = ppf.FastDecoupled(gp, spmv="dia", device="cpu").solve()
    np.testing.assert_allclose(vm_p, vm_l, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(va_p, va_l, rtol=0, atol=STATE_ATOL)


@pytest.mark.parametrize("name", ["ieee14", "rcm200"])
def test_newton_blocklu_matches_jax(name):
    gp, gj = _grids(name)
    pf = ppf.NewtonPowerFlow(gp, spmv="dia", solver="blocklu", device="cpu")
    assert isinstance(pf._rp, pt.BandedRefactor)
    vm_p, va_p, it_p, res_p = pf.solve()
    vm_j, va_j, it_j, res_j = jpf.NewtonPowerFlow(gj, spmv="dia",
                                                  solver="blocklu").solve()
    assert it_p == it_j and res_p < 1e-10
    np.testing.assert_allclose(vm_p, vm_j, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(va_p, va_j, rtol=0, atol=STATE_ATOL)
    vm_l, va_l, _, _ = ppf.NewtonPowerFlow(gp, spmv="dia",
                                           device="cpu").solve()
    np.testing.assert_allclose(vm_p, vm_l, rtol=0, atol=1e-10)
    np.testing.assert_allclose(va_p, va_l, rtol=0, atol=1e-10)


def test_solver_names_in_errors():
    g = pgrids.ieee14()
    with pytest.raises(ValueError, match="'level', 'banded', 'blocklu'"):
        ppf.FastDecoupled(g, solver="qr", device="cpu")
    with pytest.raises(ValueError,
                       match="'level', 'multifrontal', 'blocklu'"):
        ppf.NewtonPowerFlow(g, solver="qr", device="cpu")


# -- precision and the default device ----------------------------------------------

def test_precision_argument_restores_the_callers_setting(plans):
    A, _, _, lp, _ = plans["sym600"]
    bb = lp.blocks(np.random.RandomState(7).rand(A.n, 2))
    ref = lp.solve_blocks(bb)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            for p in pb.PRECISIONS:
                # the CPU has no TF32: every precision is full float64 here
                assert torch.equal(lp.solve_blocks(bb, precision=p), ref)
                assert torch.backends.cuda.matmul.allow_tf32 is flag
        with pytest.raises(ValueError, match="unknown precision"):
            lp.solve_blocks(bb, precision="bf16")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _small():
    return _shifted_susceptance(40, 1)


def _from_stacks(lu):
    return pt.banded_from_stacks(*lu._h, lu.n, lu.s, lu.bw)


ENTRY_POINTS = {
    "BandedLU_solve": lambda: pt.BandedLU(_small())(np.ones(40)),
    "BandedLU_stacks": lambda: pt.BandedLU(_small()).stacks(),
    "factor_device": lambda: pt.BandedLU.factor_device(_small()),
    "BandedRefactor.from_matrix": lambda: pt.BandedRefactor.from_matrix(
        _small()),
    "refactor_plan": lambda: pt.BandedLU(_small()).refactor_plan(_small()),
    "banded_solve_plan": lambda: pt.splu(
        _small(), "rcm", tol=0.0).banded_solve_plan(),
    "BandedSolvePlan": lambda: pt.BandedSolvePlan(
        pt.splu(_small(), "rcm", tol=0.0)._h),
    "banded_from_stacks": lambda: _from_stacks(
        pt.BandedLU(_small(), device="cpu"))(np.ones(40)),
    "FastDecoupled_blocklu": lambda: ppf.FastDecoupled(
        pgrids.ieee14(), solver="blocklu"),
    "FastDecoupled_banded": lambda: ppf.FastDecoupled(
        pgrids.ieee14(), solver="banded"),
    "NewtonPowerFlow_blocklu": lambda: ppf.NewtonPowerFlow(
        pgrids.ieee14(), solver="blocklu"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """device=None is the CUDA card: without one the first device work of
    every new entry point raises ``default_device``'s error; a host solve
    needs no device."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
    lu = pt.BandedLU(_small())
    assert lu.solve_host(np.ones(40)).shape == (40,)
