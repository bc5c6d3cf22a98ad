"""The sparse-product path of the port against the JAX package on the same
numpy inputs: ``spgemm``, ``gram`` (with its cached symbolic phase),
``spgemm_symbolic`` / ``SpGEMMPlan.numeric`` (kernel K6), ``gram_symbolic``
/ ``GramPlan``, the device ESC product, and the GridCal flow as a whole
(connectivity -> Cf - Ct -> gram -> add -> transpose).

On the CPU the port's ``numeric`` runs the plain version of
``kernels.spgemm``; the CUDA kernel is held to that plain version on a card
in tests/test_torch_gpu.py.  The JAX side of the float32 numeric test runs
its Pallas kernel in interpret mode, the float64 one its XLA path.

Patterns (indptr, indices) must be equal exactly.  Values: every version
sums the same products of an output in some order, so float64 results
agree to 1e-12 relative and float32 ones to 1e-6 of max|C| (the JAX
package's own Pallas test uses 1e-6); scipy decides where they differ.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.ops import spgemm as jsp
from csparse3_tpu.ops import spgemm_device as jspd
from csparse3_tpu_torch.kernels import spgemm as kspg
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.ops import spgemm as psp
from csparse3_tpu_torch.ops import spgemm_device as pspd
from csparse3_tpu_torch.utils.interop import csc_from_arrays, grid_from_arrays


def _port(Aj, device=None):
    return csc_from_arrays(Aj.m, Aj.n, *Aj.np_arrays(), device=device)


def _hub(dtype=np.float64):
    """The matrix of the JAX package's Pallas numeric test: 300 x 200 at 3%
    density plus a hub column."""
    rng = np.random.RandomState(7)
    a = sp.random(300, 200, density=0.03, format="csc", random_state=rng)
    a = (a + sp.csc_matrix(
        (rng.rand(60), (rng.permutation(300)[:60], np.full(60, 5))),
        shape=(300, 200))).tocsc()
    a.sort_indices()
    return jt.CSC.from_scipy(a.astype(dtype)), a


def _same_pattern(p, j):
    assert p.shape == j.shape and p.nnz == j.nnz
    np.testing.assert_array_equal(p.np_arrays()[0], np.asarray(j.indptr))
    np.testing.assert_array_equal(p.np_arrays()[1],
                                  np.asarray(j.indices)[: j.nnz])


def _same(p, j, rtol=1e-12):
    _same_pattern(p, j)
    dp, dj = p.np_arrays()[2], np.asarray(j.data)[: j.nnz]
    assert dp.dtype == dj.dtype
    np.testing.assert_allclose(dp, dj, rtol=rtol,
                               atol=rtol * np.abs(dj).max(initial=0))


def _grid_pair(name):
    gj = jgrids.ieee14() if name == "ieee14" else \
        jgrids.synthetic_grid(200, seed=1)
    return grid_from_arrays(**gj._asdict()), gj


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spgemm_symbolic_numeric_matches_jax(dtype):
    Aj, a = _hub()
    Bj = Aj.t()
    Ap, Bp = _port(Aj), _port(Bj)
    pj, pp = jsp.spgemm_symbolic(Aj, Bj), psp.spgemm_symbolic(Ap, Bp,
                                                              device="cpu")
    assert pp.out_nnz == pj.out_nnz and pp.n_products == len(pj.gid)
    np.testing.assert_array_equal(pp.gid.numpy(), np.asarray(pj.gid))
    av = Aj.np_arrays()[2].astype(dtype)
    bv = Bj.np_arrays()[2].astype(dtype)
    before = kspg.LAUNCHES["spgemm_numeric"]
    Cp = pp.numeric(torch.as_tensor(av), torch.as_tensor(bv))
    assert kspg.LAUNCHES["spgemm_numeric"] == before  # plain version: CPU
    if dtype == np.float32:
        assert pj._pallas_maps is not None  # the JAX side runs its kernel
    Cj = pj.numeric(jnp.asarray(av), jnp.asarray(bv))
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    _same(Cp, Cj, rtol=rtol)
    ref = (a @ a.T).tocsc()
    ref.sort_indices()
    np.testing.assert_array_equal(Cp.np_arrays()[1], ref.indices)
    np.testing.assert_allclose(Cp.np_arrays()[2], ref.data, rtol=rtol,
                               atol=rtol * ref.data.max())
    # numpy values are placed on the plan's device; new values, same plan
    C2 = pp.numeric(av * 3 + 1, bv)
    a2 = a.copy()
    a2.data = (av * 3 + 1).astype(np.float64)
    np.testing.assert_allclose(C2.to_scipy().toarray(), (a2 @ a.T).toarray(),
                               rtol=10 * rtol, atol=10 * rtol * ref.data.max())


def _dense_row(dtype):
    """600 x 3000 at 0.2% density plus one dense row: in A @ A.T the
    diagonal output of that row is one segment of 3000 products.  The values
    are multiples of 1/8 in (0, 1], so every product and every partial sum
    is exact in float32 and any summation order gives the same bits."""
    rng = np.random.RandomState(11)
    a = sp.random(600, 3000, density=2e-3, format="csc", random_state=rng)
    a = (a + sp.csc_matrix((np.ones(3000), (np.full(3000, 17),
                                            np.arange(3000))),
                           shape=a.shape)).tocsc()
    a.sort_indices()
    a.data = rng.randint(1, 9, a.nnz) / 8.0
    return jt.CSC.from_scipy(a.astype(dtype)), a


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hub_output_numeric_matches_jax(dtype):
    Aj, a = _dense_row(dtype)
    Bj = Aj.t()
    pj = jsp.spgemm_symbolic(Aj, Bj)
    pp = psp.spgemm_symbolic(_port(Aj), _port(Bj), device="cpu")
    assert int(pp.seg_ptr.diff().max()) == 3000
    np.testing.assert_array_equal(pp.gid.numpy(), np.asarray(pj.gid))
    av, bv = Aj.np_arrays()[2], Bj.np_arrays()[2]
    Cp = pp.numeric(av, bv)
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    _same(Cp, pj.numeric(jnp.asarray(av), jnp.asarray(bv)), rtol=rtol)
    ref = (a @ a.T).tocsc()
    ref.sort_indices()
    np.testing.assert_array_equal(Cp.np_arrays()[1], ref.indices)
    np.testing.assert_allclose(Cp.np_arrays()[2], ref.data, rtol=rtol,
                               atol=rtol * ref.data.max())


def test_numeric_dtype_rule_integers_and_mixed_and_complex():
    Aj, a = _hub()
    Ap = _port(Aj)
    Bp = Ap.t()
    plan = psp.spgemm_symbolic(Ap, Bp, device="cpu")
    ai = np.ceil(Ap.np_arrays()[2] * 9).astype(np.int64)
    bi = np.ceil(Bp.np_arrays()[2] * 9).astype(np.int64)
    Ci = plan.numeric(ai, bi)
    assert Ci.data.dtype == torch.int64
    ai_sp, bi_sp = a.copy(), a.T.tocsc()
    bi_sp.sort_indices()
    ai_sp.data, bi_sp.data = ai, bi
    np.testing.assert_array_equal(Ci.to_scipy().toarray(),
                                  (ai_sp @ bi_sp).toarray())
    # mixed float32 / float64 promotes; complex values
    Cm = plan.numeric(Ap.np_arrays()[2].astype(np.float32),
                      Bp.np_arrays()[2])
    assert Cm.data.dtype == torch.float64
    az = Ap.np_arrays()[2] * (1 + 2j)
    Cz = plan.numeric(az, Bp.np_arrays()[2])
    np.testing.assert_allclose(Cz.np_arrays()[2],
                               (1 + 2j) * (a @ a.T).tocsc().sorted_indices().data,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="pa and pb of one length"):
        kspg.spgemm_numeric_cuda(plan.seg_ptr, plan.pa_s[:-1], plan.pb_s,
                                 torch.as_tensor(az), torch.as_tensor(az))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128,
                                   np.int64])
def test_spgemm_and_gram_match_jax(dtype):
    Aj, a = _hub()
    ip, ix, dt = Aj.np_arrays()
    v = np.ceil(dt * 9).astype(dtype) if dtype == np.int64 else \
        (dt * (1 + 1j)).astype(dtype) if dtype == np.complex128 else \
        dt.astype(dtype)
    Aj = jt.CSC(Aj.m, Aj.n, ip, ix, v)
    Ap = _port(Aj)
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    _same(psp.spgemm(Ap, Ap.t()), jsp.spgemm(Aj, Aj.t()), rtol=rtol)
    _same(psp.gram(Ap), jsp.gram(Aj), rtol=rtol)
    if dtype != np.int64:
        assert Ap._gram_sym is not None
        _same(psp.gram(Ap), jsp.gram(Aj), rtol=rtol)  # the revalue cache hit
    # a rectangular product with general dimensions
    Bj = jt.CSC.from_scipy(sp.random(200, 77, density=0.05, format="csc",
                                     random_state=np.random.RandomState(3)
                                     ).astype(np.float64))
    _same(psp.spgemm(Ap, _port(Bj)), jsp.spgemm(Aj, Bj), rtol=rtol)
    with pytest.raises(ValueError, match="dim mismatch"):
        psp.spgemm(Ap, Ap)


def test_gram_revalue_runs_the_numeric_pass_alone(monkeypatch):
    from csparse3_tpu_torch.native import host_ext

    Aj, a = _hub()
    Ap = _port(Aj)
    first = psp.gram(Ap)
    monkeypatch.setattr(host_ext, "csc_gram_cached", None)  # must not run
    again = psp.gram(Ap)
    for x, y in zip(first.np_arrays(), again.np_arrays()):
        np.testing.assert_array_equal(x, y)
    # a float32 copy of the values misses the float64 cache and rebuilds
    monkeypatch.undo()
    A32 = csc_from_arrays(Ap.m, Ap.n, *Ap.np_arrays()[:2],
                          Ap.np_arrays()[2].astype(np.float32))
    A32._gram_sym = Ap._gram_sym
    g32 = psp.gram(A32)
    assert g32.np_arrays()[2].dtype == np.float32
    np.testing.assert_allclose(g32.np_arrays()[2], first.np_arrays()[2],
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_symbolic_matches_jax(dtype):
    Aj, a = _hub()
    Ap = _port(Aj)
    gj, gp = jsp.gram_symbolic(Aj), psp.gram_symbolic(Ap, device="cpu")
    assert gp.out_nnz == gj.out_nnz
    assert gp.n_products == len(gj.pa)  # the lower-triangle stream
    np.testing.assert_array_equal(gp.pa_s.numpy(), np.asarray(gj.pa))
    np.testing.assert_array_equal(gp.pb_s.numpy(), np.asarray(gj.pb))
    av = Aj.np_arrays()[2].astype(dtype)
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    Cp, Cj = gp.numeric(av), gj.numeric(jnp.asarray(av))
    _same(Cp, Cj, rtol=rtol)
    _same(Cp, jsp.gram(Aj).astype(dtype), rtol=rtol)
    # symmetric to the last bit: the mirror reads the same lower value
    d = Cp.to_scipy().toarray()
    np.testing.assert_array_equal(d, d.T)


def test_empty_products():
    Zj = jt.from_triplets(np.zeros(0, int), np.zeros(0, int), np.zeros(0),
                          (5, 7))
    Zp = _port(Zj)
    for plan in (psp.spgemm_symbolic(Zp, Zp.t(), device="cpu"),):
        C = plan.numeric(np.zeros(0), np.zeros(0))
        assert C.shape == (5, 5) and C.nnz == 0 and plan.n_products == 0
        assert plan.seg_ptr.tolist() == [0]
    G = psp.gram_symbolic(Zp, device="cpu").numeric(np.zeros(0))
    assert G.shape == (5, 5) and G.nnz == 0
    _same_pattern(psp.spgemm(Zp, Zp.t()), jsp.spgemm(Zj, Zj.t()))
    _same_pattern(psp.gram(Zp), jsp.gram(Zj))
    D = pspd.spgemm_device(Zp, Zp.t(), device="cpu")
    assert D.shape == (5, 5) and D.nnz == 0
    _same_pattern(D, jspd.spgemm_device(Zj, Zj.t()))


@pytest.mark.parametrize("capacity", [None, 30000])
def test_esc_spgemm_matches_jax(capacity):
    Aj, a = _hub()
    Bj = Aj.t()
    Ap, Bp = _port(Aj), _port(Bj)
    ej = jspd.ESCSpGEMM(Aj, Bj, capacity=capacity)
    ep = pspd.ESCSpGEMM(Ap, Bp, capacity=capacity, device="cpu")
    assert ep.total == ej.total == (capacity or 22075)
    outj = ej(Aj.data, Bj.data)
    outp = ep(Ap.np_arrays()[2], Bp.np_arrays()[2])
    nnz = int(outj[3])
    assert int(outp[3]) == nnz
    assert outp[1].shape[0] == outp[2].shape[0] == ep.total  # padded
    np.testing.assert_array_equal(outp[0].numpy(), np.asarray(outj[0]))
    np.testing.assert_array_equal(outp[1].numpy(), np.asarray(outj[1]))
    assert (outp[1][nnz:] == Ap.m).all() and (outp[2][nnz:] == 0).all()
    np.testing.assert_allclose(outp[2].numpy(), np.asarray(outj[2]),
                               rtol=1e-12, atol=1e-14)
    assert outp[0].dtype == torch.int32 and outp[3].dtype == torch.int32
    with pytest.raises(ValueError, match="capacity"):
        pspd.ESCSpGEMM(Ap, Bp, capacity=10, device="cpu")


def test_spgemm_device_and_gram_device_match_jax_and_host():
    Aj, a = _hub()
    Ap = _port(Aj)
    Dp, Dj = pspd.spgemm_device(Ap, Ap.t(), device="cpu"), \
        jspd.spgemm_device(Aj, Aj.t())
    _same(Dp, Dj)
    _same(pspd.gram_device(Ap, device="cpu"), jspd.gram_device(Aj))
    H = psp.gram(Ap)
    np.testing.assert_array_equal(Dp.np_arrays()[1], H.np_arrays()[1])
    np.testing.assert_allclose(Dp.np_arrays()[2], H.np_arrays()[2],
                               rtol=1e-12)


@pytest.mark.parametrize("grid", ["ieee14", "synthetic200"])
def test_gridcal_flow_matches_jax(grid):
    """connectivity -> C = Cf - Ct -> G = C C^T -> (G + G) ^T, then the
    plans and the device product on the same C: all agree with the JAX
    package, with scipy and with each other."""
    gp, gj = _grid_pair(grid)
    (Cfp, Ctp), (Cfj, Ctj) = pgrids.connectivity(gp), jgrids.connectivity(gj)
    Cp, Cj = Cfp - Ctp, Cfj - Ctj
    _same(Cp, Cj)
    Gp, Gj = Cp @ Cp.T, Cj @ Cj.T
    _same(Gp, Gj)
    _same(psp.gram(Cp), jsp.gram(Cj))
    _same(pt.add(psp.gram(Cp), Gp).t(), jt.add(jsp.gram(Cj), Gj).t())
    cs = Cj.to_scipy()
    ref = (cs @ cs.T).tocsc()
    ref.sort_indices()
    plan = psp.spgemm_symbolic(Cp, Cp.T, device="cpu")
    a32 = Cp.np_arrays()[2].astype(np.float32)
    b32 = Cp.T.np_arrays()[2].astype(np.float32)
    P = plan.numeric(a32, b32)
    Pj = jsp.spgemm_symbolic(Cj, Cj.t()).numeric(jnp.asarray(a32),
                                                 jnp.asarray(b32))
    _same(P, Pj, rtol=1e-6)
    for got in (Gp, P, psp.gram_symbolic(Cp, device="cpu").numeric(a32),
                pspd.spgemm_device(Cp, Cp.T, device="cpu")):
        np.testing.assert_array_equal(got.np_arrays()[0], ref.indptr)
        np.testing.assert_array_equal(got.np_arrays()[1], ref.indices)
        np.testing.assert_allclose(got.np_arrays()[2], ref.data, rtol=1e-6)


def test_new_entry_points_default_to_the_card():
    Aj, _ = _hub()
    Ap = _port(Aj)
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    for call in (lambda: psp.spgemm_symbolic(Ap, Ap.t()),
                 lambda: psp.gram_symbolic(Ap),
                 lambda: pspd.ESCSpGEMM(Ap, Ap.t()),
                 lambda: pspd.spgemm_device(Ap, Ap.t()),
                 lambda: pt.spmm(Ap, np.ones((200, 2))),
                 lambda: pt.BSRMatMatPlan(Ap.to_bsr((8, 8)), Ap.t().to_bsr((8, 8)))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    # host-only work needs no device
    assert psp.gram(Ap).nnz and (Ap - Ap).nnz == Ap.nnz


@pytest.mark.parametrize("idt", [np.int32, np.int64])
@pytest.mark.parametrize("vdt", [np.float32, np.float64, np.complex128])
def test_native_bindings_match_the_jax_packages(idt, vdt):
    """The port's own ctypes binding of the CSC kernels against the JAX
    package's binding of the same library source: equal arrays."""
    from csparse3_tpu.native import host_ext as jhx
    from csparse3_tpu_torch.native import host_ext as phx

    Aj, a = _hub()
    ip, ix, dt = Aj.np_arrays()
    ip, ix = ip.astype(idt), ix.astype(idt)
    dt = (dt * (1 + 1j)).astype(vdt) if vdt == np.complex128 else \
        dt.astype(vdt)
    m, n = Aj.shape
    tp, ti, tx = phx.csc_transpose(m, n, ip, ix, dt)
    for x, y in zip((tp, ti, tx), jhx.csc_transpose(m, n, ip, ix, dt)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert tp.dtype == idt and tx.dtype == vdt
    pairs = [
        (phx.csc_spgemm(m, ip, ix, dt, m, tp, ti, tx),
         jhx.csc_spgemm(m, ip, ix, dt, m, tp, ti, tx)),
        (phx.csc_gram(m, n, ip, ix, dt), jhx.csc_gram(m, n, ip, ix, dt)),
        (phx.csc_axpby(n, ip, ix, dt, 2.0, ip, ix, dt, -0.5),
         jhx.csc_axpby(n, ip, ix, dt, 2.0, ip, ix, dt, -0.5)),
    ]
    for got, ref in pairs:
        for x, y in zip(got, ref):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    # gram and the general product agree (the fused kernel sums in another
    # order), and the cached symbolic state revalues to the same numbers
    (gp, gi, gx), (sp_, si, sx) = pairs[1][0], pairs[0][0]
    np.testing.assert_array_equal(gi, si)
    np.testing.assert_allclose(gx, sx, rtol=1e-5 if vdt == np.float32
                               else 1e-13)
    cp, ci, cx, sym = phx.csc_gram_cached(m, n, ip, ix, dt)
    np.testing.assert_array_equal(cx, gx)
    np.testing.assert_array_equal(
        phx.csc_gram_revalue(ip, ix, dt, sym)[: sym["nnz"]], gx)
    with pytest.raises(ValueError, match="value dtype changed"):
        phx.csc_gram_revalue(ip, ix, dt.real.astype(
            np.float64 if vdt == np.float32 else np.float32), sym)
