"""BSR in the port against the JAX package on the same numpy inputs: the
container and its conversions, ``bsr_spmm`` (kernel K5) against the JAX
package's Pallas kernel, ``spmm`` with and without a block shape, and the
block operations of ``ops.bsr_ops``.

On the CPU the port's ``bsr_spmm`` runs the plain version of
``kernels.bsr_spmm``; the CUDA kernel is held to that plain version on a
card in tests/test_torch_gpu.py.  The JAX side runs ``bsr_spmm_pallas`` in
interpret mode.

Block patterns must be equal exactly.  Values: a row of the product sums
the same nonzero products in another order (the blocks' zeros add exactly):
rtol 1e-12 in float64, 1e-5 in float32; scipy is the third opinion.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.kernels.bsr_spmm_pallas import bsr_spmm_pallas
from csparse3_tpu.ops import bsr_ops as jbo
from csparse3_tpu.ops import matvec as jmv
from csparse3_tpu_torch.kernels import bsr_spmm as kbsr
from csparse3_tpu_torch.ops import bsr_ops as pbo
from csparse3_tpu_torch.ops import matvec as pmv
from csparse3_tpu_torch.utils.interop import bsr_from_arrays, csc_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _rand(m, n, density, seed, dtype=np.float64):
    a = sp.random(m, n, density=density, format="csc",
                  random_state=np.random.RandomState(seed)).astype(dtype)
    a.sort_indices()
    return a


def _diag100(dtype=np.float64):
    """Rows 100..300 empty: empty block rows must come out zero."""
    i = np.arange(100)
    return sp.csc_matrix((np.ones(100, dtype=dtype), (i, i)),
                         shape=(300, 300))


def _bsr_pair(a, block):
    """(port BSR on the CPU, JAX BSR) of one scipy matrix; the port's is
    built from the JAX container's arrays."""
    Bj = jt.CSC.from_scipy(a).to_bsr(block=block)
    Bp = bsr_from_arrays(Bj.m, Bj.n, np.asarray(Bj.indptr),
                         np.asarray(Bj.indices), np.asarray(Bj.data),
                         nnz_blocks=Bj.nnz_blocks, device="cpu")
    return Bp, Bj


def _same_bsr(p, j, rtol=1e-12):
    assert (p.m, p.n, p.R, p.C, p.nnz_blocks) == (j.m, j.n, j.R, j.C,
                                                 j.nnz_blocks)
    ip, ix, dt = p.np_arrays()
    k = j.nnz_blocks
    np.testing.assert_array_equal(ip, np.asarray(j.indptr))
    np.testing.assert_array_equal(ix, np.asarray(j.indices)[:k])
    dj = np.asarray(j.data)[:k]
    assert dt.dtype == dj.dtype
    np.testing.assert_allclose(dt, dj, rtol=rtol,
                               atol=rtol * np.abs(dj).max(initial=0))


SPMM_CASES = {
    # the cases of the JAX package's own Pallas tests
    "rect_k200": (lambda dt: _rand(300, 260, 0.03, 0, dt), (8, 128), 200),
    "ragged_vector": (lambda dt: _rand(100, 90, 0.05, 2, dt), (8, 128), None),
    "ragged_k37": (lambda dt: _rand(100, 90, 0.05, 2, dt), (8, 128), 37),
    "empty_block_rows": (_diag100, (8, 128), 8),
    # block shapes beyond the default
    "square_32x32": (lambda dt: _rand(256, 256, 0.03, 3, dt), (32, 32), 130),
    "odd_5x7": (lambda dt: _rand(123, 98, 0.06, 4, dt), (5, 7), 1),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_bsr_spmm_matches_jax_pallas_kernel(case, dtype):
    make, block, k = SPMM_CASES[case]
    a = make(dtype)
    Bp, Bj = _bsr_pair(a, block)
    rng = np.random.RandomState(1)
    X = (rng.rand(a.shape[1]) if k is None
         else rng.rand(a.shape[1], k)).astype(dtype)
    before = kbsr.LAUNCHES["bsr_spmm"]
    Y = pmv.bsr_spmm(Bp, torch.as_tensor(X))
    assert kbsr.LAUNCHES["bsr_spmm"] == before  # plain version: CPU
    assert Y.dtype == torch.as_tensor(X).dtype
    Yj = np.asarray(bsr_spmm_pallas(Bj, jnp.asarray(X)))
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    ref = a.astype(np.float64) @ X.astype(np.float64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=rtol, atol=rtol * scale)
    np.testing.assert_allclose(Y.numpy(), ref, rtol=rtol, atol=rtol * scale)
    np.testing.assert_allclose(
        Y.numpy(), np.asarray(jmv.bsr_spmm(Bj, jnp.asarray(X))), rtol=rtol,
        atol=rtol * scale)
    np.testing.assert_array_equal((Bp @ X).numpy(), Y.numpy())  # numpy X
    if case == "empty_block_rows":
        assert (Y[100:] == 0).all()


def test_bsr_spmm_plain_walks_the_blocks_in_chunks(monkeypatch):
    a = _rand(300, 260, 0.03, 0)
    Bp, _ = _bsr_pair(a, (8, 128))
    X = torch.as_tensor(np.random.RandomState(2).rand(260, 9))
    whole = pmv.bsr_spmm(Bp, X)
    monkeypatch.setattr(kbsr, "PLAIN_GATHER_BYTES", 3 * 128 * 9 * 8)
    np.testing.assert_allclose(pmv.bsr_spmm(Bp, X).numpy(), whole.numpy(),
                               rtol=1e-13)
    with pytest.raises(ValueError, match="dimension mismatch"):
        pmv.bsr_spmm(Bp, X[:100])
    with pytest.raises(ValueError, match="do not fit"):
        kbsr.bsr_spmm(Bp.m, Bp.n, Bp.indptr[:-1], Bp.indices, Bp.data, X)


def test_spmm_entry_stream_and_block_route_match_jax():
    a = _rand(120, 120, 0.05, 6)
    Aj = jt.CSC.from_scipy(a)
    Ap = csc_from_arrays(120, 120, *Aj.np_arrays())
    X = np.random.RandomState(7).rand(120, 9)
    ref = a @ X
    Ys = pt.spmm(Ap, X, device="cpu")
    np.testing.assert_allclose(Ys.numpy(), np.asarray(jt.spmm(Aj, X)),
                               rtol=1e-12)
    Yb = pt.spmm(Ap, torch.as_tensor(X), block=(8, 128))  # X's device
    np.testing.assert_allclose(
        Yb.numpy(), np.asarray(jt.spmm(Aj, jnp.asarray(X), backend="pallas")),
        rtol=1e-12)
    np.testing.assert_allclose(Yb.numpy(), ref, rtol=1e-12)
    cache = Ap._bsr_cache
    assert (cache.R, cache.C) == (8, 128)
    pt.spmm(Ap, X, block=(8, 128), device="cpu")
    assert Ap._bsr_cache is cache  # packed and placed once
    pt.spmm(Ap, X, block=(4, 4), device="cpu")
    assert (Ap._bsr_cache.R, Ap._bsr_cache.C) == (4, 4)
    with pytest.raises(ValueError, match="dimension mismatch"):
        pt.spmm(Ap, X[:50], device="cpu")


@pytest.mark.parametrize("block", [None, (8, 128), (4, 6), (32, 32)])
def test_csc_to_bsr_and_back_match_jax(block):
    a = _rand(100, 90, 0.05, 8)
    Aj = jt.CSC.from_scipy(a)
    Ap = csc_from_arrays(100, 90, *Aj.np_arrays(), device="cpu")
    Bp, Bj = Ap.to_bsr(block=block), Aj.to_bsr(block=block)
    _same_bsr(Bp, Bj)
    assert (Bp.mb, Bp.nb, Bp.nnz) == (Bj.mb, Bj.nb, Bj.nnz)
    assert (Bp.R, Bp.C) == (block or (8, 128))
    np.testing.assert_array_equal(Bp.todense().numpy(),
                                  np.asarray(Bj.todense()))
    np.testing.assert_array_equal(Bp.todense().numpy(), a.toarray())
    back_p, back_j = Bp.to_csc(), Bj.to_csc()
    for x, y in zip(back_p.np_arrays(), back_j.np_arrays()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(back_p.np_arrays(), Ap.np_arrays()):
        np.testing.assert_array_equal(x, y)
    assert Bp.to("cpu") is Bp and "BSR(m=100" in repr(Bp)


def test_bsr_scipy_round_trip_and_array_carrier():
    a = _rand(96, 64, 0.1, 9)
    Bs = a.tobsr(blocksize=(8, 16))
    Bp, Bj = pt.BSR.from_scipy(Bs, device="cpu"), jt.BSR.from_scipy(Bs)
    _same_bsr(Bp, Bj)
    np.testing.assert_array_equal(Bp.to_scipy().toarray(), a.toarray())
    assert Bp.to_scipy().blocksize == (8, 16)
    assert Bp.data.dtype == torch.float64 and Bp.indptr.device.type == "cpu"


def test_bsr_transpose_add_binop_match_jax():
    a, b = _rand(96, 64, 0.05, 10), _rand(96, 64, 0.05, 11)
    (Ap, Aj), (Bp, Bj) = _bsr_pair(a, (8, 16)), _bsr_pair(b, (8, 16))
    _same_bsr(pbo.bsr_transpose(Ap), jbo.bsr_transpose(Aj))
    _same_bsr(Ap.T, Aj.T)
    np.testing.assert_array_equal(Ap.t().todense().numpy(), a.T.toarray())
    _same_bsr(pbo.bsr_add(Ap, Bp), jbo.bsr_add(Aj, Bj))
    _same_bsr(pbo.bsr_add(Ap, Bp, alpha=2.0, beta=-0.5),
              jbo.bsr_add(Aj, Bj, alpha=2.0, beta=-0.5))
    _same_bsr(Ap + Bp, Aj + Bj)
    _same_bsr(Ap - Bp, Aj - Bj)
    _same_bsr(-Ap, -Aj)
    np.testing.assert_allclose((Ap - Bp).todense().numpy(),
                               (a - b).toarray(), rtol=1e-14)
    _same_bsr(pbo.bsr_binop(Ap, Bp, torch.maximum),
              jbo.bsr_binop(Aj, Bj, jnp.maximum))
    _same_bsr(Ap.multiply(Bp), Aj.multiply(Bj))
    with pytest.raises(ValueError, match="matching shape and block"):
        pbo.bsr_add(Ap, _bsr_pair(b, (4, 16))[0])
    # operands of different block shapes go through CSC
    Cp, Cj = _bsr_pair(b, (4, 16))
    _same_bsr(Ap + Cp, Aj + Cj)
    _same_bsr(Ap - Cp, Aj - Cj)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_matmat_plan_matches_jax(dtype):
    a, b = _rand(96, 64, 0.05, 12, dtype), _rand(64, 80, 0.05, 13, dtype)
    (Ap, Aj), (Bp, Bj) = _bsr_pair(a, (8, 16)), _bsr_pair(b, (16, 4))
    pj, pp = jbo.BSRMatMatPlan(Aj, Bj), pbo.BSRMatMatPlan(Ap, Bp,
                                                          device="cpu")
    assert pp.out_nblocks == pj.out_nblocks and (pp.R, pp.Q) == (8, 4)
    np.testing.assert_array_equal(pp.gid.numpy(), np.asarray(pj.gid))
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    Cp = pp.numeric(Ap.data, Bp.data)
    _same_bsr(Cp, pj.numeric(Aj.data, Bj.data), rtol=rtol)
    ref = (a.astype(np.float64) @ b.astype(np.float64)).toarray()
    np.testing.assert_allclose(Cp.todense().numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    _same_bsr(pbo.bsr_matmat(Ap, Bp), jbo.bsr_matmat(Aj, Bj), rtol=rtol)
    _same_bsr(Ap @ Bp, Aj @ Bj, rtol=rtol)
    # new values on the same plan (numpy operands)
    C2 = pp.numeric(np.asarray(Aj.data) * 2, np.asarray(Bj.data))
    np.testing.assert_allclose(C2.todense().numpy(), 2 * ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    with pytest.raises(ValueError, match="dim/block mismatch"):
        pbo.BSRMatMatPlan(Ap, Ap, device="cpu")
    # inner block sizes that differ go through CSC
    Dp, Dj = _bsr_pair(b, (8, 4))
    _same_bsr(Ap @ Dp, Aj @ Dj, rtol=rtol)


def test_bsr_matmat_with_an_empty_product():
    z = sp.csc_matrix((64, 64))
    Zp, Zj = _bsr_pair(z, (8, 8))
    Ap, Aj = _bsr_pair(_rand(64, 64, 0.05, 14), (8, 8))
    assert Zp.nnz_blocks == 0
    _same_bsr(Ap @ Zp, Aj @ Zj)
    assert (pmv.bsr_spmm(Zp, torch.ones(64, 3, dtype=torch.float64)) == 0).all()


# -- the column lists ----------------------------------------------------------

LIST_CASES = {
    "ragged_8x128": (lambda dt: _rand(100, 90, 0.05, 2, dt), (8, 128)),
    "rect_8x128": (lambda dt: _rand(300, 260, 0.03, 0, dt), (8, 128)),
    "empty_block_rows_8x128": (_diag100, (8, 128)),
    "square_32x32": (lambda dt: _rand(256, 256, 0.03, 3, dt), (32, 32)),
    "full_blocks_32x32": (lambda dt: _rand(96, 64, 0.9, 15, dt), (32, 32)),
    "odd_3x5": (lambda dt: _rand(100, 93, 0.05, 16, dt), (3, 5)),
}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_column_lists_cover_every_nonzero_of_the_blocks(case):
    make, block = LIST_CASES[case]
    Bp, _ = _bsr_pair(make(np.float64), block)
    col_ptr, col_idx = Bp.column_lists()
    assert col_ptr.dtype == col_idx.dtype == torch.int32
    assert col_ptr.shape == (Bp.nnz_blocks + 1,) and col_ptr[0] == 0 \
        and col_ptr[-1] == col_idx.shape[0]
    data = Bp.np_arrays()[2]
    for p in range(Bp.nnz_blocks):
        cols = col_idx[col_ptr[p]:col_ptr[p + 1]].numpy()
        np.testing.assert_array_equal(
            cols, np.flatnonzero((data[p] != 0).any(axis=0)))
    # built once, kept with the container and with the one ``to`` returns
    assert Bp.column_lists() is Bp.column_lists()
    assert Bp.to("cpu").column_lists()[1] is col_idx
    if case == "full_blocks_32x32":  # every list is the whole block
        assert (col_ptr.diff() == 32).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [None, 1, 37])
@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_bsr_spmm_plain_with_lists_equals_without_and_jax(case, k, dtype):
    make, block = LIST_CASES[case]
    a = make(dtype)
    Bp, Bj = _bsr_pair(a, block)
    rng = np.random.RandomState(17)
    X = (rng.rand(a.shape[1]) if k is None
         else rng.rand(a.shape[1], k)).astype(dtype)
    nb = Bp.nnz_blocks
    args = (Bp.m, Bp.n, Bp.indptr, Bp.indices[:nb], Bp.data[:nb],
            torch.as_tensor(X))
    dense = kbsr.bsr_spmm_plain(*args)
    listed = kbsr.bsr_spmm_plain(*args, Bp.column_lists())
    assert listed.shape == dense.shape and listed.dtype == dense.dtype
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    ref = a.astype(np.float64) @ X.astype(np.float64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(listed.numpy(), dense.numpy(), rtol=rtol,
                               atol=rtol * scale)
    np.testing.assert_allclose(listed.numpy(), ref, rtol=rtol,
                               atol=rtol * scale)
    np.testing.assert_allclose(
        listed.numpy(), np.asarray(bsr_spmm_pallas(Bj, jnp.asarray(X))),
        rtol=rtol, atol=rtol * scale)
    # the container's product walks its lists; the raw call without lists
    # still takes every column
    assert torch.equal(pmv.bsr_spmm(Bp, torch.as_tensor(X)), listed)
    assert torch.equal(kbsr.bsr_spmm(*args), dense)
    if case == "empty_block_rows_8x128":
        assert (listed[100:] == 0).all()


def test_bsr_spmm_with_lists_walks_in_chunks_and_refuses_bad_lists(
        monkeypatch):
    a = _rand(300, 260, 0.03, 0)
    Bp, _ = _bsr_pair(a, (8, 128))
    X = torch.as_tensor(np.random.RandomState(2).rand(260, 9))
    nb = Bp.nnz_blocks
    args = (Bp.m, Bp.n, Bp.indptr, Bp.indices[:nb], Bp.data[:nb], X)
    cols = Bp.column_lists()
    whole = kbsr.bsr_spmm_plain(*args, cols)
    monkeypatch.setattr(kbsr, "PLAIN_GATHER_BYTES", 5 * 8 * 9 * 8)
    np.testing.assert_allclose(kbsr.bsr_spmm_plain(*args, cols).numpy(),
                               whole.numpy(), rtol=1e-13)
    with pytest.raises(ValueError, match="column lists"):
        kbsr.bsr_spmm(*args, (cols[0][:-1], cols[1]))
    with pytest.raises(ValueError, match="column lists"):
        kbsr.bsr_spmm(*args, (cols[0].long(), cols[1]))
    with pytest.raises(ValueError, match="CUDA device"):
        kbsr.bsr_spmm_cuda(*args, cols)


def test_spmv_and_spmm_place_the_matrix_and_its_streams_once():
    a = _rand(120, 120, 0.05, 6)
    A = csc_from_arrays(120, 120, a.indptr, a.indices, a.data)  # no device
    x = torch.as_tensor(np.random.RandomState(3).rand(120))
    y1 = pmv.spmv(A, x)
    placed = A.to("cpu")
    streams = placed.entry_streams()
    y2 = pmv.spmm(A, torch.stack([x, x], dim=1))
    assert A.to(x.device) is placed and placed.to("cpu") is placed
    assert placed.entry_streams() is streams
    assert placed.data.data_ptr() == A.to("cpu").data.data_ptr()
    np.testing.assert_array_equal(streams[1].numpy(),
                                  np.repeat(np.arange(120), np.diff(a.indptr)))
    np.testing.assert_allclose(y1.numpy(), a @ x.numpy(), rtol=1e-12)
    np.testing.assert_allclose(y2[:, 1].numpy(), y1.numpy(), rtol=1e-12)
