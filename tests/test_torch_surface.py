"""Parity of the rest of the port's public surface with the JAX package:
the constructors and the complex-embedding helpers, ``validate``, ``norm``,
``sum`` and the other CSC methods, stacking, ``utils.misc``, the
reference aliases, and the export list itself.

Tolerances: structure (indptr, indices, shapes, flags, error messages)
equal; values built by the same host numpy code equal to rtol 1e-14
(``RTOL``); the device reductions (``norm``, ``sum``, ``diagonal``) sum
in another order than the JAX segment sums, so within 1e-13 of the
largest magnitude (``SUM_RTOL``); stacking exact.
"""

import math

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import csparse3_tpu as jt
import csparse3_tpu.linalg as jlin
import csparse3_tpu.parallel as jpar
import csparse3_tpu_torch as pt
import csparse3_tpu_torch.linalg as plin
import csparse3_tpu_torch.parallel as ppar
from csparse3_tpu.ops import construct as jcon
from csparse3_tpu.ops import reductions as jred
from csparse3_tpu_torch.ops import construct as pcon
from csparse3_tpu_torch.ops import reductions as pred

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

RTOL = 1e-14
SUM_RTOL = 1e-13


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_csc(p, j, rtol=RTOL):
    assert p.shape == j.shape
    for got, ref in zip(p.np_arrays(), j.np_arrays()):
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def _both(s):
    """The same scipy matrix as a CSC of each package (the port's on the
    CPU)."""
    s = sp.csc_matrix(s)
    return pt.CSC.from_scipy(s, device="cpu"), jt.CSC.from_scipy(s)


def _rand(m, n, density, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    a = sp.random(m, n, density=density, random_state=rng, format="csc",
                  dtype=np.float64)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * sp.random(m, n, density=density, random_state=rng,
                               format="csc")
    a = a.astype(dtype).tocsc()
    a.sum_duplicates()
    return a


CONSTRUCT = {
    "eye": lambda m: m.eye(5),
    "eye_k2": lambda m: m.eye(6, k=2),
    "eye_km1_f32": lambda m: m.eye(4, dtype=np.float32, k=-1),
    "diag": lambda m: m.diag(4, 6, 3.0),
    "diags_real": lambda m: m.diags(np.arange(1.0, 6.0)),
    "diags_complex": lambda m: m.diags(np.arange(4) * (1 + 2j)),
    "random_csc": lambda m: m.random_csc(30, 40, density=0.1, seed=3),
    "random_csc_f32": lambda m: m.random_csc(20, 10, 0.3, seed=1,
                                             dtype=np.float32),
    "dense_to_csc": lambda m: m.dense_to_csc(
        np.where(np.arange(30).reshape(5, 6) % 4 == 0, 0.0,
                 np.arange(30.0).reshape(5, 6))),
    "from_dense": lambda m: m.CSC.from_dense(np.eye(3) * 2 - np.eye(3, k=1)),
}


@pytest.mark.parametrize("case", sorted(CONSTRUCT))
def test_constructors_match_jax(case):
    _same_csc(CONSTRUCT[case](pt), CONSTRUCT[case](jt))


def test_constructors_keep_the_device_they_are_given():
    assert pt.eye(3, device="cpu").device == torch.device("cpu")
    d = pt.diags(torch.arange(3.0))
    assert d.device == torch.device("cpu")
    np.testing.assert_array_equal(_np(d.todense()), np.diag([0.0, 1.0, 2.0]))
    assert pt.dense_to_csc(torch.eye(2)).device == torch.device("cpu")


def test_expand_and_compress_indptr_match_jax():
    a = _rand(7, 9, 0.3, 2)
    ip = a.indptr.astype(np.int32)
    got = pt.expand_indptr(torch.as_tensor(ip), a.nnz)
    ref = jt.expand_indptr(jax.numpy.asarray(ip), a.nnz)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert got.dtype == torch.int32
    back = pcon.compress_indptr(got, 9)
    np.testing.assert_array_equal(_np(back), np.asarray(
        jcon.compress_indptr(ref, 9)))
    np.testing.assert_array_equal(_np(back), ip)
    assert _np(pt.expand_indptr(torch.as_tensor(ip), 0)).shape == (0,)


@pytest.mark.parametrize("interleave", [True, False])
def test_complex_embedding_helpers_match_jax(interleave):
    s = _rand(12, 12, 0.25, 5, np.complex128) + sp.eye(12) * (3 + 1j)
    p, j = _both(s)
    _same_csc(pcon.real_equivalent(p, interleave=interleave),
              jcon.real_equivalent(j, interleave=interleave))
    real = _both(_rand(5, 5, 0.5, 1))[0]
    assert pcon.real_equivalent(real) is real
    perm = np.random.RandomState(3).permutation(12)
    for b in (np.arange(12) * (1 - 0.5j),
              np.random.RandomState(4).rand(12, 3).astype(np.complex64)):
        got, sq = pcon.complex_rhs_to_real(b, perm)
        ref, sq_j = jcon.complex_rhs_to_real(b, perm)
        assert sq == sq_j and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(pcon.real_x_to_complex(got, perm, sq),
                                      jcon.real_x_to_complex(ref, perm, sq))
        np.testing.assert_allclose(pcon.real_x_to_complex(got, perm, sq), b,
                                   rtol=1e-7)
    for s_ in (None, 8, 40):
        assert (pcon.complex_embed_block_size(s_)
                == jcon.complex_embed_block_size(s_))


def _broken(mod, kind):
    """A container of ``mod`` with one structural fault."""
    ip = np.array([0, 2, 3, 5], dtype=np.int32)
    ix = np.array([0, 2, 1, 0, 3], dtype=np.int32)
    dt = np.arange(1.0, 6.0)
    if kind == "ok":
        return mod.CSC(4, 3, ip, ix, dt)
    if kind == "indptr_len":
        return mod.CSC(4, 4, ip, ix, dt)
    if kind == "indptr0":
        return mod.CSC(4, 3, ip + 1, ix, dt, nnz=5)
    if kind == "monotone":
        return mod.CSC(4, 3, np.array([0, 3, 2, 5], np.int32), ix, dt)
    if kind == "nnz":
        return mod.CSC(4, 3, ip, ix, dt, nnz=4)
    if kind == "bounds":
        return mod.CSC(3, 3, ip, ix, dt)
    if kind == "unsorted":
        return mod.CSC(4, 3, ip, np.array([2, 0, 1, 0, 3], np.int32), dt,
                       canonical=False)
    if kind == "csr_bounds":
        return mod.CSR(3, 3, ip, ix, dt)
    if kind == "coo_bounds":
        return mod.COO(3, 3, ix, np.array([0, 1, 2, 3, 0]), dt)
    if kind == "coo_ok":
        return mod.COO(4, 4, ix, np.array([0, 1, 2, 3, 0]), dt)
    raise KeyError(kind)


BROKEN = ["ok", "indptr_len", "indptr0", "monotone", "nnz", "bounds",
          "unsorted", "csr_bounds", "coo_bounds", "coo_ok"]


def _verdict(mod, a, **kw):
    try:
        mod.validate(a, **kw)
        return "ok"
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("kind", BROKEN)
def test_validate_matches_jax(kind):
    p, j = _broken(pt, kind), _broken(jt, kind)
    for kw in ({}, {"check_sorted": True}):
        assert _verdict(pt, p, **kw) == _verdict(jt, j, **kw)
    if kind not in ("coo_bounds", "coo_ok"):
        assert pt.has_sorted_indices(p) == jt.has_sorted_indices(j)
        assert pt.has_canonical_format(p) == jt.has_canonical_format(j)
    if kind == "ok":
        assert pt.validate(p) is p


def test_sorted_and_canonical_flags_on_duplicates_match_jax():
    rows, cols = [0, 0, 2, 1, 1], [0, 0, 0, 1, 2]
    p = pt.from_triplets(rows, cols, np.ones(5), (3, 3), sum_duplicates=False)
    j = jt.from_triplets(rows, cols, np.ones(5), (3, 3), sum_duplicates=False)
    assert (pt.has_sorted_indices(p), pt.has_canonical_format(p)) == (
        jt.has_sorted_indices(j), jt.has_canonical_format(j)) == (True, False)
    with pytest.raises(TypeError, match="cannot validate"):
        pt.validate(np.eye(2))


@pytest.mark.parametrize("ord_", [1, math.inf, "inf", "fro", "f", 2])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_norm_matches_jax_and_scipy(ord_, dtype):
    s = _rand(23, 17, 0.2, 8, dtype)
    p, j = _both(s)
    got = pt.norm(p, ord_)
    assert isinstance(got, torch.Tensor) and got.ndim == 0
    assert got.device == torch.device("cpu")
    ref = float(jt.norm(j, ord_))
    sref = spla.norm(s, {"inf": np.inf, "f": "fro", 2: "fro"}.get(
        ord_, ord_))
    assert abs(float(got) - ref) <= SUM_RTOL * ref
    assert abs(float(got) - sref) <= SUM_RTOL * sref
    assert float(p.norm(ord_)) == float(got)


def test_norm_of_empty_matrices_and_bad_ord_match_jax():
    for shape in [(4, 5), (0, 3), (3, 0)]:
        p = pt.from_triplets([], [], np.zeros(0), shape, device="cpu")
        j = jt.from_triplets([], [], np.zeros(0), shape)
        for o in (1, np.inf, "fro"):
            assert float(pt.norm(p, o)) == float(jt.norm(j, o)) == 0.0
    with pytest.raises(ValueError, match="unsupported norm"):
        pt.norm(p, 3)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sum_and_diagonal_match_jax(dtype):
    s = _rand(15, 11, 0.3, 4, dtype)
    p, j = _both(s)
    for axis in (None, 0, 1):
        got, ref = p.sum(axis), np.asarray(jred.sum(j, axis))
        assert got.device == torch.device("cpu")
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=SUM_RTOL * np.abs(ref).max())
        np.testing.assert_allclose(_np(pred.sum(p, axis)), _np(got), rtol=0)
    np.testing.assert_allclose(_np(p.diagonal()), np.asarray(j.diagonal()),
                               rtol=RTOL)
    with pytest.raises(ValueError, match="bad axis"):
        p.sum(2)


def test_csc_methods_match_jax():
    s = _rand(9, 7, 0.35, 6, np.complex128)
    p, j = _both(s)
    assert p.get_nnz() == j.get_nnz() == s.nnz
    _same_csc(p.conj(), j.conj())
    _same_csc(p.astype(np.complex64), j.astype(np.complex64))
    q = p.astype(torch.complex64)
    assert q.dtype == torch.complex64 and q.device == torch.device("cpu")
    c = p.copy()
    _same_csc(c, j.copy())
    assert not np.shares_memory(c.np_arrays()[2], p.np_arrays()[2])
    # methods on a container whose values are a tensor keep the tensor form
    t = pt.CSC(*s.shape, torch.as_tensor(s.indptr), torch.as_tensor(s.indices),
               torch.as_tensor(s.data))
    for made in (t.conj(), t.astype(np.complex64), t.copy()):
        assert made.device == torch.device("cpu")
    np.testing.assert_array_equal(t.conj().np_arrays()[2], np.conj(s.data))
    assert t.copy().data.data_ptr() != t.data.data_ptr()
    with pytest.raises(TypeError) as ep:
        p[0, 0] = 1.0
    with pytest.raises(TypeError) as ej:
        j[0, 0] = 1.0
    assert str(ep.value) == str(ej.value)


def test_islands_method_matches_jax():
    s = sp.csc_matrix(sp.block_diag([np.ones((2, 2)), np.ones((3, 3)),
                                     np.ones((1, 1))]))
    p, j = _both(s)
    for a, b in zip(p.islands(), j.islands()):
        np.testing.assert_array_equal(a, b)


def _stack_parts(dtypes):
    shapes = [(6, 5), (6, 4), (3, 5), (3, 4)]
    mats = [_rand(m, n, 0.4, 10 + i, dt)
            for i, ((m, n), dt) in enumerate(zip(shapes, dtypes))]
    return mats, [_both(m) for m in mats]


@pytest.mark.parametrize("dtypes", [
    (np.float64,) * 4,
    (np.float32, np.float64, np.float32, np.float32),
    (np.float64, np.complex128, np.float64, np.float64),
])
def test_stacking_matches_jax_exactly(dtypes):
    mats, pairs = _stack_parts(dtypes)
    P = [p for p, _ in pairs]
    J = [j for _, j in pairs]
    _same_csc(pt.pack_4_by_4(*P), jt.pack_4_by_4(*J), rtol=0)
    got = pt.pack_4_by_4(*P).to_scipy()
    assert (got != sp.bmat([[mats[0], mats[1]], [mats[2], mats[3]]])).nnz == 0
    _same_csc(pt.hstack(P[:2]), jt.hstack(J[:2]), rtol=0)
    _same_csc(pt.vstack([P[0], P[2]]), jt.vstack([J[0], J[2]]), rtol=0)
    _same_csc(pt.block([[P[0], None], [None, P[3]]]),
              jt.block([[J[0], None], [None, J[3]]]), rtol=0)
    assert pt.block([[P[0], P[1]]]).device == torch.device("cpu")


def test_stacking_errors_and_empty_blocks_match_jax():
    p, j = _both(_rand(3, 3, 0.0, 0))
    _same_csc(pt.block([[p, None], [None, p]]),
              jt.block([[j, None], [None, j]]), rtol=0)
    p2, j2 = _both(_rand(4, 3, 0.5, 1))
    for grid_p, grid_j in [([[p, p2]], [[j, j2]]),
                           ([[p], [p, p]], [[j], [j, j]]),
                           ([[p, None], [None, None]],
                            [[j, None], [None, None]])]:
        with pytest.raises(ValueError) as ep:
            pt.block(grid_p)
        with pytest.raises(ValueError) as ej:
            jt.block(grid_j)
        assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("sl", [slice(None), slice(2, 9, 3), slice(-3, None),
                                slice(None, None, -2), slice(5, 100)])
def test_slice_to_range_matches_jax(sl):
    np.testing.assert_array_equal(pt.slice_to_range(sl, 10),
                                  jt.slice_to_range(sl, 10))


def test_dense_to_str_matches_jax():
    m = np.array([[0.0, 1.5, 0.0], [2.0, 0.0, -3.25]])
    assert pt.dense_to_str(m) == jt.dense_to_str(m)
    assert pt.dense_to_str(torch.as_tensor(m)) == jt.dense_to_str(m)


def test_reference_aliases():
    assert pt.CscMat is pt.CSC
    assert pt.Diag is pt.diag and pt.Diags is pt.diags
    s = _rand(5, 4, 0.5, 2)
    a = pt.scipy_to_mat(s, device="cpu")
    _same_csc(a, jt.scipy_to_mat(s))
    assert a.device == torch.device("cpu")
    _same_csc(pt.Diag(3, 4, 2.0), jt.Diag(3, 4, 2.0))
    _same_csc(pt.Diags(np.arange(3.0)), jt.Diags(np.arange(3.0)))


# every public name of the JAX package, of its ``linalg`` and of its
# ``parallel`` exists in the port; every name of ROADMAP's "Not to port"
# list is absent from the JAX package's export lists or present in the port
# under the same name
@pytest.mark.parametrize("pair", ["package", "linalg", "parallel"])
def test_export_checklist(pair):
    ref, port = {"package": (jt, pt), "linalg": (jlin, plin),
                 "parallel": (jpar, ppar)}[pair]
    names = {n for n in dir(ref) if not n.startswith("_")}
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


# ---------------------------------------------------------------------------
# module by module: every public function and class of the JAX package, and
# every public method or property of each of its classes, is in the port's
# module of the same name, but for ROADMAP's "Not to port"
# ---------------------------------------------------------------------------

#: ROADMAP's "Not to port", as names: a module of the JAX package, or a
#: name in one ("Class.attr" for a class's), or, under "*", a method of any
#: class
NOT_TO_PORT = {
    "*": {"tree_flatten", "tree_unflatten"},  # the pytree methods
    "config": {"on_tpu", "Config.backend", "Config.growth",
               "Config.deterministic"},
    "ops.construct": {"is_traced", "container_traced", "csc_to_bcoo",
                      "bcoo_to_csc"},
    "types": {"CSC.to_bcoo", "CSC.from_bcoo"},
    "models.powerflow": {"NewtonPowerFlow.run_fn", "FastDecoupled.plans",
                         "FastDecoupled.functional_step"},
    "parallel.solve": {"BlockJacobi.specs", "DiagJacobi.specs"},
    "linalg.trisolve": {"TriSolvePlan.unroll"},
    "kernels.spgemm_pallas": {"build_numeric_pallas_maps",
                              "numeric_pallas_or_none"},
    "utils.roofline": {"measure_mxu_f32", "measure_mxu_bf16",
                       "measure_vpu_f32", "traced_loop_s",
                       "device_trace_events", "measure_onehot_mix",
                       "measure_small_dot", "bandpoints_binding_model"},
    "kernels.spmv_pallas": "module",
    "ops.gather": "module",
    "utils.hostmem": "module",
    "utils.xfer": "module",
}

#: the Pallas modules' counterparts: the module of each hand kernel
PORTED_AS = {"kernels.dia_pallas": "kernels.dia",
             "kernels.bsr_spmm_pallas": "kernels.bsr_spmm",
             "kernels.spgemm_pallas": "kernels.spgemm"}

#: the Pallas entry points, by the name of the CUDA launch that replaces
#: each (K1-K3 are one kernel, launched by the plan)
RENAMED = {"dia_spmv_pallas": "dia_spmv_cuda",
           "bsr_spmm_pallas": "bsr_spmm_cuda",
           "spgemm_numeric_pallas": "spgemm_numeric_cuda",
           "points_spmv_pallas": "SplitBandPoints.cuda_kernel",
           "band_points_spmv_pallas": "SplitBandPoints.cuda_kernel",
           "band_points_supertile_pallas": "SplitBandPoints.cuda_kernel"}


def _jax_modules():
    """The JAX package's Python modules, relative dotted names ('' for the
    package), read from its source tree."""
    import pathlib

    root = pathlib.Path(jt.__file__).parent
    names = {".".join(p.relative_to(root).with_suffix("").parts)
             .removesuffix("__init__").rstrip(".")
             for p in root.rglob("*.py")}
    return sorted(n for n in names if NOT_TO_PORT.get(n) != "module")


def _defined(mod):
    """{name: None for a function, the public attributes of a class} of
    what ``mod`` defines itself (jitted functions included)."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or not callable(obj) or \
                getattr(obj, "__module__", None) != mod.__name__:
            continue
        out[name] = (sorted(k for k in vars(obj) if not k.startswith("_"))
                     if isinstance(obj, type) else None)
    return out


def _resolve(mod, dotted):
    obj = mod
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
    return obj


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_surface_matches_jax(rel):
    import importlib

    jname = "csparse3_tpu" + (f".{rel}" if rel else "")
    prel = PORTED_AS.get(rel, rel)
    jm = importlib.import_module(jname)
    pm = importlib.import_module("csparse3_tpu_torch"
                                 + (f".{prel}" if prel else ""))
    skip = NOT_TO_PORT.get(rel, set()) | NOT_TO_PORT["*"]
    missing = []
    for name, attrs in _defined(jm).items():
        if name in skip:
            continue
        port = _resolve(pm, RENAMED.get(name, name))
        if port is None:
            missing.append(name)
            continue
        missing += [f"{name}.{a}" for a in attrs or ()
                    if a not in skip and f"{name}.{a}" not in skip
                    and not hasattr(port, a)]
    assert not missing, missing


def test_not_to_port_names_exist_in_jax():
    """Every exclusion names surface the JAX package has: the list cannot
    hide a name that is not there."""
    import importlib

    for rel, names in NOT_TO_PORT.items():
        if rel == "*":
            continue
        jm = importlib.import_module(f"csparse3_tpu.{rel}")
        if names == "module":
            continue
        for name in names:
            assert _resolve(jm, name) is not None, (rel, name)


def test_config_update_and_ctx_match_jax():
    from csparse3_tpu import config as jcfg
    from csparse3_tpu_torch import config as pcfg

    for cfg in (jcfg, pcfg):
        with cfg.config_ctx(bsr_block=(4, 4)) as c:
            assert c.bsr_block == (4, 4) == cfg.get_config().bsr_block
        assert cfg.get_config().bsr_block == (8, 128)
        with pytest.raises(ValueError, match="unknown config field"):
            cfg.update(no_such_field=1)
    s = sp.random(9, 10, density=0.3, random_state=np.random.RandomState(1))
    with pcfg.config_ctx(bsr_block=(3, 5)):
        assert (pt.CSC.from_scipy(s, device="cpu").to_bsr().R,) == (3,)


def test_small_surface_repairs_match_jax():
    from csparse3_tpu.native import host_ext as jhx
    from csparse3_tpu_torch.linalg import trisolve as ptri
    from csparse3_tpu_torch.native import host_ext as phx

    assert pt.__version__ == jt.__version__
    assert pt.types.Dense is jt.types.Dense
    rng = np.random.RandomState(4)
    rows, cols = rng.randint(0, 7, 30), rng.randint(0, 9, 30)
    vals = rng.randn(30)
    for got, ref in zip(phx.coo_to_csc(7, 9, rows, cols, vals),
                        jhx.coo_to_csc(7, 9, rows, cols, vals)):
        np.testing.assert_array_equal(got, ref)
    d = sp.random(6, 8, density=0.4, random_state=rng).todia()
    got = pt.DIA.from_scipy(d, device="cpu").todense()
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(jt.DIA.from_scipy(d).todense()))
    L = sp.tril(_rand(12, 12, 0.3, 3) + sp.eye(12) * 4).tocsc()
    plan = ptri.TriSolvePlan(12, L.indptr, L.indices, L.data, lower=True,
                             device="cpu")
    b = torch.as_tensor(rng.randn(12))
    assert torch.equal(plan.solve(b), plan(b))
    assert ptri.DenseTailTriSolvePlan.solve is \
        ptri.DenseTailTriSolvePlan.forward
