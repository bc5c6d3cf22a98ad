"""ctypes binding of the native host kernels in ``native/`` (repo root).

The same C++ as the JAX package's binding (``native/host_ext.cpp`` and
``native/lu_sn.cpp``), compiled at first use with ``g++`` and the flags of
``native/Makefile`` into the port's build directory (utils/build.py).  The
library is built on the machine that loads it, so ``-march=native`` names
that machine's CPU.  A failed build raises: at 10k buses the pure-numpy LU
would turn a broken build into a run hours long, so nothing falls back.

Only the entry points the port calls, and the JAX package's public ones,
are bound: sparse LU (scalar Gilbert-Peierls and supernodal), sparse
LDL^T, the AMD / RCM / nested-dissection orderings, the maximum
transversal and the block triangular form, the symbolic build of the
device refactorization, the CSC products and merges of the sparse-product
path (SpGEMM, gram with its cached symbolic phase, axpby, transpose), and
the triplet assembly ``coo_to_csc``.  The CSC operations take int32 index
arrays as they are (half the index traffic, no conversion copies) and
anything else as int64.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import subprocess

import numpy as np

from ..linalg.lu_host import HostLU
from ..utils.build import REPO_ROOT, BuildError, build_shared_library

__all__ = ["load", "lu_factor", "lu_factor_sn", "ldlt_factor", "amd", "rcm",
           "nd", "max_transversal", "btf",
           "refactor_build", "coo_to_csc", "csc_spgemm", "csc_axpby",
           "csc_gram", "csc_gram_cached", "csc_gram_revalue",
           "csc_transpose"]

_SOURCES = [os.path.join(REPO_ROOT, "native", f)
            for f in ("host_ext.cpp", "lu_sn.cpp", "host_common.h")]
# native/Makefile CXXFLAGS; -ffp-contract=off keeps exact cancellations
# exact, so singular columns are detected as in the numpy reference
_CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-fPIC", "-pthread", "-Wall", "-Wextra"]

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


class _LUResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("lnz", ctypes.c_int64),
        ("unz", ctypes.c_int64),
        ("nsing", ctypes.c_int64),
        ("Lp", _i64p),
        ("Li", _i64p),
        ("Up", _i64p),
        ("Ui", _i64p),
        ("perm_r", _i64p),
        ("sing", _i64p),
        ("Lx", ctypes.c_void_p),
        ("Ux", ctypes.c_void_p),
    ]


class _LDLTResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("lnz", ctypes.c_int64),
        ("nsing", ctypes.c_int64),
        ("Lp", _i64p),
        ("Li", _i64p),
        ("sing", _i64p),
        ("Lx", ctypes.c_void_p),
        ("D", ctypes.c_void_p),
    ]


class _RefactorBuild(ctypes.Structure):
    _fields_ = [
        ("total", ctypes.c_int64),
        ("ndiv", ctypes.c_int64),
        ("nlev", ctypes.c_int64),
        ("upd_dst", _i64p),
        ("upd_L", _i64p),
        ("upd_U", _i64p),
        ("upd_lev", _i64p),
        ("div_dst", _i64p),
        ("div_piv", _i64p),
        ("div_lev", _i64p),
        ("a_dst", _i64p),
    ]


class _Lib:
    """The loaded library with its ``argtypes``/``restype`` declared."""

    def __init__(self, path):
        lib = ctypes.CDLL(path)
        for name in ("lu_factor_d", "lu_factor_z"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(_LUResult)
            fn.argtypes = [ctypes.c_int64, _i64p, _i64p, ctypes.c_void_p,
                           _i64p, ctypes.c_double, ctypes.c_int64]
        for name in ("lu_factor_sn_d", "lu_factor_sn_z"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(_LUResult)
            fn.argtypes = [ctypes.c_int64, _i64p, _i64p, ctypes.c_void_p,
                           _i64p]
        lib.lu_free.restype = None
        lib.lu_free.argtypes = [ctypes.POINTER(_LUResult)]
        for name in ("ldlt_factor_d", "ldlt_factor_z"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(_LDLTResult)
            fn.argtypes = [ctypes.c_int64, _i64p, _i64p, ctypes.c_void_p]
        lib.ldlt_free.restype = None
        lib.ldlt_free.argtypes = [ctypes.POINTER(_LDLTResult)]
        lib.max_transversal.restype = ctypes.c_int64
        lib.max_transversal.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
        lib.btf_order.restype = None
        lib.btf_order.argtypes = [ctypes.c_int64] + [_i64p] * 6
        lib.lu_load_blas.restype = ctypes.c_int
        lib.lu_load_blas.argtypes = [ctypes.c_char_p]
        for name in ("amd_order", "rcm_order"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
        lib.nd_order.restype = None
        lib.nd_order.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                 ctypes.c_int64, _i64p]
        lib.coo_to_csc_d.restype = ctypes.c_int64
        lib.coo_to_csc_d.argtypes = [ctypes.c_int64] * 3 + [
            _i64p, _i64p, ctypes.c_void_p, _i64p, _i64p, ctypes.c_void_p]
        lib.refactor_build.restype = ctypes.POINTER(_RefactorBuild)
        lib.refactor_build.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
        ]
        lib.refactor_free.restype = None
        lib.refactor_free.argtypes = [ctypes.POINTER(_RefactorBuild)]
        self._declare_csc_ops(lib)
        self.lib = lib
        self.have_blas = self._load_blas()

    @staticmethod
    def _declare_csc_ops(lib):
        """The CSC products and merges, once per index width (suffix ''
        for int64, '32' for int32) and value type (d, s, z)."""
        i64, vp, dbl = ctypes.c_int64, ctypes.c_void_p, ctypes.c_double

        def reg(name, argtypes, restype=None):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes

        for ip, sfx in ((_i64p, ""), (_i32p, "32")):
            reg("csc_spgemm_size" + sfx, [i64, ip, ip, i64, ip, ip, ip], i64)
            reg("csc_gram_size" + sfx, [i64, i64, ip, ip, ip], i64)
            for v in "dsz":
                reg(f"csc_spgemm_numeric_{v}{sfx}",
                    [i64, ip, ip, vp, i64, ip, ip, vp, ip, ip, vp,
                     ctypes.c_int])
                reg(f"csc_transpose_{v}{sfx}",
                    [i64, i64, ip, ip, vp, ip, ip, vp])
                reg(f"csc_gram_numeric_{v}{sfx}",
                    [i64, i64, ip, ip, vp, ip, ip, vp], ctypes.c_int)
                reg(f"csc_gram_revalue_{v}{sfx}",
                    [i64, ip, ip, vp, _i64p, _i64p, _i64p, _i64p, ip, ip,
                     vp])
                scal = [dbl, dbl] if v == "z" else [dbl]
                reg(f"csc_axpby_{v}{sfx}",
                    [i64, ip, ip, vp, *scal, ip, ip, vp, *scal, ip, ip, vp],
                    i64)
        lib.csc_gram_symbolic_take.restype = i64
        lib.csc_gram_symbolic_take.argtypes = [_i64p] * 4

    def _load_blas(self) -> bool:
        """Point the dense-tail LU at scipy's bundled OpenBLAS (getrf)."""
        import scipy

        root = os.path.dirname(os.path.dirname(scipy.__file__))
        for pat in ("scipy.libs/libscipy_openblas*.so*",
                    "numpy.libs/libscipy_openblas*.so*"):
            for cand in sorted(glob.glob(os.path.join(root, pat))):
                if self.lib.lu_load_blas(cand.encode()):
                    return True
        return False


def _native_target() -> str:
    """The CPU ``-march=native`` names on this machine, per g++."""
    try:
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise BuildError(f"g++ not runnable: {e}") from e
    return "".join(ln.split()[-1] for ln in out.stdout.splitlines()
                   if ln.split()[:1] == ["-march="])


@functools.cache
def load() -> _Lib:
    """Build (first use) and load the host library; raises BuildError."""
    path = build_shared_library(
        "host_ext", _SOURCES,
        lambda out: ["g++", *_CXXFLAGS, "-shared", "-o", out,
                     *_SOURCES[:2]],
        key=_native_target())
    return _Lib(path)


def _as_i64(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.int64)


def _ptr(a):
    return a.ctypes.data_as(_i64p)


def _values(Ax):
    """(contiguous values, kernel suffix, numpy dtype) for an LU call."""
    Ax = np.ascontiguousarray(np.asarray(Ax))
    if np.issubdtype(Ax.dtype, np.complexfloating):
        return Ax.astype(np.complex128, copy=False), "z", np.complex128
    return Ax.astype(np.float64, copy=False), "d", np.float64


def _icopy(ptr, cnt):
    if cnt == 0:
        return np.zeros(0, dtype=np.int64)
    return np.ctypeslib.as_array(ptr, shape=(cnt,)).copy()


def _vcopy(ptr, cnt, vdt):
    if cnt == 0:
        return np.zeros(0, dtype=vdt)
    p = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_double))
    k = cnt * (2 if vdt == np.complex128 else 1)
    return np.ctypeslib.as_array(p, shape=(k,)).copy().view(vdt)


def _unpack_lu(lib, res, n, qa, vdt) -> HostLU:
    r = res.contents
    try:
        return HostLU(
            n=n,
            Lp=_icopy(r.Lp, n + 1),
            Li=_icopy(r.Li, r.lnz),
            Lx=_vcopy(r.Lx, r.lnz, vdt),
            Up=_icopy(r.Up, n + 1),
            Ui=_icopy(r.Ui, r.unz),
            Ux=_vcopy(r.Ux, r.unz, vdt),
            perm_r=_icopy(r.perm_r, n),
            perm_c=qa.copy(),
            singular_cols=_icopy(r.sing, r.nsing),
        )
    finally:
        lib.lu_free(res)


def lu_factor(n, Ap, Ai, Ax, q=None, tol: float = 1.0,
              dense_cap: int = 8192) -> HostLU:
    """Native twin of linalg.lu_host.lu_factor_host (P A Q = L U).

    dense_cap > 0 finishes the dense trailing Schur complement with LAPACK
    getrf.  Its strict partial pivoting would break the no-row-exchange
    contract of tol == 0, so it is off there (and without BLAS)."""
    L = load()
    Ap, Ai = _as_i64(Ap), _as_i64(Ai)
    Ax, sfx, vdt = _values(Ax)
    qa = _as_i64(q if q is not None else np.arange(n))
    if tol == 0.0 or not L.have_blas:
        dense_cap = 0
    res = getattr(L.lib, "lu_factor_" + sfx)(
        n, _ptr(Ap), _ptr(Ai), Ax.ctypes.data_as(ctypes.c_void_p), _ptr(qa),
        float(tol), int(dense_cap))
    return _unpack_lu(L.lib, res, n, qa, vdt)


def lu_factor_sn(n, Ap, Ai, Ax, q=None):
    """Supernodal multifrontal LU (native/lu_sn.cpp) with within-front
    partial pivoting; None when the kernel declines (no BLAS-3, an
    exactly singular fully-summed block, inconsistent structure)."""
    L = load()
    if not L.have_blas:
        return None
    Ap, Ai = _as_i64(Ap), _as_i64(Ai)
    Ax, sfx, vdt = _values(Ax)
    qa = _as_i64(q if q is not None else np.arange(n))
    res = getattr(L.lib, "lu_factor_sn_" + sfx)(
        n, _ptr(Ap), _ptr(Ai), Ax.ctypes.data_as(ctypes.c_void_p), _ptr(qa))
    if not res:
        return None
    return _unpack_lu(L.lib, res, n, qa, vdt)


def ldlt_factor(n, Ap, Ai, Ax):
    """A = L D L^T of a symmetric CSC (values: both triangles stored), no
    pivoting.  Returns (Lp, Li, Lx, D, singular columns) with L unit lower
    (unit diagonal stored first in each column)."""
    L = load()
    Ap, Ai = _as_i64(Ap), _as_i64(Ai)
    Ax, sfx, vdt = _values(Ax)
    res = getattr(L.lib, "ldlt_factor_" + sfx)(
        n, _ptr(Ap), _ptr(Ai), Ax.ctypes.data_as(ctypes.c_void_p))
    r = res.contents
    try:
        return (_icopy(r.Lp, n + 1), _icopy(r.Li, r.lnz),
                _vcopy(r.Lx, r.lnz, vdt), _vcopy(r.D, n, vdt),
                _icopy(r.sing, r.nsing))
    finally:
        L.lib.ldlt_free(res)


def max_transversal(n, Ap, Ai):
    """Maximum bipartite matching of columns to rows (MC21 class): (match,
    size), match[c] the row of column c or -1; size == n iff the matrix is
    structurally nonsingular."""
    Ap, Ai = _as_i64(Ap), _as_i64(Ai)
    out = np.empty(n, dtype=np.int64)
    size = load().lib.max_transversal(n, _ptr(Ap), _ptr(Ai), _ptr(out))
    return out, int(size)


def btf(n, Ap, Ai):
    """Block triangular form: (p, q, blocks) with A[p][:, q] block upper
    triangular, block b spanning rows and columns [blocks[b],
    blocks[b + 1])."""
    Ap, Ai = _as_i64(Ap), _as_i64(Ai)
    p = np.empty(n, dtype=np.int64)
    q = np.empty(n, dtype=np.int64)
    bp = np.zeros(n + 1, dtype=np.int64)
    nb = np.zeros(1, dtype=np.int64)
    load().lib.btf_order(n, _ptr(Ap), _ptr(Ai), _ptr(p), _ptr(q), _ptr(bp),
                         _ptr(nb))
    return p, q, bp[: int(nb[0]) + 1]


def _order(name, n, Ap, Ai, *extra):
    Ap, Ai = _as_i64(Ap), _as_i64(Ai)
    out = np.empty(n, dtype=np.int64)
    getattr(load().lib, name)(n, _ptr(Ap), _ptr(Ai), *extra, _ptr(out))
    return out


def amd(n, Ap, Ai) -> np.ndarray:
    """Approximate-minimum-degree order of pattern(A + A^T)."""
    return _order("amd_order", n, Ap, Ai)


def rcm(n, Ap, Ai) -> np.ndarray:
    """Reverse Cuthill-McKee order."""
    return _order("rcm_order", n, Ap, Ai)


def nd(n, Ap, Ai, leaf_size: int = 5000) -> np.ndarray:
    """Nested-dissection order (BFS level-set separators, AMD leaves)."""
    return _order("nd_order", n, Ap, Ai, int(leaf_size))


def refactor_build(n, Lp, Li, Up, Ui, Ap, Ai, perm_r, q):
    """Symbolic build of linalg.refactor.RefactorPlan: level-sorted update
    triples and division pairs, and the A -> X scatter map."""
    L = load()
    Lp, Li, Up, Ui, Ap, Ai, perm_r, q = map(
        _as_i64, (Lp, Li, Up, Ui, Ap, Ai, perm_r, q))
    a_nnz = len(Ai)
    res = L.lib.refactor_build(
        n, _ptr(Lp), _ptr(Li), _ptr(Up), _ptr(Ui),
        a_nnz, _ptr(Ap), _ptr(Ai), _ptr(perm_r), _ptr(q))
    r = res.contents
    try:
        return dict(
            nlev=int(r.nlev),
            upd_dst=_icopy(r.upd_dst, r.total),
            upd_L=_icopy(r.upd_L, r.total),
            upd_U=_icopy(r.upd_U, r.total),
            upd_lev=_icopy(r.upd_lev, r.total),
            div_dst=_icopy(r.div_dst, r.ndiv),
            div_piv=_icopy(r.div_piv, r.ndiv),
            div_lev=_icopy(r.div_lev, r.ndiv),
            a_dst=_icopy(r.a_dst, a_nnz),
        )
    finally:
        L.lib.refactor_free(res)


# -- CSC products and merges (the sparse-product path) -------------------------

_ENV64 = (np.dtype(np.int64), "", lambda a: _ptr(_as_i64(a)))


def _index_env(*arrays):
    """(numpy index dtype, function-name suffix, pointer caster) of a call:
    int32 when every index array already is, else int64."""
    if all(np.asarray(a).dtype == np.int32 for a in arrays):
        return (np.dtype(np.int32), "32",
                lambda a: np.ascontiguousarray(a).ctypes.data_as(_i32p))
    return _ENV64


def _host_vdt(cx, *vals):
    """Value dtype of a native call: complex128 when any operand is
    complex, float32 when every operand already is, float64 otherwise."""
    if cx:
        return np.complex128
    if all(np.asarray(v).dtype == np.float32 for v in vals):
        return np.float32
    return np.float64


def _vsfx(vdt):
    return {np.complex128: "z", np.float32: "s", np.float64: "d"}[vdt]


def _vptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _cast(vdt, *vals):
    return [np.ascontiguousarray(np.asarray(v), dtype=vdt) for v in vals]


def _spgemm_raw(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, vdt, env):
    """Both Gustavson passes, canonical emit; the index arrays are
    contiguous in the env's index dtype."""
    lib = load().lib
    idt, sfx, ptr = env
    Cp = np.empty(nB + 1, dtype=idt)  # pass 1 writes every entry
    nnz = getattr(lib, "csc_spgemm_size" + sfx)(
        m, ptr(Ap), ptr(Ai), nB, ptr(Bp), ptr(Bi), ptr(Cp))
    if nnz < 0:  # int32 overflow in the symbolic pass: redo in int64
        return _spgemm_raw(m, _as_i64(Ap), _as_i64(Ai), Ax, nB, _as_i64(Bp),
                           _as_i64(Bi), Bx, vdt, _ENV64)
    Ci = np.empty(max(nnz, 1), dtype=idt)
    Cx = np.empty(max(nnz, 1), dtype=vdt)
    getattr(lib, f"csc_spgemm_numeric_{_vsfx(vdt)}{sfx}")(
        m, ptr(Ap), ptr(Ai), _vptr(Ax), nB, ptr(Bp), ptr(Bi), _vptr(Bx),
        ptr(Cp), ptr(Ci), _vptr(Cx), 1)
    return Cp, Ci[:nnz], Cx[:nnz]


def csc_spgemm(m, Ap, Ai, Ax, nB, Bp, Bi, Bx):
    """C = A @ B for CSC operands (A has m rows, B has nB columns); returns
    canonical (indptr, indices, data).  Direct Gustavson, both passes
    balanced across threads by operation count, columns sorted on emit."""
    env = _index_env(Ap, Ai, Bp, Bi)
    Ap, Ai, Bp, Bi = (np.ascontiguousarray(a, dtype=env[0])
                      for a in (Ap, Ai, Bp, Bi))
    vdt = _host_vdt(np.iscomplexobj(Ax) or np.iscomplexobj(Bx), Ax, Bx)
    Ax, Bx = _cast(vdt, Ax, Bx)
    return _spgemm_raw(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, vdt, env)


def csc_axpby(n, Ap, Ai, Ax, alpha, Bp, Bi, Bx, beta, res_dt=None):
    """C = alpha*A + beta*B for canonical CSC operands of n columns;
    returns canonical (indptr, indices, data).  ``res_dt`` is the caller's
    result dtype: float32 operands under a float64 result (numpy promotion
    with the scalars) are summed in float64, not rounded in float32."""
    env = _index_env(Ap, Ai, Bp, Bi)
    cap = len(Ai) + len(Bi)
    if env[1] == "32" and cap > np.iinfo(np.int32).max:
        env = _ENV64
    idt, sfx, ptr = env
    Ap, Ai, Bp, Bi = (np.ascontiguousarray(a, dtype=idt)
                      for a in (Ap, Ai, Bp, Bi))
    cx = any(np.iscomplexobj(v) for v in (Ax, Bx, alpha, beta))
    if res_dt is not None and not cx:
        vdt = np.float32 if np.dtype(res_dt) == np.float32 else np.float64
    else:
        vdt = _host_vdt(cx, Ax, Bx)
    Ax, Bx = _cast(vdt, Ax, Bx)
    cap = max(cap, 1)
    Cp = np.zeros(n + 1, dtype=idt)
    Ci = np.empty(cap, dtype=idt)
    Cx = np.empty(cap, dtype=vdt)
    if cx:
        al, be = complex(alpha), complex(beta)
        al, be = (al.real, al.imag), (be.real, be.imag)
    else:
        al, be = (float(alpha),), (float(beta),)
    nnz = getattr(load().lib, f"csc_axpby_{_vsfx(vdt)}{sfx}")(
        n, ptr(Ap), ptr(Ai), _vptr(Ax), *al, ptr(Bp), ptr(Bi), _vptr(Bx),
        *be, ptr(Cp), ptr(Ci), _vptr(Cx))
    return Cp, Ci[:nnz], Cx[:nnz]


def csc_gram_cached(m, k, Ap, Ai, Ax, take=True):
    """C = A @ A.T for A (m x k) CSC: one fused kernel, lower-half Gustavson
    and a sorted mirror (the output is symmetric, for complex values too:
    no conjugation).  Returns canonical (Cp, Ci, Cx, sym); ``sym`` is the
    symbolic state (pattern of A^T, output pattern, upper counts) that
    ``csc_gram_revalue`` takes for new values on the same pattern, or None
    when ``take`` is False."""
    lib = load().lib
    idt, sfx, ptr = _index_env(Ap, Ai)
    Ap = np.ascontiguousarray(Ap, dtype=idt)
    Ai = np.ascontiguousarray(Ai, dtype=idt)
    vdt = _host_vdt(np.iscomplexobj(Ax), Ax)
    Ax, = _cast(vdt, Ax)
    Cp = np.empty(m + 1, dtype=idt)
    nnz = getattr(lib, "csc_gram_size" + sfx)(m, k, ptr(Ap), ptr(Ai), ptr(Cp))
    if nnz < 0:
        raise OverflowError("gram output nnz exceeds the index dtype; use "
                            "int64 indices")
    sym = None
    if take:
        annz = int(Ap[k])
        Tp = np.empty(m + 1, dtype=np.int64)
        Ti, Tpos = (np.empty(max(annz, 1), dtype=np.int64) for _ in range(2))
        up_cnt = np.empty(max(m, 1), dtype=np.int64)
        got = lib.csc_gram_symbolic_take(_ptr(Tp), _ptr(Ti), _ptr(Tpos),
                                         _ptr(up_cnt))
        if got != annz:
            raise RuntimeError("gram symbolic context unavailable")
    Ci = np.empty(max(nnz, 1), dtype=idt)
    Cx = np.empty(max(nnz, 1), dtype=vdt)
    ok = getattr(lib, f"csc_gram_numeric_{_vsfx(vdt)}{sfx}")(
        m, k, ptr(Ap), ptr(Ai), _vptr(Ax), ptr(Cp), ptr(Ci), _vptr(Cx))
    if not ok:
        raise RuntimeError("gram numeric pass lost its symbolic context")
    if take:
        sym = {"Tp": Tp, "Ti": Ti, "Tpos": Tpos, "up_cnt": up_cnt, "Cp": Cp,
               "Ci": Ci, "nnz": int(nnz), "m": int(m), "k": int(k),
               "annz": annz, "env": (idt, sfx), "vdt": vdt}
    return Cp, Ci[:nnz], Cx[:nnz], sym


def csc_gram(m, k, Ap, Ai, Ax):
    """``csc_gram_cached`` without the symbolic state: (Cp, Ci, Cx)."""
    return csc_gram_cached(m, k, Ap, Ai, Ax, take=False)[:3]


def csc_gram_revalue(Ap, Ai, Ax, sym):
    """The numeric pass of gram alone over a cached symbolic state
    (``csc_gram_cached``): accumulate, gather, mirror; no pattern
    discovery and no sort.  Returns the new Cx; the pattern is in ``sym``."""
    idt, sfx = sym["env"]
    Ap = np.ascontiguousarray(Ap, dtype=idt)
    Ai = np.ascontiguousarray(Ai, dtype=idt)
    vdt = _host_vdt(np.iscomplexobj(Ax), Ax)
    if vdt != sym["vdt"]:
        raise ValueError("value dtype changed since the symbolic pass")
    if int(Ap[sym["k"]]) != sym["annz"]:
        raise ValueError("pattern changed since the symbolic pass")
    Ax, = _cast(vdt, Ax)
    Cx = np.empty(max(sym["nnz"], 1), dtype=vdt)
    ptr = _index_env(Ap, Ai)[2]
    getattr(load().lib, f"csc_gram_revalue_{_vsfx(vdt)}{sfx}")(
        sym["m"], ptr(Ap), ptr(Ai), _vptr(Ax), _ptr(sym["Tp"]),
        _ptr(sym["Ti"]), _ptr(sym["Tpos"]), _ptr(sym["up_cnt"]),
        ptr(sym["Cp"]), ptr(sym["Ci"]), _vptr(Cx))
    return Cx


def coo_to_csc(m, n, rows, cols, vals):
    """Triplets to CSC on the host (float64; duplicates summed), the JAX
    package's native assembly: (indptr, indices, data), int64 and float64,
    trimmed to the unique count."""
    rows, cols = _as_i64(rows), _as_i64(cols)
    vals = np.ascontiguousarray(np.asarray(vals), dtype=np.float64)
    nnz = len(rows)
    out_p = np.zeros(n + 1, dtype=np.int64)
    out_i = np.empty(max(nnz, 1), dtype=np.int64)
    out_x = np.empty(max(nnz, 1), dtype=np.float64)
    u = load().lib.coo_to_csc_d(m, n, nnz, _ptr(rows), _ptr(cols),
                                _vptr(vals), _ptr(out_p), _ptr(out_i),
                                _vptr(out_x))
    return out_p, out_i[:u], out_x[:u]


def csc_transpose(m, n, Ap, Ai, Ax):
    """A^T of an (m x n) CSC by count and scatter, O(nnz); returns the
    canonical CSC arrays of the (n x m) transpose."""
    idt, sfx, ptr = _index_env(Ap, Ai)
    Ap = np.ascontiguousarray(Ap, dtype=idt)
    Ai = np.ascontiguousarray(Ai, dtype=idt)
    vdt = _host_vdt(np.iscomplexobj(Ax), Ax)
    Ax, = _cast(vdt, Ax)
    nz = len(Ai)
    Tp = np.zeros(m + 1, dtype=idt)
    Ti = np.empty(max(nz, 1), dtype=idt)
    Tx = np.empty(max(nz, 1), dtype=vdt)
    getattr(load().lib, f"csc_transpose_{_vsfx(vdt)}{sfx}")(
        m, n, ptr(Ap), ptr(Ai), _vptr(Ax), ptr(Tp), ptr(Ti), _vptr(Tx))
    return Tp, Ti[:nz], Tx[:nz]
