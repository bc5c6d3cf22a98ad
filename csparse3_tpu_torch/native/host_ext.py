"""ctypes binding of the native host kernels in ``native/`` (repo root).

The same C++ as the JAX package's binding (``native/host_ext.cpp`` and
``native/lu_sn.cpp``), compiled at first use with ``g++`` and the flags of
``native/Makefile`` into the port's build directory (utils/build.py).  The
library is built on the machine that loads it, so ``-march=native`` names
that machine's CPU.  A failed build raises: at 10k buses the pure-numpy LU
would turn a broken build into a run hours long, so nothing falls back.

Only the entry points the port's slice calls are bound: sparse LU
(scalar Gilbert-Peierls and supernodal), the AMD / RCM / nested-dissection
orderings, and the symbolic build of the device refactorization.
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

__all__ = ["load", "lu_factor", "lu_factor_sn", "amd", "rcm", "nd",
           "refactor_build"]

_SOURCES = [os.path.join(REPO_ROOT, "native", f)
            for f in ("host_ext.cpp", "lu_sn.cpp", "host_common.h")]
# native/Makefile CXXFLAGS; -ffp-contract=off keeps exact cancellations
# exact, so singular columns are detected as in the numpy reference
_CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-fPIC", "-pthread", "-Wall", "-Wextra"]

_i64p = ctypes.POINTER(ctypes.c_int64)


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
        lib.lu_load_blas.restype = ctypes.c_int
        lib.lu_load_blas.argtypes = [ctypes.c_char_p]
        for name in ("amd_order", "rcm_order"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
        lib.nd_order.restype = None
        lib.nd_order.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                 ctypes.c_int64, _i64p]
        lib.refactor_build.restype = ctypes.POINTER(_RefactorBuild)
        lib.refactor_build.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
        ]
        lib.refactor_free.restype = None
        lib.refactor_free.argtypes = [ctypes.POINTER(_RefactorBuild)]
        self.lib = lib
        self.have_blas = self._load_blas()

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
