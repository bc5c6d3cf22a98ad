"""Fill-reducing orderings of a square CSC, through the native host
kernels (``native/host_ext.cpp``, the same C++ as the JAX package's).

* ``amd``      approximate minimum degree of pattern(A + A^T);
* ``nd``       nested dissection (BFS level-set separators, AMD leaves),
               the fill-controlling choice for large near-planar grids;
* ``rcm``      reverse Cuthill-McKee (bandwidth reduction);
* ``natural``  the identity.

The JAX package falls back to Python orderings when its library is not
built; here the library is built at first use and a failed build raises
(``native/host_ext.py``), so there is no fallback.
"""

from __future__ import annotations

import numpy as np

from ..native import host_ext
from ..types import CSC

__all__ = ["rcm", "amd", "nd", "natural", "get_ordering"]


def _square(a: CSC):
    if a.m != a.n:
        raise ValueError("ordering expects a square matrix")
    ip, ix, _ = a.np_arrays()
    return ip, ix


def natural(a: CSC) -> np.ndarray:
    return np.arange(a.n, dtype=np.int64)


def rcm(a: CSC) -> np.ndarray:
    return host_ext.rcm(a.n, *_square(a))


def amd(a: CSC) -> np.ndarray:
    return host_ext.amd(a.n, *_square(a))


def nd(a: CSC, leaf_size: int = 5000) -> np.ndarray:
    return host_ext.nd(a.n, *_square(a), leaf_size)


_ORDERINGS = {"rcm": rcm, "amd": amd, "nd": nd, "natural": natural}


def get_ordering(name, a: CSC) -> np.ndarray:
    """Column order for ``a``: a name above, None (natural), an explicit
    permutation, or a callable taking the CSC."""
    if callable(name):
        return np.asarray(name(a), dtype=np.int64)
    if name is None:
        return natural(a)
    if isinstance(name, (list, np.ndarray)):
        return np.asarray(name, dtype=np.int64)
    try:
        return _ORDERINGS[name](a)
    except KeyError:
        raise ValueError(f"unknown ordering {name!r}; have {list(_ORDERINGS)}")
