"""Fill-reducing orderings of a square CSC, through the native host
kernels (``native/host_ext.cpp``, the same C++ as the JAX package's).

* ``amd``      approximate minimum degree of pattern(A + A^T);
* ``nd``       nested dissection (BFS level-set separators, AMD leaves),
               the fill-controlling choice for large near-planar grids;
* ``rcm``      reverse Cuthill-McKee (bandwidth reduction);
* ``mindeg``   greedy exact minimum degree (numpy and a heap, the JAX
               package's own Python ordering; fine up to ~10^5 nodes);
* ``natural``  the identity.

The JAX package falls back to Python orderings when its library is not
built; here the library is built at first use and a failed build raises
(``native/host_ext.py``), so there is no fallback.  ``mindeg`` is an
ordering of its own, not a fallback.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..native import host_ext
from ..types import CSC

__all__ = ["rcm", "mindeg", "amd", "nd", "natural", "get_ordering",
           "symmetrize_pattern"]


def _square(a: CSC):
    if a.m != a.n:
        raise ValueError("ordering expects a square matrix")
    ip, ix, _ = a.np_arrays()
    return ip, ix


def natural(a: CSC) -> np.ndarray:
    return np.arange(a.n, dtype=np.int64)


def symmetrize_pattern(a: CSC):
    """Adjacency (indptr, indices) of pattern(A + A^T), no self loops."""
    ip, ix, _ = a.np_arrays()
    n = a.n
    cols = np.repeat(np.arange(n), np.diff(ip))
    src = np.concatenate([ix, cols])
    dst = np.concatenate([cols, ix])
    keep = src != dst
    key = np.unique(src[keep].astype(np.int64) * n + dst[keep])
    src = key // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    return np.cumsum(indptr), key % n


def mindeg(a: CSC) -> np.ndarray:
    """Greedy minimum degree: repeatedly eliminate the node of least
    degree, joining its neighbours into a clique (elimination graph with
    set adjacency; heap ties break on the node id)."""
    _square(a)
    n = a.n
    indptr, adj = symmetrize_pattern(a)
    nbrs = [set(adj[indptr[i]: indptr[i + 1]].tolist()) for i in range(n)]
    heap = [(len(nbrs[i]), i) for i in range(n)]
    heapq.heapify(heap)
    eliminated = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    k = 0
    while heap:
        d, u = heapq.heappop(heap)
        if eliminated[u] or d != len(nbrs[u]):
            continue  # stale heap entry
        order[k] = u
        k += 1
        eliminated[u] = True
        live = [v for v in nbrs[u] if not eliminated[v]]
        for v in live:
            s = nbrs[v]
            s.discard(u)
            s.update(w for w in live if w != v)
            heapq.heappush(heap, (len(s), v))
        nbrs[u] = set()
    return order


def rcm(a: CSC) -> np.ndarray:
    return host_ext.rcm(a.n, *_square(a))


def amd(a: CSC) -> np.ndarray:
    return host_ext.amd(a.n, *_square(a))


def nd(a: CSC, leaf_size: int = 5000) -> np.ndarray:
    return host_ext.nd(a.n, *_square(a), leaf_size)


_ORDERINGS = {"rcm": rcm, "mindeg": mindeg, "amd": amd, "nd": nd,
              "natural": natural}


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
