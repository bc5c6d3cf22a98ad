"""Block triangular form (BTF) and block-wise LU, as the JAX package's
``csparse3_tpu/linalg/btf.py`` (host work throughout):

* ``max_transversal(a)``: maximum bipartite matching of columns to rows
  (MC21); a perfect matching exists iff A is structurally nonsingular.
* ``btf(a)``: permutations (p, q) and block boundaries such that
  ``A[p][:, q]`` is block upper triangular with a zero-free diagonal
  (maximum transversal and Tarjan's strong components, native C++; the
  scipy.csgraph version ``_btf_scipy`` when the library cannot be built,
  and as the tests' oracle).
* ``btf_splu(a)``: factor only the diagonal blocks, each with its own
  fill-reducing ordering, and solve by block back-substitution: strictly
  less work than one LU for a decomposable system, and no fill outside the
  blocks.  The solve is host numpy, as in the JAX package.

Multi-island grids and DC-link-coupled AC systems give reducible
matrices; KLU, the circuit solver, is BTF plus per-block AMD and
Gilbert-Peierls LU, the architecture of ``btf_splu``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..types import CSC
from ..utils.build import BuildError
from .lu import SparseLU, splu

__all__ = ["max_transversal", "btf", "BTFLU", "btf_splu"]


def max_transversal(a: CSC) -> Tuple[np.ndarray, int]:
    """(match, size): match[c] = row matched to column c (-1 unmatched);
    size == n iff structurally nonsingular."""
    if a.m != a.n:
        raise ValueError("max_transversal expects a square matrix")
    ip, ix, _ = a.np_arrays()
    try:
        from ..native import host_ext

        return host_ext.max_transversal(a.n, ip, ix)
    except BuildError:
        from scipy.sparse import csc_matrix
        from scipy.sparse.csgraph import maximum_bipartite_matching

        m = maximum_bipartite_matching(
            csc_matrix((np.ones(len(ix)), ix, ip), shape=a.shape), "row"
        )
        return m.astype(np.int64), int((m >= 0).sum())


def btf(a: CSC) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p, q, blocks): ``A[p][:, q]`` is block upper triangular; block b
    spans rows/cols [blocks[b], blocks[b+1])."""
    if a.m != a.n:
        raise ValueError("btf expects a square matrix")
    ip, ix, _ = a.np_arrays()
    try:
        from ..native import host_ext

        return host_ext.btf(a.n, ip, ix)
    except BuildError:
        return _btf_scipy(a)


def _btf_scipy(a: CSC):
    """scipy.csgraph version: matching, strong components and a topological
    block order (used when the native library cannot be built, and by the
    tests)."""
    from scipy.sparse import csc_matrix, csr_matrix
    from scipy.sparse.csgraph import connected_components, maximum_bipartite_matching

    n = a.n
    ip, ix, _ = a.np_arrays()
    pattern = csc_matrix((np.ones(len(ix)), ix, ip), shape=a.shape)
    match = maximum_bipartite_matching(pattern, "row").astype(np.int64)
    # complete a deficient matching arbitrarily
    unmatched_c = np.flatnonzero(match < 0)
    if len(unmatched_c):
        used = np.zeros(n, dtype=bool)
        used[match[match >= 0]] = True
        match[unmatched_c] = np.flatnonzero(~used)[: len(unmatched_c)]
    # column digraph: edge c -> rinv[r] for entries (r, c)
    rinv = np.empty(n, dtype=np.int64)
    rinv[match] = np.arange(n)
    cols = np.repeat(np.arange(n), np.diff(ip))
    heads = rinv[ix]
    g = csr_matrix((np.ones(len(cols)), (cols, heads)), shape=(n, n))
    nb, labels = connected_components(g, directed=True, connection="strong")
    # scipy labels the components arbitrarily: order the blocks by a
    # topological sort of the condensation DAG
    cond_edges = {}
    for c, h in zip(cols, heads):
        lc, lh = labels[c], labels[h]
        if lc != lh:
            cond_edges.setdefault(lc, set()).add(lh)
    # Kahn on condensation with edges lc -> lh meaning "lh before lc"
    indeg = np.zeros(nb, dtype=np.int64)
    for lc, hs in cond_edges.items():
        indeg[lc] += len(hs)
    order: List[int] = [b for b in range(nb) if indeg[b] == 0]
    rev = {}
    for lc, hs in cond_edges.items():
        for lh in hs:
            rev.setdefault(lh, []).append(lc)
    head = 0
    while head < len(order):
        b = order[head]
        head += 1
        for b2 in rev.get(b, ()):  # lh done -> release lc
            indeg[b2] -= 1
            if indeg[b2] == 0:
                order.append(b2)
    pos = np.empty(nb, dtype=np.int64)
    pos[np.asarray(order)] = np.arange(nb)
    key = pos[labels]
    q = np.argsort(key, kind="stable").astype(np.int64)
    p = match[q]
    blocks = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=nb))])
    return p, q, blocks


class BTFLU:
    """Block-wise LU of a BTF-permuted matrix.

    Factors only the diagonal blocks (each with ``ordering``); ``solve``
    runs block back-substitution (last block first for the block upper
    triangular form), applying off-diagonal coupling with host SpMV.
    """

    def __init__(self, a: CSC, ordering="amd", tol: float = 1.0):
        if a.m != a.n:
            raise ValueError("BTFLU expects a square matrix")
        self.n = a.n
        self.p, self.q, self.blocks = btf(a)
        ip, ix, dt = a.np_arrays()
        import scipy.sparse as sp

        B = sp.csc_matrix((dt, ix, ip), shape=a.shape)[self.p][:, self.q].tocsr()
        self.nblocks = len(self.blocks) - 1
        self._lus: List[SparseLU] = []
        self._coupling = []  # per block: CSR strip B[lo:hi, hi:]
        for b in range(self.nblocks):
            lo, hi = int(self.blocks[b]), int(self.blocks[b + 1])
            blk = B[lo:hi, lo:hi].tocsc()
            self._coupling.append(B[lo:hi, hi:].tocsr())
            self._lus.append(
                splu(CSC.from_scipy(blk), ordering=ordering, tol=tol)
            )

    @property
    def is_singular(self) -> bool:
        return any(lu.is_singular for lu in self._lus)

    @property
    def fill(self) -> int:
        return sum(lu.lnz + lu.unz for lu in self._lus)

    def solve(self, b):
        """x = A^{-1} b via block back-substitution (host)."""
        b = np.asarray(b)
        squeeze = b.ndim == 1
        bb = b[self.p]
        if squeeze:
            bb = bb[:, None]
        dt = np.result_type(bb.dtype, *(lu.U.np_arrays()[2].dtype
                                        for lu in self._lus[:1]))
        bb = bb.astype(dt, copy=False)
        x = np.zeros_like(bb)
        for blk in range(self.nblocks - 1, -1, -1):
            lo, hi = int(self.blocks[blk]), int(self.blocks[blk + 1])
            rhs = bb[lo:hi] - self._coupling[blk] @ x[hi:]
            x[lo:hi] = np.asarray(self._lus[blk].solve_host(rhs))
        out = np.zeros_like(x)
        out[self.q] = x
        return out[:, 0] if squeeze else out


def btf_splu(a: CSC, ordering="amd", tol: float = 1.0) -> BTFLU:
    """KLU-style factorization: BTF + per-diagonal-block LU."""
    return BTFLU(a, ordering=ordering, tol=tol)
