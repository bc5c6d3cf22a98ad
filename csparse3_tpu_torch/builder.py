"""Mutable builders: the construction layer, as the JAX package's
``csparse3_tpu/builder.py``.

``TripletBuilder`` (aliases ``LilMat`` and ``CooMat``) keeps two stores: a
list of bulk triplet chunks that accumulate (``add_triplets``, ``add``: the
fast path of Ybus and connectivity assembly, numpy chunks, no per-element
Python) and a dict of overrides with last-write-wins semantics
(``__setitem__`` over the nine scalar / vector / slice / window cases,
``insert_or_replace``).  ``to_csc`` is one host build (``from_triplets``)
placed on the builder's device.

Deviation from the JAX package, by design: ``triplets`` subtracts the
accumulated values at overridden coordinates with one vectorized pass over
the chunks (packed (i, j) keys, ``np.isin``, ``np.unique`` and an ordered
``np.add.at``) where the JAX package walks every chunk entry in Python.
The triplet list is the same one, in the same order, so the CSC is too.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .ops import construct
from .types import CSC
from .utils.misc import slice_to_range

__all__ = ["TripletBuilder", "LilMat", "CooMat"]


class TripletBuilder:
    """Accumulating triplet chunks plus last-write-wins overrides of an
    (m, n) matrix of ``dtype``; ``to_csc`` / ``to_coo`` place the result
    on ``device`` (None: ``config.default_device()``, resolved when a tensor
    of the result is first read)."""

    def __init__(self, m: int, n: int, dtype=np.float64, device=None):
        self.m = int(m)
        self.n = int(n)
        self.dtype = np.dtype(dtype)
        self.device = device
        self._chunks_r = []  # accumulated (summed) triplets
        self._chunks_c = []
        self._chunks_v = []
        self._set: Dict[Tuple[int, int], complex] = {}  # last write wins

    @property
    def shape(self):
        return (self.m, self.n)

    # ---- bulk accumulate path ---------------------------------------------
    def add_triplets(self, rows, cols, vals):
        """Accumulate A[rows, cols] += vals (vals broadcast to rows)."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        vals = np.broadcast_to(np.asarray(vals, dtype=self.dtype),
                               rows.shape).ravel()
        if rows.size != cols.size:
            raise ValueError("rows/cols length mismatch")
        if rows.size and (rows.min() < 0 or rows.max() >= self.m
                          or cols.min() < 0 or cols.max() >= self.n):
            raise IndexError("triplet index out of bounds")
        self._chunks_r.append(rows)
        self._chunks_c.append(cols)
        self._chunks_v.append(vals)
        return self

    def add(self, i: int, j: int, v):
        """Accumulate A[i, j] += v."""
        return self.add_triplets([i], [j], [v])

    # ---- setitem path ----------------------------------------------------
    def _axis_indices(self, key, dim):
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += dim
            if not 0 <= i < dim:
                raise IndexError(f"index {key} out of range [0,{dim})")
            return np.asarray([i])
        if isinstance(key, slice):
            return slice_to_range(key, dim)
        arr = np.asarray(key)
        if arr.dtype == bool:
            arr = np.flatnonzero(arr)
        return arr.astype(np.int64)

    def __setitem__(self, key, value):
        """A[i, j] = v for scalars, index lists, boolean masks and slices
        on either axis, the value broadcast over the (rows, cols) window;
        two index lists with a vector value of their length set the pairs
        (rows[k], cols[k]).  Overrides accumulated values."""
        if not isinstance(key, tuple) or len(key) != 2:
            raise IndexError("use A[i, j] style indexing")
        ri = self._axis_indices(key[0], self.m)
        ci = self._axis_indices(key[1], self.n)
        val = np.asarray(value, dtype=self.dtype)
        if val.ndim == 1 and len(ri) == len(ci) and (
            isinstance(key[0], (list, np.ndarray))
            and isinstance(key[1], (list, np.ndarray))
            and len(ri) == val.shape[0] and (len(ri) != 1 or len(ci) != 1)
        ):
            for r, c, v in zip(ri, ci, val):
                self._set[(int(r), int(c))] = v
            return
        grid = np.broadcast_to(val, (len(ri), len(ci)))
        for a, r in enumerate(ri):
            for b, c in enumerate(ci):
                self._set[(int(r), int(c))] = grid[a, b]

    def __getitem__(self, key):
        if not isinstance(key, tuple) or len(key) != 2:
            raise IndexError("use A[i, j] style indexing")
        if isinstance(key[0], (int, np.integer)) and isinstance(
                key[1], (int, np.integer)):
            return self.try_get(int(key[0]), int(key[1]))
        ri = self._axis_indices(key[0], self.m)
        ci = self._axis_indices(key[1], self.n)
        out = np.zeros((len(ri), len(ci)), dtype=self.dtype)
        acc = self._accumulated_dict()
        for a, r in enumerate(ri):
            for b, c in enumerate(ci):
                out[a, b] = acc.get((int(r), int(c)), 0)
        return out

    def try_get(self, i: int, j: int):
        """The effective value at (i, j), zero where nothing was stored."""
        return self._accumulated_dict().get((i, j), self.dtype.type(0))

    def insert_or_replace(self, i: int, j: int, v):
        self._set[(int(i), int(j))] = v
        return self

    def _accumulated_dict(self):
        acc: Dict[Tuple[int, int], complex] = {}
        for r, c, v in zip(self._chunks_r, self._chunks_c, self._chunks_v):
            for i, j, x in zip(r, c, v):
                acc[(int(i), int(j))] = acc.get((int(i), int(j)), 0) + x
        acc.update(self._set)
        return acc

    def get_nz(self) -> int:
        """Number of distinct stored coordinates."""
        return len(self._accumulated_dict())

    def __len__(self):
        return self.get_nz()

    # ---- in-place merge over the effective entries --------------------------
    def _merge(self, other: "TripletBuilder", sign: int):
        if other.shape != self.shape:
            raise ValueError("shape mismatch in builder merge")
        merged = self._accumulated_dict()
        for k, v in other._accumulated_dict().items():
            merged[k] = merged.get(k, 0) + sign * v
        self._chunks_r, self._chunks_c, self._chunks_v = [], [], []
        self._set = merged
        return self

    def __iadd__(self, other: "TripletBuilder"):
        return self._merge(other, 1)

    def __isub__(self, other: "TripletBuilder"):
        return self._merge(other, -1)

    # ---- finalize ----------------------------------------------------------
    def _overridden_sums(self, set_r, set_c):
        """(rows, cols, sums) of the accumulated chunk values at overridden
        coordinates, each sum taken in chunk order."""
        key_set = set_r * self.n + set_c
        keys = [r * self.n + c for r, c in zip(self._chunks_r,
                                               self._chunks_c)]
        hit = [np.isin(k, key_set) for k in keys]
        hk = np.concatenate([k[h] for k, h in zip(keys, hit)])
        hv = np.concatenate([v[h] for v, h in zip(self._chunks_v, hit)])
        uk, inv = np.unique(hk, return_inverse=True)
        acc = np.zeros(len(uk), dtype=self.dtype)
        np.add.at(acc, inv, hv)  # unbuffered: entry order, as a running sum
        return uk // self.n, uk % self.n, acc

    def triplets(self):
        """(rows, cols, vals) whose summed CSC is the builder's matrix: the
        chunks, the overrides, and the accumulated values at overridden
        coordinates negated."""
        set_r = np.asarray([k[0] for k in self._set], dtype=np.int64)
        set_c = np.asarray([k[1] for k in self._set], dtype=np.int64)
        set_v = np.asarray(list(self._set.values()), dtype=self.dtype)
        rs, cs, vs = (self._chunks_r + [set_r], self._chunks_c + [set_c],
                      self._chunks_v + [set_v])
        if self._set and self._chunks_r:
            r, c, acc = self._overridden_sums(set_r, set_c)
            if len(acc):
                rs.append(r)
                cs.append(c)
                vs.append(-acc)
        return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)

    def to_csc(self) -> CSC:
        r, c, v = self.triplets()
        return construct.from_triplets(r, c, v, self.shape,
                                       device=self.device)

    def to_coo(self):
        from .types import COO

        r, c, v = self.triplets()
        return COO(self.m, self.n, r, c, v, device=self.device)

    def to_dense(self):
        """Host numpy (m, n) array."""
        return self.to_csc().to_scipy().toarray()


# the reference library's names for the same builder
LilMat = TripletBuilder
CooMat = TripletBuilder
