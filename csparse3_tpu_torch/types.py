"""Core sparse containers over torch tensors.

Same layout and conventions as the JAX package's containers
(``csparse3_tpu/types.py``): CSC is the interchange format (fields m, n,
indptr, indices, data; scipy-compatible), CSR the row-major twin, COO the
triplet form.  ``nnz`` is plain metadata.

Host and device: a container built from numpy keeps those arrays as a host
cache, so ``np_arrays()`` (the entry to every host-symbolic step: ordering,
factorization, plan packing) never copies from the device.  The torch
tensors are made on first access of ``indptr`` / ``indices`` / ``data``
(or ``rows`` / ``cols`` / ``data``), on the container's ``device``, which
is explicit: the ``device=`` argument, else that of the tensors given,
else the CPU.  ``to(device)`` returns a container placed elsewhere.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["CSC", "CSR", "COO"]


def _host_cache(*arrays):
    """Host copies when every array given is numpy, else None."""
    if all(isinstance(a, np.ndarray) for a in arrays):
        return tuple(arrays)
    return None


class _SparseBase:
    """Three arrays (two index, one value) plus shape and nnz."""

    _names: Tuple[str, str, str] = ()

    def _setup(self, m, n, arrays, nnz, device):
        self.m = int(m)
        self.n = int(n)
        self._np = _host_cache(*arrays)
        self._arrays = list(arrays)
        self.nnz = int(nnz) if nnz is not None else int(np.shape(arrays[1])[0])
        if device is None:
            device = next((a.device for a in arrays
                           if isinstance(a, torch.Tensor)), "cpu")
        self.device = torch.device(device)

    def _field(self, i):
        v = self._arrays[i]
        if not (isinstance(v, torch.Tensor) and v.device == self.device):
            if isinstance(v, np.ndarray):
                v = np.ascontiguousarray(v)
            v = torch.as_tensor(v, device=self.device)
            self._arrays[i] = v
        return v

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self._field(2).dtype

    def np_arrays(self):
        """Host numpy copies of the three arrays, trimmed to nnz (the
        pointer array of CSC/CSR is returned whole)."""
        k = self.nnz
        if self._np is not None:
            a0, a1, a2 = self._np
        else:
            a0, a1, a2 = (self._field(i).cpu().numpy() for i in range(3))
        return (a0 if self._names[0] == "indptr" else a0[:k]), a1[:k], a2[:k]

    def __repr__(self):
        return (f"{type(self).__name__}(m={self.m}, n={self.n}, "
                f"nnz={self.nnz}, dtype={self.dtype}, device={self.device})")


class CSC(_SparseBase):
    """Compressed sparse column matrix: for column j, entries live at
    positions indptr[j]..indptr[j+1] of (indices = row ids, data).
    ``canonical`` means rows sorted within each column, no duplicates."""

    _names = ("indptr", "indices", "data")

    def __init__(self, m, n, indptr, indices, data, nnz=None,
                 canonical=True, device=None):
        self._setup(m, n, (indptr, indices, data), nnz, device)
        self.canonical = bool(canonical)

    indptr = property(lambda self: self._field(0))
    indices = property(lambda self: self._field(1))
    data = property(lambda self: self._field(2))

    def to(self, device) -> "CSC":
        arrays = self._np if self._np is not None else self._arrays
        return CSC(self.m, self.n, *arrays, nnz=self.nnz,
                   canonical=self.canonical, device=device)

    def todense(self):
        from .ops import construct

        return construct.csc_to_dense(self)

    def to_csr(self) -> "CSR":
        from .ops import construct

        return construct.csc_to_csr(self)

    def to_coo(self) -> "COO":
        from .ops import construct

        return construct.csc_to_coo(self)

    def t(self) -> "CSC":
        from .ops import construct

        return construct.transpose(self)

    @property
    def T(self) -> "CSC":
        return self.t()

    def to_scipy(self):
        import scipy.sparse as sp

        ip, ix, dt = self.np_arrays()
        return sp.csc_matrix((dt, ix, ip), shape=self.shape)

    @classmethod
    def from_scipy(cls, a, device=None) -> "CSC":
        a = a.tocsc()
        return cls(a.shape[0], a.shape[1], a.indptr, a.indices, a.data,
                   device=device)


class CSR(_SparseBase):
    """Compressed sparse row matrix (row-major twin of CSC)."""

    _names = ("indptr", "indices", "data")

    def __init__(self, m, n, indptr, indices, data, nnz=None,
                 canonical=True, device=None):
        self._setup(m, n, (indptr, indices, data), nnz, device)
        self.canonical = bool(canonical)

    indptr = property(lambda self: self._field(0))
    indices = property(lambda self: self._field(1))
    data = property(lambda self: self._field(2))

    def to(self, device) -> "CSR":
        arrays = self._np if self._np is not None else self._arrays
        return CSR(self.m, self.n, *arrays, nnz=self.nnz,
                   canonical=self.canonical, device=device)

    def to_csc(self) -> CSC:
        from .ops import construct

        return construct.csr_to_csc(self)

    def todense(self):
        return self.to_csc().todense()

    def t(self) -> CSC:
        """Transpose without copying: the CSR arrays of A are the CSC
        arrays of A^T."""
        ip, ix, dt = self.np_arrays()
        return CSC(self.n, self.m, ip, ix, dt, canonical=self.canonical,
                   device=self.device)

    @property
    def T(self) -> CSC:
        return self.t()

    def to_scipy(self):
        import scipy.sparse as sp

        ip, ix, dt = self.np_arrays()
        return sp.csr_matrix((dt, ix, ip), shape=self.shape)

    @classmethod
    def from_scipy(cls, a, device=None) -> "CSR":
        a = a.tocsr()
        return cls(a.shape[0], a.shape[1], a.indptr, a.indices, a.data,
                   device=device)


class COO(_SparseBase):
    """Triplet (coordinate) matrix, the construction format."""

    _names = ("rows", "cols", "data")

    def __init__(self, m, n, rows, cols, data, nnz=None, device=None):
        self._setup(m, n, (rows, cols, data), nnz, device)

    rows = property(lambda self: self._field(0))
    cols = property(lambda self: self._field(1))
    data = property(lambda self: self._field(2))

    def to(self, device) -> "COO":
        arrays = self._np if self._np is not None else self._arrays
        return COO(self.m, self.n, *arrays, nnz=self.nnz, device=device)

    def to_csc(self, sum_duplicates: bool = True) -> CSC:
        from .ops import construct

        return construct.coo_to_csc(self, sum_duplicates=sum_duplicates)

    def to_csr(self, sum_duplicates: bool = True) -> CSR:
        return self.to_csc(sum_duplicates=sum_duplicates).to_csr()

    def to_dense(self):
        from .ops import construct

        return construct.coo_to_dense(self)

    def to_scipy(self):
        import scipy.sparse as sp

        r, c, d = self.np_arrays()
        return sp.coo_matrix((d, (r, c)), shape=self.shape)

    @classmethod
    def from_scipy(cls, a, device=None) -> "COO":
        a = a.tocoo()
        return cls(a.shape[0], a.shape[1], a.row, a.col, a.data,
                   device=device)
