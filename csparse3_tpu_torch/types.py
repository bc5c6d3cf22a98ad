"""Core sparse containers over torch tensors.

Same layout and conventions as the JAX package's containers
(``csparse3_tpu/types.py``): CSC is the interchange format (fields m, n,
indptr, indices, data; scipy-compatible), CSR the row-major twin, COO the
triplet form.  ``nnz`` is plain metadata.

Host and device: a container built from numpy keeps those arrays as a host
cache, so ``np_arrays()`` (the entry to every host-symbolic step: ordering,
factorization, plan packing) never copies from the device.  The torch
tensors are made on first access of ``indptr`` / ``indices`` / ``data``
(or ``rows`` / ``cols`` / ``data``), on the container's ``device``: the
``device=`` argument, else that of the tensors given, else
``config.default_device()`` (the CUDA card; it raises without one, so a
host-only caller passes ``device="cpu"``).  That default is resolved at
the first access of ``device`` or of a tensor, not at construction: the
host-symbolic steps read ``np_arrays()`` and need no device at all.
``to(device)`` returns the container itself when it was placed there
already, else a container placed there (a CSC remembers the one it made for
each device, so a product that places its matrix uploads it once).  Nothing
in this package changes a container's values in place: results are new
containers, which is what lets structure derived from values (the placed
copies, a CSC's entry streams, a BSR's column lists) be kept.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .config import resolve_device

__all__ = ["CSC", "CSR", "COO", "BSR", "DIA", "Dense"]

#: plain (m, n) arrays in signatures: a tensor or anything ``torch.as_tensor``
#: takes
Dense = Any


def _placed_on(mine, device) -> bool:
    """Whether a container placed on ``mine`` (None: not placed yet) is on
    ``device``; an index that either side leaves open matches."""
    d = torch.device(device)
    return mine is not None and mine.type == d.type and (
        mine.index == d.index or None in (mine.index, d.index))


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
                           if isinstance(a, torch.Tensor)), None)
        # None: the default device, resolved at first use (``device``)
        self._device = None if device is None else torch.device(device)

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(None)
        return self._device

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
        v = self._arrays[2]
        if isinstance(v, torch.Tensor):
            return v.dtype
        return torch.from_numpy(np.empty(0, dtype=np.asarray(v).dtype)).dtype

    def np_arrays(self):
        """Host numpy copies of the three arrays, trimmed to nnz (the
        pointer array of CSC/CSR is returned whole)."""
        k = self.nnz
        if self._np is not None:
            a0, a1, a2 = self._np
        else:
            a0, a1, a2 = (self._field(i).detach().cpu().numpy()
                          for i in range(3))
        return (a0 if self._names[0] == "indptr" else a0[:k]), a1[:k], a2[:k]

    def __repr__(self):
        where = "default" if self._device is None else self._device
        return (f"{type(self).__name__}(m={self.m}, n={self.n}, "
                f"nnz={self.nnz}, dtype={self.dtype}, device={where})")


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
        """This container when it was placed on ``device`` already, else
        the copy placed there, made at the first such call and kept."""
        if _placed_on(self._device, device):
            return self
        placed = self.__dict__.setdefault("_placed", {})
        key = str(torch.device(device))
        if key not in placed:
            placed[key] = CSC(self.m, self.n, *self._given(), nnz=self.nnz,
                              canonical=self.canonical, device=device)
        return placed[key]

    def entry_streams(self):
        """(row ids, column ids) of the stored entries as int64 tensors on
        the container's device, the column ids expanded from ``indptr`` on
        the host: made once and kept."""
        if "_streams" not in self.__dict__:
            from .ops.construct import expand_indptr_np

            cols = torch.as_tensor(expand_indptr_np(self.np_arrays()[0]),
                                   dtype=torch.int64, device=self.device)
            self._streams = (self.indices[: self.nnz].long(), cols)
        return self._streams

    def __getitem__(self, key):
        from .ops import slicing

        return slicing.getitem(self, key)

    def __setitem__(self, key, value):
        raise TypeError(
            "CSC is immutable; build with TripletBuilder / LilMat instead "
            "(matches reference csc.py:288-292)")

    def _given(self):
        """The three arrays as given: the host copies where there are."""
        return self._np if self._np is not None else self._arrays

    def _revalued(self, data) -> "CSC":
        """This pattern with new values (numpy or a tensor), on this
        container's device."""
        ip, ix, _ = self._given()
        return CSC(self.m, self.n, ip, ix, data, nnz=self.nnz,
                   canonical=self.canonical, device=self._device)

    def copy(self) -> "CSC":
        """A copy with its own arrays, on this container's device."""
        ip, ix, dt = (a.copy() if isinstance(a, np.ndarray) else a.clone()
                      for a in self._given())
        return CSC(self.m, self.n, ip, ix, dt, nnz=self.nnz,
                   canonical=self.canonical, device=self._device)

    def astype(self, dtype) -> "CSC":
        """Values cast to ``dtype`` (numpy or torch), on this container's
        device."""
        dt = self._given()[2]
        if isinstance(dt, np.ndarray):
            if isinstance(dtype, torch.dtype):
                dtype = torch.empty((), dtype=dtype).numpy().dtype
            return self._revalued(dt.astype(dtype))
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        return self._revalued(dt.to(dtype))

    def conj(self) -> "CSC":
        dt = self._given()[2]
        return self._revalued(np.conj(dt) if isinstance(dt, np.ndarray)
                              else dt.conj().resolve_conj())

    @classmethod
    def from_dense(cls, arr, device=None) -> "CSC":
        from .ops import construct

        return construct.dense_to_csc(arr, device=device)

    def get_nnz(self) -> int:
        return self.nnz

    def islands(self):
        """Connected components of the pattern (``ops.graph.islands``)."""
        from .ops import graph

        return graph.islands(self)

    def norm(self, ord=1):
        from .ops import norms

        return norms.norm(self, ord=ord)

    def diagonal(self):
        from .ops import reductions

        return reductions.diagonal(self)

    def sum(self, axis=None):
        from .ops import reductions

        return reductions.sum(self, axis=axis)

    def todense(self):
        from .ops import construct

        return construct.csc_to_dense(self)

    def to_csr(self) -> "CSR":
        from .ops import construct

        return construct.csc_to_csr(self)

    def to_coo(self) -> "COO":
        from .ops import construct

        return construct.csc_to_coo(self)

    def to_bsr(self, block=None) -> "BSR":
        from .ops import construct

        return construct.csc_to_bsr(self, block=block)

    def t(self) -> "CSC":
        from .ops import construct

        return construct.transpose(self)

    @property
    def T(self) -> "CSC":
        return self.t()

    # -- operators, as the JAX package's CSC has them ----------------------
    def __add__(self, other):
        from .ops import arithmetic

        return arithmetic.add(self, other)

    def __sub__(self, other):
        from .ops import arithmetic

        return arithmetic.sub(self, other)

    def __neg__(self):
        from .ops import arithmetic

        return arithmetic.scale(self, -1)

    def __mul__(self, other):
        """CSC * CSC is SpGEMM, CSC * vector SpMV, CSC * dense SpMM, CSC *
        scalar a scaling.  A numpy operand is placed on the matrix's
        device."""
        from .ops import arithmetic, matvec, spgemm

        if isinstance(other, CSC):
            return spgemm.spgemm(self, other)
        if np.ndim(other) == 0:
            return arithmetic.scale(self, other)
        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(np.asarray(other), device=self.device)
        if other.ndim == 1:
            return matvec.spmv(self, other)
        return matvec.spmm(self, other)

    def __rmul__(self, other):
        from .ops import arithmetic

        if np.ndim(other) == 0:
            return arithmetic.scale(self, other)
        return NotImplemented

    def __matmul__(self, other):
        return self.__mul__(other)

    def dot(self, other):
        """General SpGEMM C = A @ B."""
        from .ops import spgemm

        return spgemm.spgemm(self, other)

    def __eq__(self, other):
        """The exact compare ``ops.arithmetic.equal``: shapes, patterns and
        values equal."""
        from .ops import arithmetic

        if not isinstance(other, CSC):
            return NotImplemented
        return arithmetic.equal(self, other)

    __hash__ = None  # equal by value, so not hashable

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
                   device=self._device)

    @property
    def T(self) -> CSC:
        return self.t()

    # operators delegate to the CSC ones, as the JAX package's CSR does:
    # CSR (op) CSR comes back as CSR, CSR (op) anything else as CSC (op) it
    # gives
    def __matmul__(self, other):
        if isinstance(other, CSR):
            return (self.to_csc() @ other.to_csc()).to_csr()
        return self.to_csc() @ other

    def __mul__(self, other):
        if isinstance(other, CSR):
            return (self.to_csc() * other.to_csc()).to_csr()
        return self.to_csc() * other

    def __rmul__(self, other):
        return self.to_csc().__rmul__(other)

    def __add__(self, other):
        other = other.to_csc() if isinstance(other, CSR) else other
        return (self.to_csc() + other).to_csr()

    def __sub__(self, other):
        other = other.to_csc() if isinstance(other, CSR) else other
        return (self.to_csc() - other).to_csr()

    def __neg__(self):
        ip, ix, dt = self.np_arrays()
        return CSR(self.m, self.n, ip, ix, -dt, canonical=self.canonical,
                   device=self._device)

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


class BSR:
    """Block sparse row matrix of dense (R, C) blocks: ``data`` is
    (nblocks, R, C), ``indptr`` (mb + 1) and ``indices`` (block columns)
    the block-CSR pattern, mb = ceil(m / R) block rows, nb = ceil(n / C)
    block columns; the logical matrix is zero-padded up to (mb*R, nb*C).
    The block pattern is host work (``np_arrays``), the block values are
    the device tensor ``data``.  ``column_lists`` is structure derived from
    the values (which columns of each block hold a nonzero), built once; it
    would go stale if ``data`` were changed in place, which nothing in this
    package does."""

    def __init__(self, m, n, R, C, indptr, indices, data, nnz_blocks=None,
                 device=None):
        self.m, self.n, self.R, self.C = int(m), int(n), int(R), int(C)
        self._arrays = [indptr, indices, data]
        # per-array host copies: an operation's result has a host pattern
        # and device values
        self._host = [a if isinstance(a, np.ndarray) else None
                      for a in self._arrays]
        self.nnz_blocks = (int(nnz_blocks) if nnz_blocks is not None
                           else int(np.shape(indices)[0]))
        if device is None:
            device = next((a.device for a in self._arrays
                           if isinstance(a, torch.Tensor)), None)
        self._device = None if device is None else torch.device(device)

    device = _SparseBase.device
    _field = _SparseBase._field
    dtype = _SparseBase.dtype
    indptr = property(lambda self: self._field(0))
    indices = property(lambda self: self._field(1))
    data = property(lambda self: self._field(2))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def mb(self) -> int:
        return -(-self.m // self.R)

    @property
    def nb(self) -> int:
        return -(-self.n // self.C)

    @property
    def nnz(self) -> int:
        """Stored count: every entry of every stored block."""
        return self.nnz_blocks * self.R * self.C

    def np_arrays(self):
        """Host (indptr, indices, data), the last two trimmed to
        ``nnz_blocks``; no device round trip for what was built on the
        host."""
        k = self.nnz_blocks
        ip, ix, dt = (h if h is not None
                      else self._field(i).detach().cpu().numpy()
                      for i, h in enumerate(self._host))
        return ip, ix[:k], dt[:k]

    def _raw(self):
        """The three arrays as given: host copies where there are any."""
        return [a if h is None else h
                for a, h in zip(self._arrays, self._host)]

    def to(self, device) -> "BSR":
        """This container when it was placed on ``device`` already (the
        block values are not uploaded again), else a copy placed there; the
        host column lists go with it."""
        if _placed_on(self._device, device):
            return self
        out = BSR(self.m, self.n, self.R, self.C, *self._raw(),
                  nnz_blocks=self.nnz_blocks, device=device)
        if "_cols_np" in self.__dict__:
            out._cols_np = self._cols_np
        return out

    def column_lists(self):
        """(col_ptr, col_idx): for each stored block the sorted columns that
        hold a nonzero in any of its rows (``kernels.bsr_spmm.column_lists``),
        as int32 tensors on the container's device.  Built on the host from
        ``np_arrays()`` at the first call and kept with the container."""
        if "_cols" not in self.__dict__:
            if "_cols_np" not in self.__dict__:
                from .kernels.bsr_spmm import column_lists

                self._cols_np = column_lists(self.np_arrays()[2])
            self._cols = tuple(torch.as_tensor(a, device=self.device)
                               for a in self._cols_np)
        return self._cols

    def __repr__(self):
        where = "default" if self._device is None else self._device
        return (f"BSR(m={self.m}, n={self.n}, block={self.R}x{self.C}, "
                f"nnz_blocks={self.nnz_blocks}, dtype={self.dtype}, "
                f"device={where})")

    def todense(self):
        from .ops import construct

        return construct.bsr_to_dense(self)

    def to_csc(self) -> CSC:
        """Expand the blocks to entries (host); zeros inside the blocks are
        dropped."""
        from .ops import construct

        ip, bcols, dat = self.np_arrays()
        brows = np.repeat(np.arange(self.mb, dtype=np.int64), np.diff(ip))
        R, C = self.R, self.C
        shape3 = (len(brows), R, C)
        rr = np.broadcast_to(
            brows[:, None, None] * R + np.arange(R)[None, :, None],
            shape3).ravel()
        cc = np.broadcast_to(
            bcols[:, None, None].astype(np.int64) * C
            + np.arange(C)[None, None, :], shape3).ravel()
        vv = dat.ravel()
        keep = (vv != 0) & (rr < self.m) & (cc < self.n)
        return construct.from_triplets(rr[keep], cc[keep], vv[keep],
                                       (self.m, self.n), device=self._device)

    def t(self) -> "BSR":
        from .ops import bsr_ops

        return bsr_ops.bsr_transpose(self)

    @property
    def T(self) -> "BSR":
        return self.t()

    # block operations on BSR operands of one block shape; mixed operands
    # go through CSC
    def _same_block(self, other) -> bool:
        return isinstance(other, BSR) and (self.R, self.C) == (other.R,
                                                              other.C)

    def __add__(self, other):
        from .ops import bsr_ops

        if self._same_block(other):
            return bsr_ops.bsr_add(self, other)
        other = other.to_csc() if isinstance(other, BSR) else other
        return (self.to_csc() + other).to_bsr(block=(self.R, self.C))

    def __sub__(self, other):
        from .ops import bsr_ops

        if self._same_block(other):
            return bsr_ops.bsr_add(self, other, beta=-1.0)
        other = other.to_csc() if isinstance(other, BSR) else other
        return (self.to_csc() - other).to_bsr(block=(self.R, self.C))

    def __neg__(self):
        ip, ix, _ = self._raw()
        return BSR(self.m, self.n, self.R, self.C, ip, ix, -self.data,
                   nnz_blocks=self.nnz_blocks, device=self._device)

    def multiply(self, other) -> "BSR":
        """Elementwise product over the union block pattern."""
        from .ops import bsr_ops

        return bsr_ops.bsr_binop(self, other, torch.multiply)

    def __matmul__(self, other):
        """BSR @ BSR is the block product (``bsr_ops.bsr_matmat``, through
        CSC when the inner block sizes differ); BSR @ dense is
        ``matvec.bsr_spmm``: the CUDA kernel for a tensor on the card."""
        if isinstance(other, BSR):
            if self.C == other.R:
                from .ops import bsr_ops

                return bsr_ops.bsr_matmat(self, other)
            return (self.to_csc() @ other.to_csc()).to_bsr(
                block=(self.R, other.C))
        from .ops import matvec

        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(np.asarray(other), device=self.device)
        return matvec.bsr_spmm(self, other)

    def to_scipy(self):
        import scipy.sparse as sp

        ip, ix, dt = self.np_arrays()
        a = sp.bsr_matrix((dt, ix, ip),
                          shape=(self.mb * self.R, self.nb * self.C))
        if self.m % self.R or self.n % self.C:
            a = a[: self.m, : self.n].tobsr(blocksize=(self.R, self.C))
        return a

    @classmethod
    def from_scipy(cls, a, device=None) -> "BSR":
        a = a.tobsr()
        R, C = a.blocksize
        return cls(a.shape[0], a.shape[1], R, C, a.indptr, a.indices, a.data,
                   device=device)


class DIA:
    """Diagonal-offset sparse matrix: ``offsets`` (k,) int32 and ``data``
    (k, n), where data[i, j] is the value at (j - offsets[i], j) (scipy's
    dia_matrix layout).  The format of banded matrices: an SpMV is k
    shifted dense multiply-adds, no gather and no scatter.  Host cache and
    device as for the other containers."""

    def __init__(self, m, n, offsets, data, device=None):
        self.m = int(m)
        self.n = int(n)
        self._np = _host_cache(offsets, data)
        self._arrays = [offsets, data]
        if device is None:
            device = next((a.device for a in self._arrays
                           if isinstance(a, torch.Tensor)), None)
        self._device = None if device is None else torch.device(device)

    device = _SparseBase.device
    _field = _SparseBase._field
    offsets = property(lambda self: self._field(0))
    data = property(lambda self: self._field(1))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    def np_arrays(self):
        """(offsets, data) as host numpy, without a device round trip when
        the container was built from host data."""
        if self._np is not None:
            return self._np
        return tuple(self._field(i).detach().cpu().numpy() for i in range(2))

    @property
    def nnz(self) -> int:
        """Stored count (explicit zeros inside the diagonals included)."""
        return sum(max(0, min(self.n, self.m + int(off)) - max(0, int(off)))
                   for off in self.np_arrays()[0])

    def to(self, device) -> "DIA":
        arrays = self._np if self._np is not None else self._arrays
        return DIA(self.m, self.n, *arrays, device=device)

    def __repr__(self):
        offs, dat = self.np_arrays()
        return (f"DIA(m={self.m}, n={self.n}, ndiag={len(offs)}, "
                f"dtype={dat.dtype})")

    def to_scipy(self):
        import scipy.sparse as sp

        offs, dat = self.np_arrays()
        return sp.dia_matrix((dat, offs), shape=self.shape)

    @classmethod
    def from_scipy(cls, a, device=None) -> "DIA":
        a = a.todia()
        return cls(a.shape[0], a.shape[1], a.offsets, a.data, device=device)

    def to_csc(self) -> CSC:
        from .ops import construct

        return construct.dia_to_csc(self)

    def todense(self):
        """The dense (m, n) tensor, through ``to_csc``."""
        return self.to_csc().todense()
