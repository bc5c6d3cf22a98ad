"""1-D block-row partitioning of a square sparse matrix over a mesh.

The JAX package's ``csparse3_tpu/parallel/partition.py``, ported.  Rows
are split into S contiguous blocks of ``mloc = ceil(m / S)`` rows (rounded
up to ``row_block``, the matrix zero-padded to ``S * mloc``); position s
owns rows ``[s mloc, (s + 1) mloc)`` and the same slice of every vector.

Entries are grouped on the host by ring distance: an entry (i, j) of
position s = i // mloc whose column block is c = j // mloc has offset
d = c - s, and a SpMV contracts group d once the x-slice of position
s + d has arrived (``parallel/spmv.py``).  k = max |d| is the halo radius;
the ring strategy is taken when 2k < S - 1, else one all-gather of x and
global column ids.  Each (position, offset) group is padded to a common
width E with row id ``mloc`` (a dummy slot past the block) and value 0.

The host arrays keep the JAX package's layout and dtypes: (S, 2k + 1, E)
for the ring, (S, E) for the all-gather strategy, int32 ids.  ``local``
places position s's (G, E) / (E,) slices on its device at the first
distributed call and keeps them.

The values may instead be a tensor of the same layout (``with_values``):
the counterpart of the JAX package's ``e_vals`` pytree leaf, which
``jax.grad`` differentiates.  ``local`` then places them at every call,
so that a SpMV's gradient flows back through the placement into the
(S, G, E) / (S, E) tensor (padding slots get their own gradient, as in
the JAX package).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import CSC

__all__ = ["RowPartition", "partition_rows"]


def _entry_streams_np(a: CSC):
    """(rows, cols, vals) of ``a``'s stored entries, host int64 ids."""
    ip, ix, dt = a.np_arrays()
    cols = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(ip))
    return np.asarray(ix).astype(np.int64), cols, np.asarray(dt)


class RowPartition:
    """Block-row partition of a square sparse matrix (host arrays, see the
    module docstring); ``(m, n, S, mloc, k, strategy)`` as in the JAX
    package."""

    def __init__(self, m, n, S, mloc, k, strategy, e_rows, e_cols, e_vals):
        self.m, self.n, self.S, self.mloc, self.k = m, n, S, mloc, k
        self.strategy = strategy
        self.e_rows = np.asarray(e_rows)
        self.e_cols = np.asarray(e_cols)
        self.e_vals = (e_vals if isinstance(e_vals, torch.Tensor)
                       else np.asarray(e_vals))
        self._placed = {}

    def __repr__(self):
        return (f"RowPartition(m={self.m}, S={self.S}, mloc={self.mloc}, "
                f"k={self.k}, strategy={self.strategy!r})")

    @property
    def m_pad(self) -> int:
        return self.S * self.mloc

    @property
    def dtype(self) -> torch.dtype:
        if isinstance(self.e_vals, torch.Tensor):
            return self.e_vals.dtype
        return torch.from_numpy(self.e_vals[:0].copy()).dtype

    def with_values(self, e_vals) -> "RowPartition":
        """This partition over other values: ``e_vals`` in the layout of
        ``self.e_vals`` ((S, 2k + 1, E) or (S, E)), a tensor (for example
        one that requires a gradient) or an array.  The index arrays and
        their device copies are shared."""
        if tuple(e_vals.shape) != self.e_vals.shape:
            raise ValueError(f"values of shape {tuple(e_vals.shape)} for a "
                             f"partition of shape {self.e_vals.shape}")
        new = RowPartition(self.m, self.n, self.S, self.mloc, self.k,
                           self.strategy, self.e_rows, self.e_cols, e_vals)
        if isinstance(e_vals, torch.Tensor):
            new._placed = {key: [(er, ec, None) for er, ec, _ in leaves]
                           for key, leaves in self._placed.items()}
        return new

    def local(self, mesh):
        """Per position (rows, cols, vals) tensors on the position's device
        (int64 ids): uploaded at the first call for these devices and
        kept; values held as a tensor are placed at every call."""
        if mesh.size != self.S:
            raise ValueError(f"mesh has {mesh.size} positions but the "
                             f"partition was built for S={self.S}")
        key = mesh.devices
        live = isinstance(self.e_vals, torch.Tensor)
        if key not in self._placed:
            # normal tensors, also under inference mode: a call that
            # autograd records saves them
            with torch.inference_mode(False):
                self._placed[key] = [
                    (torch.as_tensor(self.e_rows[s], dtype=torch.int64,
                                     device=d),
                     torch.as_tensor(self.e_cols[s], dtype=torch.int64,
                                     device=d),
                     None if live else torch.as_tensor(
                         np.ascontiguousarray(self.e_vals[s]), device=d))
                    for s, d in enumerate(mesh.devices)]
        if not live:
            return self._placed[key]
        return [(er, ec, self.e_vals[s].to(d))
                for s, ((er, ec, _), d) in enumerate(
                    zip(self._placed[key], mesh.devices))]

    # -- vector layout helpers ----------------------------------------------
    def pad_vector(self, x):
        """Zero-pad a length-m (or (m, B)) array or tensor to m_pad rows."""
        pad = self.m_pad - x.shape[0]
        if pad == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    def trim_vector(self, x):
        return x[: self.m]


def partition_rows(
    a: CSC,
    S: int,
    strategy: Optional[str] = None,
    row_block: int = 8,
) -> RowPartition:
    """Build a RowPartition of square ``a`` across ``S`` positions (host).

    strategy: 'ring' | 'allgather' | None (auto: ring iff the halo radius
    k keeps ring traffic below a full gather, i.e. 2k < S - 1).
    row_block: round mloc up to this multiple."""
    if a.m != a.n:
        raise ValueError(
            f"row partition requires a square matrix for SpMV, got {a.shape}"
        )
    m = a.m
    mloc = -(-m // S)
    mloc = -(-mloc // row_block) * row_block
    rows, cols, vals = _entry_streams_np(a)

    shard = rows // mloc
    col_shard = cols // mloc
    d = col_shard - shard
    k = int(np.abs(d).max()) if len(d) else 0
    if strategy is None:
        strategy = "ring" if 2 * k < S - 1 else "allgather"

    if strategy == "allgather":
        # one group per position, global column ids
        counts = np.bincount(shard, minlength=S)
        E = max(int(counts.max()) if counts.size else 1, 1)
        er = np.full((S, E), mloc, dtype=np.int32)
        ec = np.zeros((S, E), dtype=np.int32)
        ev = np.zeros((S, E), dtype=vals.dtype)
        order = np.argsort(shard, kind="stable")
        offs = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(rows)) - offs[shard[order]]
        er[shard[order], slot] = (rows[order]
                                  - shard[order] * mloc).astype(np.int32)
        ec[shard[order], slot] = cols[order].astype(np.int32)
        ev[shard[order], slot] = vals[order]
        return RowPartition(m, a.n, S, mloc, k, "allgather", er, ec, ev)

    if strategy != "ring":
        raise ValueError(f"unknown partition strategy {strategy!r}")

    G = 2 * k + 1
    gid = shard * G + (d + k)  # flat (position, offset-group) id
    counts = np.bincount(gid, minlength=S * G)
    E = max(int(counts.max()) if counts.size else 1, 1)
    er = np.full((S * G, E), mloc, dtype=np.int32)
    ec = np.zeros((S * G, E), dtype=np.int32)
    ev = np.zeros((S * G, E), dtype=vals.dtype)
    order = np.argsort(gid, kind="stable")
    gs = gid[order]
    offs = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(rows)) - offs[gs]
    er[gs, slot] = (rows[order] - shard[order] * mloc).astype(np.int32)
    ec[gs, slot] = (cols[order] - col_shard[order] * mloc).astype(np.int32)
    ev[gs, slot] = vals[order]
    return RowPartition(m, a.n, S, mloc, k, "ring", er.reshape(S, G, E),
                        ec.reshape(S, G, E), ev.reshape(S, G, E))
