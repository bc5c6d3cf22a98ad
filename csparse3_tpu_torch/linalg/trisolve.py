"""Triangular solves.

Two tiers, as in the JAX package (``csparse3_tpu/linalg/trisolve.py``):

* Host reference solves ``lsolve`` / ``usolve`` (column-oriented numpy
  loops, verbatim), used as oracles.

* Device level-scheduled solves (``TriSolvePlan``): rows of the triangular
  factor are grouped into dependency levels (level(i) = 1 + max level over
  the rows i reads).  All rows of a level are independent, so each level
  is one gather, one multiply and one ``index_add_``.

The JAX plan pads every level to one width so that the solve is a
``lax.scan``, with out-of-range padding indices that its scatters drop.
PyTorch runs the level loop eagerly, so this plan keeps the entries flat,
sorted by level, and slices each level: no padding, no dummy workspace
row, no dropped indices.  The diagonal is folded in up front: row i's
entries are stored pre-scaled by 1/diag[i], so a solve is x = b / diag
followed by x[i] -= sum_j (F[i, j] / diag[i]) x[j] level by level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

__all__ = ["lsolve", "usolve", "level_schedule", "TriSolvePlan"]


# ---------------------------------------------------------------------------
# host reference solves (CSC, column-oriented like cs_lsolve/cs_usolve)
# ---------------------------------------------------------------------------

def lsolve(Lp, Li, Lx, b):
    """x = L^{-1} b for lower-triangular CSC L with explicit diagonal
    (diagonal entry first in each column).  b: (n,) or (n, k)."""
    x = np.array(b, copy=True)
    n = len(Lp) - 1
    vec = x.ndim == 1
    for j in range(n):
        lo, hi = Lp[j], Lp[j + 1]
        x[j] /= Lx[lo]
        rows = Li[lo + 1 : hi]
        coeff = Lx[lo + 1 : hi]
        if vec:
            x[rows] -= coeff * x[j]
        else:
            x[rows] -= coeff[:, None] * x[j][None, :]
    return x


def usolve(Up, Ui, Ux, b):
    """x = U^{-1} b for upper-triangular CSC U (diagonal entry last).
    b: (n,) or (n, k)."""
    x = np.array(b, copy=True)
    n = len(Up) - 1
    vec = x.ndim == 1
    for j in range(n - 1, -1, -1):
        lo, hi = Up[j], Up[j + 1]
        x[j] /= Ux[hi - 1]
        rows = Ui[lo : hi - 1]
        coeff = Ux[lo : hi - 1]
        if vec:
            x[rows] -= coeff * x[j]
        else:
            x[rows] -= coeff[:, None] * x[j][None, :]
    return x


# ---------------------------------------------------------------------------
# level scheduling (host analysis)
# ---------------------------------------------------------------------------

def level_schedule(n, rows, cols, lower: bool):
    """Dependency levels for a triangular matrix given in (row, col) entry
    streams with the diagonal EXCLUDED.  For lower solves row i depends on
    cols < i; for upper solves on cols > i.  Returns level[i] per row.

    Exact and O(nnz + n): vectorized Kahn topological waves — wave 0 is
    every row with no off-diagonal entries; releasing a wave decrements the
    indegree of the rows that read it (one grouped gather per wave)."""
    lev = np.zeros(n, dtype=np.int64)
    nnz = len(rows)
    if nnz == 0:
        return lev
    indeg = np.bincount(rows, minlength=n)
    # group entries by column for "who reads row c" lookups
    order = np.argsort(cols, kind="stable")
    rows_by_col = rows[order]
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(colptr, cols + 1, 1)
    colptr = np.cumsum(colptr)

    frontier = np.flatnonzero(indeg == 0)
    level = 0
    assigned = len(frontier)
    while frontier.size:
        lev[frontier] = level
        # entries whose col is in the frontier
        starts = colptr[frontier]
        counts = colptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(total) + np.repeat(starts - offs[:-1], counts)
        touched = rows_by_col[pos]
        dec = np.bincount(touched, minlength=n)
        indeg -= dec
        frontier = np.unique(touched[indeg[touched] == 0])
        level += 1
        assigned += len(frontier)
    if assigned < n and nnz:
        # rows never released -> cyclic dependency (not triangular)
        remaining = indeg > 0
        if remaining.any():
            raise ValueError("level_schedule: matrix is not triangular (cycle)")
    return lev


class _Slabs(NamedTuple):
    e_order: np.ndarray  # entry positions (in the input stream) by level
    e_ptr: np.ndarray    # (nlev + 1,) level boundaries into e_order


def _build_slabs(n, rows, lev) -> _Slabs:
    """Off-diagonal entries (row ids ``rows``) grouped by the level of
    their row (``lev`` from ``level_schedule``): a stable sort, so entries
    keep their input order within a level, as in the JAX package's padded
    slabs."""
    nlev = int(lev.max()) + 1 if n else 1
    elev = lev[rows]
    e_order = np.argsort(elev, kind="stable")
    e_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(elev, minlength=nlev))])
    return _Slabs(e_order, e_ptr)


# ---------------------------------------------------------------------------
# device plan
# ---------------------------------------------------------------------------

class TriSolvePlan(nn.Module):
    """Level-scheduled triangular solve for one factor.

    Built from CSC factor arrays on the host and placed on ``device``;
    ``forward(b)`` (also ``solve``) takes b of shape (n,) or (n, k).
    ``e_order`` (host) maps the level-sorted entries back to the factor's
    off-diagonal entries in CSC order, which is how
    ``linalg.refactor`` gives the plan fresh values.
    """

    def __init__(self, n, Fp, Fi, Fx, lower: bool, device=None):
        super().__init__()
        Fp = np.asarray(Fp)
        Fi = np.asarray(Fi)
        Fx = np.asarray(Fx)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
        rows = Fi.astype(np.int64)
        on_diag = rows == cols
        diag = np.ones(n, dtype=Fx.dtype)
        diag[rows[on_diag]] = Fx[on_diag]
        off = ~on_diag
        rows, cols, vals = rows[off], cols[off], Fx[off]
        lev = level_schedule(n, rows, cols, lower)
        slabs = _build_slabs(n, rows, lev)
        o = slabs.e_order
        with np.errstate(divide="ignore"):  # zero pivot -> inf (SuperLU-style)
            dinv = (1.0 / diag).astype(diag.dtype)
        self.n = n
        self.lower = lower
        self.e_order = o
        self.e_ptr = slabs.e_ptr.tolist()
        dev = torch.device(device) if device is not None else None
        self.register_buffer("e_rows", torch.as_tensor(rows[o], device=dev))
        self.register_buffer("e_cols", torch.as_tensor(cols[o], device=dev))
        self.register_buffer("dinv", torch.as_tensor(dinv, device=dev))
        self.register_buffer("e_scaled", torch.as_tensor(
            vals[o] * dinv[rows[o]], device=dev))

    @property
    def nlevels(self):
        return len(self.e_ptr) - 1

    def with_values(self, e_vals, dinv=None) -> "TriSolvePlan":
        """The same plan over new values: ``e_vals`` are the off-diagonal
        entries in level order (``F_offdiag[e_order]``), ``dinv`` is
        1/diag per row (None: unit diagonal).  Index buffers are shared."""
        new = TriSolvePlan.__new__(TriSolvePlan)
        nn.Module.__init__(new)
        new.n, new.lower = self.n, self.lower
        new.e_order, new.e_ptr = self.e_order, self.e_ptr
        new.register_buffer("e_rows", self.e_rows)
        new.register_buffer("e_cols", self.e_cols)
        if dinv is None:
            new.register_buffer("dinv", None)
            new.register_buffer("e_scaled", e_vals)
        else:
            new.register_buffer("dinv", dinv)
            new.register_buffer("e_scaled", e_vals * dinv[self.e_rows])
        return new

    @torch.inference_mode()
    def forward(self, b):
        """x = F^{-1} b, one gather + multiply + index_add_ per level."""
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        dtype = torch.promote_types(b.dtype, self.e_scaled.dtype)
        if self.dinv is None:
            x = b.to(dtype, copy=True)
        else:
            x = b.to(dtype) * self.dinv[:, None]
        # level 0 holds the rows without off-diagonal entries: nothing to do
        p = self.e_ptr
        for lv in range(1, len(p) - 1):
            a, c = p[lv], p[lv + 1]
            contrib = x[self.e_cols[a:c]] * self.e_scaled[a:c, None]
            x.index_add_(0, self.e_rows[a:c], contrib, alpha=-1)
        return x[:, 0] if squeeze else x

    solve = forward
