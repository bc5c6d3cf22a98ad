"""Triangular solves.

Two tiers, as in the JAX package (``csparse3_tpu/linalg/trisolve.py``):

* Host reference solves ``lsolve`` / ``usolve`` and the transposed
  ``ltsolve`` / ``utsolve`` (column-oriented numpy loops, verbatim), used
  as oracles and by ``SparseLDLT.solve_host``.

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

* Dense-tail hybrid solves (``DenseTailTriSolvePlan``): under a
  fill-reducing ordering the trailing corner of a factor is the dense
  separator clique and carries the deepest dependency chains.  It is
  solved by blocked dense substitution (block inverses from the host,
  (s, s) @ (s, B) matrix products), the sparse head keeps the level plan.
  The JAX plan pads the tail to whole blocks and scans over strips with
  drop-mode scatters; here the last block is simply short and the strips
  are slices of one dense matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..ops.matvec import _cast_grad, _wants_grad
from ..utils.profiling import span

__all__ = ["lsolve", "usolve", "ltsolve", "utsolve", "level_schedule",
           "TriSolvePlan",
           "choose_dense_tail", "DenseTailTriSolvePlan"]


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


def ltsolve(Lp, Li, Lx, b):
    """x = L^{-T} b for lower-triangular CSC L (diagonal entry first in
    each column).  b: (n,) or (n, k)."""
    x = np.array(b, copy=True)
    n = len(Lp) - 1
    for j in range(n - 1, -1, -1):
        lo, hi = Lp[j], Lp[j + 1]
        x[j] -= np.dot(Lx[lo + 1: hi], x[Li[lo + 1: hi]])
        x[j] /= Lx[lo]
    return x


def utsolve(Up, Ui, Ux, b):
    """x = U^{-T} b for upper-triangular CSC U (diagonal entry last).
    b: (n,) or (n, k)."""
    x = np.array(b, copy=True)
    n = len(Up) - 1
    for j in range(n):
        lo, hi = Up[j], Up[j + 1]
        x[j] -= np.dot(Ux[lo: hi - 1], x[Ui[lo: hi - 1]])
        x[j] /= Ux[hi - 1]
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

class _TriSolve(torch.autograd.Function):
    """x = F^{-1} b through a triangular plan, differentiable in b as the
    JAX package's plans are: dL/db = F^{-H} g, the plan's transposed solve
    (``_solve_adjoint``) of conj(g), conjugated back."""

    @staticmethod
    def forward(ctx, plan, b):
        with torch.inference_mode():
            x = plan._solve(b)
        ctx.plan, ctx.b_dtype = plan, b.dtype
        # a copy made outside inference mode: autograd can return it
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        with torch.inference_mode():
            lam = ctx.plan._solve_adjoint(g.conj()).conj()
        return None, _cast_grad(lam.clone(), ctx.b_dtype)


def _tri_solve(plan, b):
    """``plan``'s solve, in a ``trisolve`` span: through ``_TriSolve`` when
    b requires a gradient, else under inference mode."""
    with span("trisolve", levels=plan.nlevels, lower=plan.lower):
        if _wants_grad(b):
            return _TriSolve.apply(plan, b)
        with torch.inference_mode():
            return plan._solve(b)


class TriSolvePlan(nn.Module):
    """Level-scheduled triangular solve for one factor.

    Built from CSC factor arrays on the host and placed on ``device``
    (None: ``config.default_device()``, the CUDA card);
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
        dev = resolve_device(device)
        self.register_buffer("e_rows", torch.as_tensor(rows[o], device=dev))
        self.register_buffer("e_cols", torch.as_tensor(cols[o], device=dev))
        self.register_buffer("dinv", torch.as_tensor(dinv, device=dev))
        self.register_buffer("e_scaled", torch.as_tensor(
            vals[o] * dinv[rows[o]], device=dev))

    @property
    def nlevels(self):
        return len(self.e_ptr) - 1

    @property
    def batched(self) -> bool:
        """True for a plan over a stack of factors (``with_values`` of
        (K, e) values): one factor per scenario, one right-hand side each."""
        return self.e_scaled.ndim == 2

    def with_values(self, e_vals, dinv=None) -> "TriSolvePlan":
        """The same plan over new values: ``e_vals`` are the off-diagonal
        entries in level order (``F_offdiag[e_order]``), ``dinv`` is
        1/diag per row (None: unit diagonal).  Index buffers are shared.

        A leading scenario axis, ``e_vals`` (K, e) and ``dinv`` (K, n),
        gives a ``batched`` plan: K factors of one pattern, whose
        ``forward`` solves b (K, n), row k against factor k."""
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
            new.register_buffer("e_scaled", e_vals * dinv[..., self.e_rows])
        return new

    def forward(self, b):
        """x = F^{-1} b, one gather + multiply + index_add_ per level.
        b is (n,) or (n, k); for a ``batched`` plan (K, n).
        Differentiable in b (``_TriSolve``) when it requires a gradient."""
        return _tri_solve(self, b)

    def _solve(self, b):
        if self.batched:
            return self._forward_batched(b)
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

    #: the JAX package's name of the solve
    solve = forward

    def _forward_batched(self, b):
        """The level loop along dim 1 of b (K, n): the same gather,
        multiply and index_add_ per level, scenario k on factor k."""
        K = self.e_scaled.shape[0]
        if b.shape != (K, self.n):
            raise ValueError(f"a plan over {K} factors solves b of shape "
                             f"({K}, {self.n}); got {tuple(b.shape)}")
        dtype = torch.promote_types(b.dtype, self.e_scaled.dtype)
        if self.dinv is None:
            x = b.to(dtype, copy=True)
        else:
            x = b.to(dtype) * self.dinv
        p = self.e_ptr
        for lv in range(1, len(p) - 1):
            a, c = p[lv], p[lv + 1]
            contrib = x[:, self.e_cols[a:c]] * self.e_scaled[:, a:c]
            x.index_add_(1, self.e_rows[a:c], contrib, alpha=-1)
        return x

    solve = forward

    def _solve_adjoint(self, g):
        """y = F^{-T} g (a plain transpose) through the same buffers: the
        levels in reverse, each gathering at the entries' rows and
        scattering to their columns, u_j -= (F_ij / F_ii) u_i, then y =
        D^{-1} u (a row's u is final once every higher level is done)."""
        batched = self.batched
        squeeze = g.ndim == 1 and not batched
        if squeeze:
            g = g[:, None]
        dtype = torch.promote_types(g.dtype, self.e_scaled.dtype)
        u = g.to(dtype, copy=True)
        ax = 1 if batched else 0
        p = self.e_ptr
        for lv in range(len(p) - 2, 0, -1):
            a, c = p[lv], p[lv + 1]
            if batched:
                contrib = u[:, self.e_rows[a:c]] * self.e_scaled[:, a:c]
            else:
                contrib = u[self.e_rows[a:c]] * self.e_scaled[a:c, None]
            u.index_add_(ax, self.e_cols[a:c], contrib, alpha=-1)
        if self.dinv is not None:
            u = u * (self.dinv if batched else self.dinv[:, None])
        return u[:, 0] if squeeze else u


# ---------------------------------------------------------------------------
# dense-tail hybrid plan
# ---------------------------------------------------------------------------

def choose_dense_tail(n, Fp, Fi, max_tail=4096, min_tail=512,
                      min_density=0.15, block=256):
    """Pick a trailing-block size T (a multiple of ``block``) such that the
    T x T corner of the factor is at least ``min_density`` dense: the
    signature of the final separator clique under amd/nd orderings.
    Returns 0 when no worthwhile tail exists."""
    Fp = np.asarray(Fp)
    Fi = np.asarray(Fi).astype(np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
    best = 0
    T = min(max_tail, (n // 2) // block * block)
    while T >= min_tail:
        k0 = n - T
        cnt = int(((cols >= k0) & (Fi >= k0)).sum())
        if cnt >= min_density * (T * T / 2):
            best = T
            break
        T -= block if T - block >= min_tail else T
    return best


class DenseTailTriSolvePlan(nn.Module):
    """Triangular solve = level-scheduled head + blocked dense tail.

    The last ``tail`` rows and columns of the factor are held as one dense
    (tail, tail) matrix and solved block by block (``block`` rows at a
    time): x_b = inv(D_bb) r_b, then r -= D[:, b] x_b for the rows not yet
    solved.  The block inverses are computed on the host at build time.
    The head (n - tail rows) is a ``TriSolvePlan``; the entries that couple
    head and tail are one gather, multiply and ``index_add_``.  Same
    ``forward`` interface as ``TriSolvePlan``; ``SparseLU.solve_plan``
    picks it when ``choose_dense_tail`` finds a qualifying corner.
    """

    def __init__(self, n, Fp, Fi, Fx, lower: bool, tail: int,
                 block: int = 256, device=None):
        super().__init__()
        dev = resolve_device(device)
        Fp = np.asarray(Fp)
        rows = np.asarray(Fi).astype(np.int64)
        Fx = np.asarray(Fx)
        n_head = n - tail
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))

        # lower: head-internal needs both row and col in the head; upper:
        # rows <= col < n_head is implied by the column test
        head = (cols < n_head) & (rows < n_head) if lower else (cols < n_head)
        cross = ((cols < n_head) & (rows >= n_head)) if lower else (
            (cols >= n_head) & (rows < n_head))
        tail_m = (cols >= n_head) & (rows >= n_head)

        # head sub-CSC (square n_head); the mask keeps CSC order
        hc = cols[head]
        hp = np.zeros(n_head + 1, dtype=np.int64)
        hp[1:] = np.cumsum(np.bincount(hc, minlength=n_head))
        self.head = TriSolvePlan(n_head, hp, rows[head], Fx[head],
                                 lower=lower, device=dev)

        # cross entries: lower reads the head's x into tail rows, upper
        # reads the tail's x into head rows (tail ids are local)
        if lower:
            cr, cc = rows[cross] - n_head, cols[cross]
        else:
            cr, cc = rows[cross], cols[cross] - n_head
        self.register_buffer("c_rows", torch.as_tensor(cr, device=dev))
        self.register_buffer("c_cols", torch.as_tensor(cc, device=dev))
        self.register_buffer("c_vals", torch.as_tensor(Fx[cross], device=dev))

        dense = np.zeros((tail, tail), dtype=Fx.dtype)
        dense[rows[tail_m] - n_head, cols[tail_m] - n_head] = Fx[tail_m]
        self.blocks = [(lo, min(lo + block, tail))
                       for lo in range(0, tail, block)]
        self.register_buffer("dense", torch.as_tensor(dense, device=dev))
        for k, (lo, hi) in enumerate(self.blocks):
            self.register_buffer(f"invd{k}", torch.as_tensor(
                np.linalg.inv(dense[lo:hi, lo:hi]), device=dev))
        self.n, self.lower, self.tail, self.s = n, lower, tail, block

    @property
    def nlevels(self):
        return self.head.nlevels + len(self.blocks)

    def _dense_solve(self, r):
        """Blocked substitution on the (tail, B) right-hand side ``r``,
        in place; returns it as the solution."""
        order = range(len(self.blocks))
        for b in (order if self.lower else reversed(order)):
            lo, hi = self.blocks[b]
            xb = getattr(self, f"invd{b}").to(r.dtype) @ r[lo:hi]
            r[lo:hi] = xb
            if self.lower:
                r[hi:] -= self.dense[hi:, lo:hi].to(r.dtype) @ xb
            else:
                r[:lo] -= self.dense[:lo, lo:hi].to(r.dtype) @ xb
        return r

    def _dense_solve_t(self, r):
        """``_dense_solve`` of the transposed tail, in place: the blocks
        in the other order, each inverse and coupling block transposed."""
        order = range(len(self.blocks))
        for b in (reversed(order) if self.lower else order):
            lo, hi = self.blocks[b]
            xb = getattr(self, f"invd{b}").to(r.dtype).mT @ r[lo:hi]
            r[lo:hi] = xb
            if self.lower:
                r[:lo] -= self.dense[lo:hi, :lo].to(r.dtype).mT @ xb
            else:
                r[hi:] -= self.dense[lo:hi, hi:].to(r.dtype).mT @ xb
        return r

    def forward(self, b):
        """x = F^{-1} b; differentiable in b (``_TriSolve``) when it
        requires a gradient."""
        return _tri_solve(self, b)

    def _solve_adjoint(self, g):
        """y = F^{-T} g (a plain transpose): with F = [[H, 0], [C, T]]
        (lower; upper mirrored), y_t = T^{-T} g_t and y_h = H^{-T} (g_h -
        C^T y_t), the head through its own adjoint."""
        squeeze = g.ndim == 1
        if squeeze:
            g = g[:, None]
        n_head = self.n - self.tail
        dtype = torch.promote_types(g.dtype, self.dense.dtype)
        if self.lower:
            yt = self._dense_solve_t(g[n_head:].to(dtype, copy=True))
            gh = g[:n_head].to(dtype, copy=True)
            gh.index_add_(0, self.c_cols,
                          self.c_vals[:, None] * yt[self.c_rows], alpha=-1)
            yh = self.head._solve_adjoint(gh)
        else:
            yh = self.head._solve_adjoint(g[:n_head]).to(dtype)
            r = g[n_head:].to(dtype, copy=True)
            r.index_add_(0, self.c_cols,
                         self.c_vals[:, None] * yh[self.c_rows], alpha=-1)
            yt = self._dense_solve_t(r)
        out = torch.cat([yh.to(dtype), yt])
        return out[:, 0] if squeeze else out

    def _solve(self, b):
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        n_head = self.n - self.tail
        dtype = torch.promote_types(b.dtype, self.dense.dtype)
        if self.lower:
            xh = self.head(b[:n_head])
            r = b[n_head:].to(dtype, copy=True)
            r.index_add_(0, self.c_rows,
                         self.c_vals[:, None] * xh[self.c_cols], alpha=-1)
            xt = self._dense_solve(r)
        else:
            xt = self._dense_solve(b[n_head:].to(dtype, copy=True))
            bh = b[:n_head].to(dtype, copy=True)
            bh.index_add_(0, self.c_rows,
                          self.c_vals[:, None] * xt[self.c_cols], alpha=-1)
            xh = self.head(bh)
        out = torch.cat([xh.to(dtype), xt])
        return out[:, 0] if squeeze else out

    #: the JAX package's name of the solve
    solve = forward

    solve = forward
