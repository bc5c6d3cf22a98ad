"""Sparse LDL^T factorization, the symmetric direct solver.

The JAX package's ``csparse3_tpu/linalg/cholesky.py``: P A P^T = L D L^T
for symmetric A (both triangles stored), half the factor work of LU on the
symmetric systems of this domain (DC and fast-decoupled B' / B'', gain
matrices of state estimation, Laplacians, and the complex-symmetric Ybus:
LDL^T without conjugation factors a complex SYMMETRIC matrix).

The factorization is host work (the native up-looking kernel of
``native/host_ext.cpp``), without pivoting: the symmetric fill-reducing
ordering is the only permutation, and zero pivots are reported
(``is_singular`` / ``singular_cols``), as ``SparseLU`` reports them.

The solve reuses the LU machinery: L and L^T feed the level-scheduled
(or dense-tail) triangular solve plans on the device, with a diagonal
scale between the two sweeps, x = P^T L^{-T} D^{-1} L^{-1} P b.  The JAX
package keeps D^{-1} and P on the host for its transfer policy; here they
are buffers of the plan, on its device, and complex factors solve natively
on the card.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..ops import construct
from ..ops.matvec import _cast_grad, _wants_grad
from ..types import CSC
from ..utils.build import BuildError
from . import ordering as ordering_mod
from .trisolve import (DenseTailTriSolvePlan, TriSolvePlan,
                       choose_dense_tail, lsolve, ltsolve)

__all__ = ["LDLTSolvePlan", "SparseLDLT", "ldlt"]


class _SymSolve(torch.autograd.Function):
    """x = A^{-1} b through an ``LDLTSolvePlan``, differentiable in b: A is
    symmetric (complex symmetric, not hermitian), so dL/db = A^{-H} g =
    conj(A^{-1} conj(g)) is the same solve."""

    @staticmethod
    def forward(ctx, plan, b):
        with torch.inference_mode():
            x = plan._solve(b)
        ctx.plan, ctx.b_dtype = plan, b.dtype
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        with torch.inference_mode():
            lam = ctx.plan._solve(g.conj()).conj()
        return None, _cast_grad(lam.clone(), ctx.b_dtype)


class LDLTSolvePlan(nn.Module):
    """x = A^{-1} b from an LDL^T factorization: permute, L sweep, D^{-1}
    scale, L^T sweep, unpermute.  ``forward(b)`` takes (n,) or (n, k) on
    the plan's device; differentiable in b (``_SymSolve``) when it
    requires a gradient, any other call runs under inference mode."""

    def __init__(self, lplan, ltplan, dinv, perm):
        super().__init__()
        self.lplan = lplan
        self.ltplan = ltplan
        dev = next(lplan.buffers()).device
        self.register_buffer("dinv", torch.as_tensor(dinv, device=dev))
        self.register_buffer("perm", torch.as_tensor(
            perm, dtype=torch.int64, device=dev))

    def forward(self, b):
        if _wants_grad(b):
            return _SymSolve.apply(self, b)
        with torch.inference_mode():
            return self._solve(b)

    def _solve(self, b):
        y = self.lplan(b[self.perm])
        y = y * (self.dinv if y.ndim == 1 else self.dinv[:, None])
        z = self.ltplan(y)
        x = torch.empty_like(z)
        x[self.perm] = z
        return x


class SparseLDLT:
    """P A P^T = L D L^T for symmetric A (values: both triangles stored).
    L is unit lower triangular (unit diagonal stored first in each column),
    ``perm`` the symmetric ordering, ``D`` the pivots."""

    def __init__(self, n, Lp, Li, Lx, D, perm, singular_cols):
        self.n = n
        self.Lp, self.Li, self.Lx = Lp, Li, Lx
        self.D = D
        self.perm = np.asarray(perm)
        self.singular_cols = np.asarray(singular_cols)
        self._plans = {}

    @property
    def is_singular(self) -> bool:
        return len(self.singular_cols) > 0

    @property
    def fill_nnz(self) -> int:
        return len(self.Lx)

    def solve_plan(self, device=None) -> LDLTSolvePlan:
        """Device solve plan on ``device`` (None: ``config.default_device()``,
        the CUDA card), made at the first call for that device and kept.
        Each sweep gets the same dense-tail hybrid as
        ``SparseLU.solve_plan``: a dense trailing separator clique is solved
        as blocked matrix products, the head level by level."""
        device = resolve_device(device)
        key = str(device)
        if key not in self._plans:
            def factor_plan(Fp, Fi, Fx, lower):
                if not self.is_singular:
                    tail = choose_dense_tail(self.n, Fp, Fi)
                    if tail:
                        return DenseTailTriSolvePlan(
                            self.n, Fp, Fi, Fx, lower=lower, tail=tail,
                            device=device)
                return TriSolvePlan(self.n, Fp, Fi, Fx, lower=lower,
                                    device=device)

            lplan = factor_plan(self.Lp, self.Li, self.Lx, True)
            # L^T in CSC form: the transpose, NOT the conjugate transpose
            lt = construct.transpose(CSC(self.n, self.n, self.Lp, self.Li,
                                         self.Lx, canonical=True))
            ltplan = factor_plan(*lt.np_arrays(), False)
            with np.errstate(divide="ignore"):
                dinv = np.where(self.D != 0, 1.0 / self.D, np.inf)
            self._plans[key] = LDLTSolvePlan(lplan, ltplan, dinv, self.perm)
        return self._plans[key]

    def _warn_singular(self):
        if self.is_singular:
            warnings.warn(
                f"matrix is singular at columns "
                f"{self.singular_cols[:8]}...; solution contains inf/nan")

    def solve(self, b, device=None):
        """x = A^{-1} b (b: (n,) or (n, k), numpy or torch).  A tensor is
        solved on its own device; a numpy ``b`` goes to ``device`` (None:
        ``config.default_device()``).  Returns a tensor there."""
        self._warn_singular()
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(np.asarray(b), device=resolve_device(device))
        return self.solve_plan(device=b.device)(b)

    def solve_host(self, b):
        """Host (numpy) solve: the oracle path, in the factor's precision."""
        self._warn_singular()
        b = np.asarray(b)
        y = lsolve(self.Lp, self.Li, self.Lx, b[self.perm])
        with np.errstate(divide="ignore", invalid="ignore"):
            y = (y.T / self.D).T if y.ndim == 2 else y / self.D
        z = ltsolve(self.Lp, self.Li, self.Lx, y)
        x = np.zeros_like(z)
        x[self.perm] = z
        return x


def _ldlt_dense_fallback(n, Ap, Ai, Ax):
    """scipy.linalg.ldl of the dense form: the factorization when the
    native library cannot be built, for small systems."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    A = sp.csc_matrix((Ax, Ai, Ap), shape=(n, n)).toarray()
    lu, d, p = sla.ldl(A, lower=True, hermitian=False)
    if not np.array_equal(p, np.arange(n)):
        raise ValueError(
            "dense LDL fallback pivoted (the matrix needs 2x2 pivots); the "
            "native kernel is required here")
    if np.abs(d - np.diag(np.diag(d))).max() > 0:
        raise ValueError("2x2 pivot blocks: not LDL^T factorable without "
                         "pivoting")
    L = sp.csc_matrix(lu)
    sing = np.flatnonzero(np.diag(d) == 0)
    return (L.indptr.astype(np.int64), L.indices.astype(np.int64), L.data,
            np.diag(d).copy(), sing)


def ldlt(a: CSC, ordering="amd") -> SparseLDLT:
    """Factor symmetric ``a`` (both triangles stored) as P A P^T = L D L^T
    on the host.

    ordering: 'amd' (default), 'rcm', 'nd', 'mindeg', 'natural' or None,
    a permutation array, or a callable.  No numeric pivoting: meant for
    (block) diagonally dominant symmetric systems and complex-symmetric
    Ybus; an indefinite system that needs 2x2 pivots takes ``splu``.
    """
    n, m = a.shape
    if n != m:
        raise ValueError(f"ldlt requires a square matrix, got {a.shape}")
    if not a.canonical:
        a = construct.canonicalize(a)
    if ordering is None:
        perm = np.arange(n)
        ap = a
    else:
        perm = np.asarray(ordering_mod.get_ordering(ordering, a))
        if np.array_equal(perm, np.arange(n)):
            ap = a
        else:
            from ..ops.slicing import submatrix

            ap = submatrix(a, perm, perm)
    Ap, Ai, Ax = ap.np_arrays()
    try:
        from ..native import host_ext

        Lp, Li, Lx, D, sing = host_ext.ldlt_factor(n, Ap, Ai, Ax)
    except BuildError:
        Lp, Li, Lx, D, sing = _ldlt_dense_fallback(n, Ap, Ai, Ax)
    return SparseLDLT(n, Lp, Li, Lx, D, perm, sing)
