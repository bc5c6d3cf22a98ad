"""Sparse LU: factor + solve API.

    lu = splu(A, ordering="amd", tol=1.0)   # host factorization, P A Q = L U
    x  = lu.solve(b)                         # b: (n,) or (n, k) batched RHS
    plan = lu.solve_plan()                   # device solver on the CUDA card
    x  = plan(b)

Factor once / solve many is the GridCal power-flow pattern.  The host
factorization is the native C++ of ``native/`` (the JAX package's own);
``refactor_plan`` adds the KLU-style device numeric refactorization for
same-pattern matrices (``linalg/refactor.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..native import host_ext
from ..ops import construct
from ..ops.matvec import _cast_grad, _wants_grad
from ..types import CSC
from . import ordering as ordering_mod
from .lu_host import HostLU
from .trisolve import DenseTailTriSolvePlan, TriSolvePlan, choose_dense_tail

__all__ = ["SparseLU", "splu", "spsolve", "SolvePlan"]


class _Solve(torch.autograd.Function):
    """x = A^{-1} b through ``plan``, differentiable in b and, for a plan
    from a refactorization, in the matrix values it factored: with
    g = dL/dx and lam = A^{-H} g (the adjoint plan, the same factors swept
    the other way), dL/db = lam and dL/dvalues = -lam[rows] conj(x[cols])
    on A's pattern (summed over the columns of an (n, k) b)."""

    @staticmethod
    def forward(ctx, plan, b, values):
        with torch.inference_mode():
            x = plan._solve(b)
        # a copy made outside inference mode: autograd can return and save it
        x = x.clone()
        ctx.plan, ctx.b_dtype = plan, b.dtype
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        x, = ctx.saved_tensors
        with torch.inference_mode():
            lam = plan.adjoint()._solve(g.conj()).conj()
        lam = lam.clone()
        gb = gv = None
        if ctx.needs_input_grad[1]:
            gb = _cast_grad(lam, ctx.b_dtype)
        if ctx.needs_input_grad[2]:
            rows, cols = plan._pattern_fn()
            if plan.batched:  # (K, n): scenario k on values k
                gv = -(lam[:, rows] * x[:, cols].conj())
            else:
                gv = -(lam[rows] * x[cols].conj())
                gv = gv if gv.ndim == 1 else gv.sum(-1)
            gv = _cast_grad(gv, plan.values.dtype)
        return None, gb, gv


def _on_pattern(u, v, rows, cols, batched):
    """-conj(u_i v_j) at the entries (rows, cols): a factor entry's
    gradient, summed over the columns of (n, k) vectors; (K, e) for (K, n)
    vectors of a batched plan."""
    if batched:
        p = u[:, rows] * v[:, cols]
    else:
        p = u[rows] * v[cols]
        p = p if p.ndim == 1 else p.sum(-1)
    return -p.conj()


class _FactorSolve(torch.autograd.Function):
    """x = A^{-1} b through a plan that ``retarget_solve_plan`` made from
    factors (Lx, Ux) that require a gradient, differentiable in b and in
    the factors.  The forward keeps y = L^{-1} P b and x' = U^{-1} y (the
    permuted space).  With g' = dL/dx permuted, mu = U^{-H} g' and nu =
    L^{-H} mu (the adjoint plan's two sweeps, called one by one):

      dL/dUx = -mu_i conj(x'_j) on U's pattern, the diagonal too;
      dL/dLx = -nu_i conj(y_j) on L's strict pattern, 0 on its unit
               diagonal;
      dL/db  = P^T nu."""

    @staticmethod
    def forward(ctx, plan, b, Lx, Ux):
        with torch.inference_mode():
            y, xp = plan._sweeps(b)
            x = plan._unpermute(xp)
        # copies made outside inference mode: autograd can save and return
        y, xp, x = y.clone(), xp.clone(), x.clone()
        ctx.plan = plan
        ctx.dtypes = (b.dtype, Lx.dtype, Ux.dtype)
        ctx.save_for_backward(y, xp)
        return x

    @staticmethod
    def backward(ctx, g):
        plan, src = ctx.plan, ctx.plan._templates
        y, xp = ctx.saved_tensors
        batched = plan.batched
        adj = plan.adjoint()  # lplan: U^T (lower), uplan: L^T (upper)
        with torch.inference_mode():
            gp = g[:, plan.perm_c] if batched else g[plan.perm_c]
            mc = adj.lplan(gp.conj())          # conj(mu)
            nc = adj.uplan(mc)                 # conj(nu)
            G = torch.zeros(xp.shape[:1] * batched + (src.lnz + src.unz,),
                            dtype=torch.promote_types(mc.dtype, xp.dtype),
                            device=xp.device)
            lt, ut = src._ltpl, src._utpl
            diag = torch.arange(src.n, device=xp.device)
            G[..., src._l_epos] = _on_pattern(nc, y, lt.e_rows, lt.e_cols,
                                              batched)
            G[..., src._u_epos] = _on_pattern(mc, xp, ut.e_rows, ut.e_cols,
                                              batched)
            G[..., src._u_diagpos] = _on_pattern(mc, xp, diag, diag, batched)
            gb = None
            if ctx.needs_input_grad[1]:
                gb = torch.empty_like(nc)
                if batched:
                    gb[:, plan.perm_r] = nc.conj()
                else:
                    gb[plan.perm_r] = nc.conj()
        b_dt, l_dt, u_dt = ctx.dtypes
        gb = None if gb is None else _cast_grad(gb.clone(), b_dt)
        return (None, gb, _cast_grad(G[..., : src.lnz].clone(), l_dt),
                _cast_grad(G[..., src.lnz:].clone(), u_dt))


class SolvePlan(nn.Module):
    """x = A^{-1} b from a factorization: permute, L-solve, U-solve,
    unpermute.  ``forward(b)`` takes b of shape (n,) or (n, k); a plan
    over a stack of K factors of one pattern (``batched``, from a
    refactorization of (K, nnz) values) takes b (K, n), one right-hand
    side per factor.

    Differentiable (``_Solve``) in b and, for a plan a refactorization
    made from values that require a gradient (``values``), in those
    values; for a plan retargeted from factors that require a gradient
    (``factors``), in b and those factors (``_FactorSolve``).  ``adjoint``
    builds the plan of A^T at the first backward.  A call where no input
    requires a gradient runs under inference mode."""

    def __init__(self, lplan, uplan, perm_r, perm_c, adjoint=None):
        super().__init__()
        self.lplan = lplan
        self.uplan = uplan
        dev = next(lplan.buffers()).device
        # perm_r[k] = original row of pivot k; perm_c[k] = original col
        self.register_buffer("perm_r", torch.as_tensor(
            perm_r, dtype=torch.int64, device=dev))
        self.register_buffer("perm_c", torch.as_tensor(
            perm_c, dtype=torch.int64, device=dev))
        self._adjoint_fn = adjoint
        #: the values a refactorization factored, when they require a
        #: gradient, and the callable giving A's (row, column) int64 entry
        #: streams in their order
        self.values = None
        self._pattern_fn = None
        #: the factors (Lx, Ux) a plan was retargeted from, when either
        #: requires a gradient, and the refactorization whose templates
        #: (``attach_solve_templates``) place their entries
        self.factors = None
        self._templates = None

    @property
    def batched(self) -> bool:
        return getattr(self.lplan, "batched", False)

    def adjoint(self) -> "SolvePlan":
        """The SolvePlan of A^T: U^T (lower) then L^T (upper) over the same
        factors, the row and column permutations swapped; made at the
        first call and kept."""
        if "_adjoint" not in self.__dict__:
            if self._adjoint_fn is None:
                raise RuntimeError("this SolvePlan has no adjoint: it was "
                                   "made under inference mode")
            # kept outside the module's children: not part of its state
            self.__dict__["_adjoint"] = self._adjoint_fn()
        return self.__dict__["_adjoint"]

    def forward(self, b):
        if self.factors is not None and _wants_grad(b, *self.factors):
            return _FactorSolve.apply(self, b, *self.factors)
        if _wants_grad(b, self.values):
            return _Solve.apply(self, b, self.values)
        with torch.inference_mode():
            return self._solve(b)

    def _solve(self, b):
        return self._unpermute(self._sweeps(b)[1])

    def _sweeps(self, b):
        """(y, x') = (L^{-1} P b, U^{-1} y), in the permuted space."""
        y = self.lplan(b[:, self.perm_r] if self.batched else b[self.perm_r])
        return y, self.uplan(y)

    def _unpermute(self, z):
        x = torch.empty_like(z)
        if self.batched:
            x[:, self.perm_c] = z
        else:
            x[self.perm_c] = z
        return x


class SparseLU:
    """Result of ``splu``: factors as CSC matrices plus permutations.

    Attributes mirror scipy's SuperLU object: L (unit lower), U (upper),
    perm_r, perm_c, plus ``singular_cols`` (SuperLU info-style reporting).
    """

    def __init__(self, host: HostLU, method: str = "gp"):
        self._h = host
        #: which factorization kernel produced this object:
        #: 'supernodal' (BLAS-3 multifrontal, within-front pivoting) or
        #: 'gp' (scalar Gilbert-Peierls with threshold partial pivoting)
        self.method = method
        n = host.n
        self.n = n
        self.L = CSC(n, n, host.Lp, host.Li, host.Lx)
        self.U = CSC(n, n, host.Up, host.Ui, host.Ux)
        self.perm_r = host.perm_r
        self.perm_c = host.perm_c
        self.singular_cols = host.singular_cols
        self._plans = {}

    @property
    def is_singular(self) -> bool:
        return len(self.singular_cols) > 0

    @property
    def lnz(self) -> int:
        return self.L.nnz

    @property
    def unz(self) -> int:
        return self.U.nnz

    def solve_plan(self, style: str = "auto", device=None) -> SolvePlan:
        """Device solver on ``device`` (None: ``config.default_device()``,
        the CUDA card), cached per (style, device).

        style='auto' (default): each factor gets a blocked dense tail
        (``DenseTailTriSolvePlan``) when its trailing corner is dense (the
        separator clique under amd/nd orderings, which holds most
        dependency levels); 'level' forces the pure level-scheduled plan
        (the layout ``RefactorPlan`` retargets).
        """
        if style not in ("auto", "level"):
            raise ValueError(f"unknown solve_plan style {style!r}")
        device = resolve_device(device)
        key = (style, str(device))
        if key not in self._plans:
            h = self._h

            def factor_plan(Fp, Fi, Fx, lower):
                # a singular factor carries an exact-zero pivot: the level
                # plan propagates it as inf/nan (SuperLU-style), while the
                # dense tail's block inverse would raise; keep 'level'
                if style == "auto" and not self.is_singular:
                    tail = choose_dense_tail(self.n, Fp, Fi)
                    if tail:
                        return DenseTailTriSolvePlan(
                            self.n, Fp, Fi, Fx, lower=lower, tail=tail,
                            device=device)
                return TriSolvePlan(self.n, Fp, Fi, Fx, lower=lower,
                                    device=device)

            self._plans[key] = SolvePlan(
                factor_plan(h.Lp, h.Li, h.Lx, True),
                factor_plan(h.Up, h.Ui, h.Ux, False), h.perm_r, h.perm_c,
                adjoint=lambda: self._adjoint_plan(device))
        return self._plans[key]

    def _adjoint_plan(self, device) -> SolvePlan:
        """Level plans of U^T (lower) and L^T (upper), the transposes of the
        host factors, with the permutations swapped: x = A^{-T} b."""
        ut, lt = (construct.transpose(f).np_arrays() for f in (self.U,
                                                                self.L))
        return SolvePlan(
            TriSolvePlan(self.n, *ut, lower=True, device=device),
            TriSolvePlan(self.n, *lt, lower=False, device=device),
            self.perm_c, self.perm_r)

    def banded_solve_plan(self, s: int | None = None, device=None):
        """Block-bidiagonal solve plan on ``device`` (``linalg.banded``;
        None: ``config.default_device()``).  Needs a no-row-exchange banded
        factorization (ordering='rcm', tol=0 on a diagonally dominant
        matrix); raises ``ValueError`` if the factors exceed the block
        bandwidth."""
        from .banded import BandedSolvePlan

        return BandedSolvePlan(self._h, s=s, device=device)

    def refactor_plan(self, a: CSC, device=None):
        """KLU-style device refactorization plan: freeze this
        factorization's pattern and pivoting; ``plan.refactor(data)``
        re-factors a same-pattern matrix on ``device`` (None:
        ``config.default_device()``).  ``a`` must be the canonical CSC
        this LU was computed from."""
        from .refactor import RefactorPlan

        return RefactorPlan(self._h, a, device=device)

    def solve(self, b, device=None):
        """x = A^{-1} b (b: (n,) or (n, k), numpy or torch).  A tensor is
        solved on its own device; a numpy ``b`` goes to ``device`` (None:
        ``config.default_device()``).  Returns a tensor there."""
        if self.is_singular:
            import warnings

            warnings.warn(
                f"matrix is singular at columns {self.singular_cols[:8]}...; "
                "solution contains inf/nan (SuperLU-compatible behavior)")
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(np.asarray(b), device=resolve_device(device))
        return self.solve_plan(device=b.device)(b)

    def solve_host(self, b):
        """Host (numpy) solve — oracle path."""
        from .trisolve import lsolve, usolve

        h = self._h
        b = np.asarray(b)
        bp = b[h.perm_r]
        y = lsolve(h.Lp, h.Li, h.Lx, bp)
        z = usolve(h.Up, h.Ui, h.Ux, y)
        x = np.zeros_like(z)
        x[h.perm_c] = z
        return x


def _pattern_symmetry(n, ip, ix) -> float:
    """Fraction of off-diagonal entries whose transposed position is also
    in the pattern (1.0 = structurally symmetric)."""
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
    rows = np.asarray(ix, dtype=np.int64)
    off = rows != cols
    if not off.any():
        return 1.0
    k = rows[off] * n + cols[off]
    kt = cols[off] * n + rows[off]
    return len(np.intersect1d(k, kt, assume_unique=False)) / len(k)


def splu(a: CSC, ordering="auto", tol: float = 1.0,
         mode: str = "auto") -> SparseLU:
    """Factor P A Q = L U with partial pivoting (host, native C++).

    ordering: 'auto' (nested dissection when the supernodal kernel runs,
    approximate minimum degree otherwise), 'amd', 'nd', 'rcm', 'natural',
    a permutation array, or a callable.  tol: diagonal-preference
    threshold (1.0 = strict partial pivoting).

    mode selects the numeric kernel, with the JAX package's rules, so both
    packages give the same factors for the same matrix:

    * 'auto' — the BLAS-3 supernodal kernel when n >= 512, tol == 1 and
      the pattern is near-symmetric, with an element-growth check and
      fallback to the scalar kernel;
    * 'supernodal' — force the supernodal kernel (falls back only if it
      declines, e.g. an exactly singular block);
    * 'gp' — the scalar Gilbert-Peierls kernel (threshold partial
      pivoting; the only mode that honors ``tol``).
    """
    if a.m != a.n:
        raise ValueError(f"LU requires a square matrix, got {a.shape}")
    if mode not in ("auto", "supernodal", "gp"):
        raise ValueError(f"unknown splu mode {mode!r}")
    ip, ix, dt = a.np_arrays()
    use_sn = mode == "supernodal" or (
        mode == "auto" and tol == 1.0 and a.n >= 512
        and _pattern_symmetry(a.n, ip, ix) >= 0.9)
    if isinstance(ordering, str) and ordering == "auto":
        ordering = "nd" if use_sn else "amd"
    q = ordering_mod.get_ordering(ordering, a)

    host = None
    method = "gp"
    if use_sn:
        host = host_ext.lu_factor_sn(a.n, ip, ix, dt, q)
        if host is not None:
            method = "supernodal"
            if mode == "auto":
                # within-front pivoting only: verify element growth
                amax = float(np.abs(dt).max()) if len(dt) else 0.0
                umax = float(np.abs(host.Ux).max()) if len(host.Ux) else 0.0
                if not np.isfinite(umax) or umax > 1e7 * max(amax, 1e-300):
                    host, method = None, "gp"
    if host is None:
        host = host_ext.lu_factor(a.n, ip, ix, dt, q, tol)
    return SparseLU(host, method=method)


def spsolve(a: CSC, b, ordering="auto", tol: float = 1.0, device=None):
    """x = A^{-1} b (factor + solve); see ``SparseLU.solve`` for where."""
    return splu(a, ordering=ordering, tol=tol).solve(b, device=device)
