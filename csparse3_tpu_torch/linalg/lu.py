"""Sparse LU: factor + solve API.

    lu = splu(A, ordering="amd", tol=1.0)   # host factorization, P A Q = L U
    x  = lu.solve(b)                         # b: (n,) or (n, k) batched RHS
    plan = lu.solve_plan(device="cuda")      # level-scheduled device solver
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

from ..native import host_ext
from ..types import CSC
from . import ordering as ordering_mod
from .lu_host import HostLU
from .trisolve import TriSolvePlan

__all__ = ["SparseLU", "splu", "spsolve", "SolvePlan"]


class SolvePlan(nn.Module):
    """x = A^{-1} b from a factorization: permute, L-solve, U-solve,
    unpermute.  ``forward(b)`` takes b of shape (n,) or (n, k)."""

    def __init__(self, lplan: TriSolvePlan, uplan: TriSolvePlan, perm_r,
                 perm_c):
        super().__init__()
        self.lplan = lplan
        self.uplan = uplan
        dev = lplan.e_rows.device
        # perm_r[k] = original row of pivot k; perm_c[k] = original col
        self.register_buffer("perm_r", torch.as_tensor(
            perm_r, dtype=torch.int64, device=dev))
        self.register_buffer("perm_c", torch.as_tensor(
            perm_c, dtype=torch.int64, device=dev))

    @torch.inference_mode()
    def forward(self, b):
        z = self.uplan(self.lplan(b[self.perm_r]))
        x = torch.empty_like(z)
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

    def solve_plan(self, device="cpu") -> SolvePlan:
        """Level-scheduled device solver on ``device`` (cached per device).

        This is the JAX package's ``solve_plan(style='level')``.  Its
        default style also gives each factor a dense blocked tail
        (``DenseTailTriSolvePlan``) when the trailing corner is dense;
        that plan is not ported yet, so every factor gets the level plan.
        """
        key = str(torch.device(device))
        if key not in self._plans:
            h = self._h
            self._plans[key] = SolvePlan(
                TriSolvePlan(self.n, h.Lp, h.Li, h.Lx, lower=True,
                             device=device),
                TriSolvePlan(self.n, h.Up, h.Ui, h.Ux, lower=False,
                             device=device),
                h.perm_r, h.perm_c)
        return self._plans[key]

    def refactor_plan(self, a: CSC, device="cpu"):
        """KLU-style device refactorization plan: freeze this
        factorization's pattern and pivoting; ``plan.refactor(data)``
        re-factors a same-pattern matrix on ``device``.  ``a`` must be
        the canonical CSC this LU was computed from."""
        from .refactor import RefactorPlan

        return RefactorPlan(self._h, a, device=device)

    def solve(self, b):
        """x = A^{-1} b (b: (n,) or (n, k), numpy or torch).  Runs on b's
        device (the CPU for numpy) and returns a tensor there."""
        if self.is_singular:
            import warnings

            warnings.warn(
                f"matrix is singular at columns {self.singular_cols[:8]}...; "
                "solution contains inf/nan (SuperLU-compatible behavior)")
        b = torch.as_tensor(b)
        return self.solve_plan(b.device)(b)

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


def spsolve(a: CSC, b, ordering="auto", tol: float = 1.0):
    """x = A^{-1} b (factor + solve)."""
    return splu(a, ordering=ordering, tol=tol).solve(b)
