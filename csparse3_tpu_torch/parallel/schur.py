"""Distributed direct solve: Schur-complement domain decomposition.

The JAX package's ``csparse3_tpu/parallel/schur.py``, ported.  Rows are
split into S contiguous blocks (order the matrix with RCM/ND first so the
blocks are graph-local); the interface Γ is every row incident to a
cross-block entry.  With the interiors first and Γ last the matrix is
bordered block diagonal:

    [ A_0          E_0 ]        A_s : interior of shard s
    [      ..      ..  ]        E_s : interior -> interface coupling
    [         A_S  E_S ]        F_s : interface -> interior coupling
    [ F_0  ..  F_S  C  ]        C   : interface block

Factorization (host, once, scipy and ``linalg.splu``): splu(A_s) per
shard, the interiors identity-padded to a common size; the dense
interface-local W_s = A_s^{-1} E_s; Sc = C - Σ_s F_s W_s; splu(Sc).

Solve (``SchurSolvePlan``; ``dist_solve`` over a mesh):
  y_s = A_s^{-1} b_s                   per-position level-scheduled plan
  g   = b_Γ - Σ_s F_s y_s              entry scatter + psum over positions
  x_Γ = Sc^{-1} g                      once per distinct device
  x_s = y_s - W_s x_Γ[wcols_s]         one (mi x nl_s) @ (nl_s x B) product

The products run with TF32 off (the JAX package asks for 'highest').

Deviation from the JAX package, by design: the per-shard plans and W_s
are kept per position at their own sizes; the JAX package pads them to
one stacked shape for its SPMD program.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device
from ..linalg.banded import _matmul_precision
from ..linalg.lu import splu
from ..ops.construct import dense_to_csc
from ..ops.matvec import _cast_grad, _wants_grad
from ..types import CSC
from .mesh import psum, replicate

__all__ = ["SchurLU", "SchurSolvePlan"]


class SchurLU:
    """Distributed direct factorization of a square sparse matrix (host)."""

    def __init__(self, a: CSC, S: int, ordering="amd", tol: float = 1.0,
                 max_interface: int = 8192):
        if a.m != a.n:
            raise ValueError("SchurLU expects a square matrix")
        n = a.n
        self.n, self.S = n, S
        mloc = -(-n // S)
        ip, ix, dt = a.np_arrays()
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        rows = np.asarray(ix).astype(np.int64)

        shard_of = np.minimum(np.arange(n) // mloc, S - 1)
        cross = shard_of[rows] != shard_of[cols]
        is_gamma = np.zeros(n, dtype=bool)
        is_gamma[rows[cross]] = True
        is_gamma[cols[cross]] = True
        self.gamma = np.flatnonzero(is_gamma)
        ng = len(self.gamma)
        if ng > max_interface:
            raise ValueError(
                f"interface has {ng} rows (> {max_interface}); order the "
                "matrix for locality (rcm/nd) or use fewer/larger shards"
            )
        if ng == 0:
            raise ValueError(
                "no cross-shard entries; use per-shard splu directly"
            )

        A = sp.csc_matrix((dt, ix, ip), shape=a.shape)
        Ar = A.tocsr()

        def sub(rows, cols):
            # A[np.ix_(rows, cols)] as rows then columns: the same matrix,
            # without scipy's sampling of every (row, col) pair
            return Ar[rows][:, cols]

        self.interiors: List[np.ndarray] = [
            np.flatnonzero(~is_gamma[np.arange(s * mloc,
                                               min((s + 1) * mloc, n))])
            + s * mloc
            for s in range(S)
        ]
        self.mi = max(max((len(i) for i in self.interiors), default=1), 1)
        mi = self.mi
        self._lus = []
        self._W = []
        self._Wcols = []
        self._F = []
        Sc = np.asarray(sub(self.gamma, self.gamma).todense())
        for s in range(S):
            I = self.interiors[s]
            li = len(I)
            Ass = sub(I, I).tocsc()
            if li < mi:  # identity pad to the common local size
                Ass = sp.block_diag(
                    [Ass, sp.eye(mi - li, dtype=dt.dtype, format="csc")]
                ).tocsc()
            # each interior couples only to its boundary's interface
            # columns: E and W are restricted to those
            Eg = sub(I, self.gamma).tocsc()
            lcols = np.flatnonzero(np.diff(Eg.indptr))
            nl = max(len(lcols), 1)
            E = np.zeros((mi, nl), dtype=dt.dtype)
            if len(lcols):
                E[:li] = np.asarray(Eg[:, lcols].todense())
            F = sub(self.gamma, I).tocsc()  # cols are local [0, li)
            lu = splu(CSC.from_scipy(Ass, device="cpu"), ordering=ordering,
                      tol=tol)
            W = np.asarray(lu.solve_host(E))
            if len(lcols):
                Sc[:, lcols] -= F @ W[:li]
            self._lus.append(lu)
            self._W.append(W)
            self._Wcols.append(lcols if len(lcols)
                               else np.zeros(1, dtype=np.int64))
            self._F.append(F)

        self._gamma_lu = splu(dense_to_csc(Sc, device="cpu"),
                              ordering="natural", tol=tol)
        self.n_interface = ng

    @property
    def fill(self) -> int:
        return (sum(lu.lnz + lu.unz for lu in self._lus)
                + self._gamma_lu.lnz + self._gamma_lu.unz)

    @property
    def is_singular(self) -> bool:
        return (any(lu.is_singular for lu in self._lus)
                or self._gamma_lu.is_singular)

    # -- host solve (oracle) ------------------------------------------------
    def solve_host(self, b):
        b = np.asarray(b)
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        B = bb.shape[1]
        dt = np.result_type(bb.dtype, self._W[0].dtype)
        bb = bb.astype(dt, copy=False)
        x = np.zeros_like(bb)
        g = bb[self.gamma].copy()
        ys = []
        for s in range(self.S):
            I = self.interiors[s]
            rhs = np.zeros((self.mi, B), dtype=bb.dtype)
            rhs[: len(I)] = bb[I]
            y = np.asarray(self._lus[s].solve_host(rhs))
            ys.append(y)
            g -= self._F[s] @ y[: len(I)]
        xg = np.asarray(self._gamma_lu.solve_host(g))
        x[self.gamma] = xg
        for s in range(self.S):
            I = self.interiors[s]
            x[I] = (ys[s] - self._W[s] @ xg[self._Wcols[s]])[: len(I)]
        return x[:, 0] if squeeze else x

    def device_plan(self, device=None) -> "SchurSolvePlan":
        """The device solve; ``solve`` runs on ``device`` (None:
        ``config.default_device()``), ``dist_solve`` on a mesh."""
        return SchurSolvePlan(self, device=device)


class SchurSolvePlan:
    """Device Schur solve: ``solve(b)`` on one device, ``dist_solve(b,
    mesh, axis)`` with shard s on mesh position s and the interface
    right-hand side summed over the positions by ``psum``.  The pieces of
    each shard (its interior plan, W_s, its F entries, its interior ids)
    are placed on a device at the first solve there and kept."""

    def __init__(self, host: SchurLU, device=None):
        self.n, self.S, self.mi, self.ng = (host.n, host.S, host.mi,
                                            host.n_interface)
        self._host = host
        self._device = device
        self._dtype = torch.from_numpy(host._W[0][:0].copy()).dtype
        self._placed = {}

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _shard(self, s, dev):
        """Shard s's (plan, W, wcols, f_rows, f_cols, f_vals, interior
        ids) on ``dev``."""
        key = (s, dev)
        if key not in self._placed:
            h = self._host
            fe = h._F[s].tocoo()

            def t(a, dtype=None):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=dev)

            i64 = torch.int64
            self._placed[key] = (
                h._lus[s].solve_plan("level", device=dev), t(h._W[s]),
                t(h._Wcols[s], i64), t(fe.row, i64), t(fe.col, i64),
                t(fe.data), t(h.interiors[s], i64))
        return self._placed[key]

    def _gamma(self, dev):
        """(the Γ solve plan, the interface ids) on ``dev``."""
        key = ("gamma", dev)
        if key not in self._placed:
            h = self._host
            self._placed[key] = (
                h._gamma_lu.solve_plan(device=dev),
                torch.as_tensor(h.gamma, dtype=torch.int64, device=dev))
        return self._placed[key]

    def _interior(self, s, dev, bb, dt):
        """y_s and the shard's scatter -F_s y_s into the (ng, B)
        interface right-hand side."""
        plan, W, wc, fr, fc, fv, gat = self._shard(s, dev)
        rhs = bb.new_zeros((self.mi, bb.shape[1]), dtype=dt)
        rhs[: len(gat)] = bb[gat]
        y = plan(rhs)
        contrib = fv[:, None] * y[fc]
        return y, contrib, fr

    def _back(self, s, dev, y, xg):
        plan, W, wc, fr, fc, fv, gat = self._shard(s, dev)
        with _matmul_precision("highest"):
            return (y - W.to(xg.dtype) @ xg[wc])[: len(gat)], gat

    # -- single device -------------------------------------------------------
    def solve(self, b):
        """x = A^{-1} b on the plan's device, b (n,) or (n, B).
        Differentiable in b (``_SchurSolve``) when it requires a gradient;
        any other call runs under inference mode."""
        if _wants_grad(b):
            return _SchurSolve.apply(self, b, None)
        with torch.inference_mode():
            return self._solve(b)

    def _solve(self, b):
        dev = self.device
        b = torch.as_tensor(b, device=dev)
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        B = bb.shape[1]
        dt = torch.promote_types(bb.dtype, self._dtype)
        gplan, gamma = self._gamma(dev)
        g = bb[gamma].to(dt)
        ys = []
        for s in range(self.S):
            y, contrib, fr = self._interior(s, dev, bb, dt)
            ys.append(y)
            g = (torch.cat([g, g.new_zeros((1, B))])
                 .index_add_(0, fr, -contrib)[: self.ng])
        xg = gplan(g)
        x = bb.new_zeros((self.n, B), dtype=dt)
        x[gamma] = xg
        for s in range(self.S):
            xi, gat = self._back(s, dev, ys[s], xg)
            x[gat] = xi
        return x[:, 0] if squeeze else x

    def __call__(self, b):
        return self.solve(b)

    # -- over a mesh ---------------------------------------------------------
    def dist_solve(self, b, mesh, axis: str = "shards"):
        """Interior solve and F scatter per position, the interface
        right-hand side ``psum``-reduced, the Γ solve once per distinct
        device, back-substitution per position.  Returns x on the mesh's
        first device.  Differentiable in b as ``solve``: the backward is
        the transposed solve over the same mesh."""
        mesh.check_axis(axis)
        if mesh.shape[axis] != self.S:
            raise ValueError(
                f"mesh axis {axis!r} has {mesh.shape[axis]} devices but the "
                f"plan was built for S={self.S} shards"
            )
        if _wants_grad(b):
            return _SchurSolve.apply(self, b, mesh)
        with torch.inference_mode():
            return self._dist_solve(b, mesh)

    def _dist_solve(self, b, mesh):
        dev0 = mesh.devices[0]
        b = torch.as_tensor(b, device=dev0)
        squeeze = b.ndim == 1
        bfull = replicate(b[:, None] if squeeze else b, mesh.devices)
        B = bfull[dev0].shape[1]
        dt = torch.promote_types(b.dtype, self._dtype)
        ys, parts = [], []
        for s, dev in enumerate(mesh.devices):
            y, contrib, fr = self._interior(s, dev, bfull[dev], dt)
            ys.append(y)
            parts.append(y.new_zeros((self.ng + 1, B))
                         .index_add_(0, fr, -contrib)[: self.ng])
        gsum = {p.device: p for p in psum(parts)}
        xgs = {}
        for dev in mesh.distinct:
            gplan, gamma = self._gamma(dev)
            xgs[dev] = gplan(gsum[dev] + bfull[dev][gamma].to(dt))
        x = bfull[dev0].new_zeros((self.n, B), dtype=dt)
        x[self._gamma(dev0)[1]] = xgs[dev0]
        for s, dev in enumerate(mesh.devices):
            xi, gat = self._back(s, dev, ys[s], xgs[dev])
            x[gat.to(dev0)] = xi.to(dev0)
        return x[:, 0] if squeeze else x

    # -- the transposed solve (the backward) ---------------------------------
    def _solve_adjoint(self, g, devices):
        """x = A^{-T} g (plain transpose), shard s on ``devices[s]``, the
        result on ``devices[0]``.  A = [[A_I, 0], [F, Sc]] [[I, W], [0, I]]
        in the interiors-then-Γ order, so A^{-T} g is: h_Γ = g_Γ - Σ_s
        W_s^T g_s (``psum``), x_Γ = Sc^{-T} h_Γ, x_s = A_s^{-T} (g_s -
        F_s^T x_Γ), through the adjoint plans of the same interior and Γ
        factors."""
        dev0 = devices[0]
        squeeze = g.ndim == 1
        gfull = replicate(g[:, None] if squeeze else g, devices)
        B = gfull[dev0].shape[1]
        gis, parts = [], []
        for s, dev in enumerate(devices):
            _, W, wc, _, _, _, gat = self._shard(s, dev)
            gi = gfull[dev].new_zeros((self.mi, B))
            gi[: len(gat)] = gfull[dev][gat]
            gis.append(gi)
            with _matmul_precision("highest"):
                parts.append(gi.new_zeros((self.ng, B))
                             .index_add_(0, wc, -(W.to(gi.dtype).mT @ gi)))
        hsum = {p.device: p for p in psum(parts)}
        xgs = {}
        for dev in dict.fromkeys(devices):
            gplan, gamma = self._gamma(dev)
            xgs[dev] = gplan.adjoint()(hsum[dev] + gfull[dev][gamma])
        x = torch.zeros_like(gfull[dev0])
        x[self._gamma(dev0)[1]] = xgs[dev0]
        for s, dev in enumerate(devices):
            plan, _, _, fr, fc, fv, gat = self._shard(s, dev)
            rhs = gis[s].index_add(0, fc, -(fv[:, None] * xgs[dev][fr]))
            x[gat.to(dev0)] = plan.adjoint()(rhs)[: len(gat)].to(dev0)
        return x[:, 0] if squeeze else x


class _SchurSolve(torch.autograd.Function):
    """x = A^{-1} b through a ``SchurSolvePlan`` (``mesh`` None: its
    single-device ``solve``, else ``dist_solve`` over the mesh),
    differentiable in b: dL/db = A^{-H} g, the transposed Schur solve of
    conj(g) through the same interior plans, W_s and Γ factors,
    conjugated back, over the same devices."""

    @staticmethod
    def forward(ctx, plan, b, mesh):
        with torch.inference_mode():
            x = plan._solve(b) if mesh is None else plan._dist_solve(b, mesh)
        ctx.plan, ctx.b_dtype, ctx.b_device = plan, b.dtype, b.device
        ctx.devices = ([plan.device] * plan.S if mesh is None
                       else list(mesh.devices))
        # a copy made outside inference mode: autograd can return it
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        with torch.inference_mode():
            lam = ctx.plan._solve_adjoint(g.conj().to(ctx.devices[0]),
                                          ctx.devices).conj()
        return (None, _cast_grad(lam.clone(), ctx.b_dtype).to(ctx.b_device),
                None)
