"""Distributed banded direct solve: the SPIKE algorithm over a mesh.

The JAX package's ``csparse3_tpu/parallel/banded.py``, ported.  Each mesh
position owns a contiguous chunk of m block rows of an RCM-ordered banded
system, factors its block-tridiagonal piece with the block-Thomas
recurrence (``linalg/banded.py``), and the chunks couple only through one
(s, s) block per interface.  With D = blockdiag(T_0 .. T_{P-1}) and the
spikes V_p = T_p^{-1} [0..0, C_p], W_p = T_p^{-1} [B_p, 0..0], the first
and last block rows of S x = D^{-1} b give a reduced block-tridiagonal
system in the interface unknowns z_p = [x_p^b ; x_{p+1}^t] (P - 1 blocks of
2s), factored once.

Solve:
  1. local sweeps               g_p = T_p^{-1} b_p           per position
  2. all_gather of the boundary blocks g_p^t, g_p^b
  3. reduced solve              z = R^{-1} r                 once per device
  4. spike correction           x_p = g_p - W_p x_{p-1}^b - V_p x_{p+1}^t

Two ways to build one:

* ``DistBandedLU(a, mesh, ...)`` factors on the host (float64 math, in
  ``dtype``, by default the values' dtype) and keeps the explicit spikes;
  ``solve_host`` is its numpy twin.  The stacks upload to the positions at
  the first device solve.
* ``DistBandedLU.factor_device(a, mesh, ...)`` factors on the devices
  (float32 by default).  Each position assembles its (m, s, s) stacks on
  its device from its entry streams (one ``index_add_`` a stack), factors
  them, computes its four (s, s) spike tips and frees the assembled
  stacks before the next position.  The solve recomputes the spikes'
  action as a second local sweep of the boundary coupling (no spike
  storage).  Symmetric input takes the E-free forms; a complex matrix is
  factored through the real interleaved embedding
  (``ops.construct.real_equivalent``).  The reduced solve is split over
  the right-hand-side columns when B is a multiple of P.

Products run with TF32 off (the JAX package asks for 'highest').

Deviations from the JAX package, by design:

* ``factor_device`` assembles each position's stacks on its device; the
  JAX package assembles all (nb, s, s) stacks on the host with
  ``np.add.at`` (10 GB at 1M buses) and donates them to its factor;
* ``reduced_store='auto'`` means 'replicated' (held once per distinct
  device): the JAX package picks 'sharded' on its CPU backend;
* ``__init__``'s ``dtype=None`` is the values' dtype whatever the
  backend, as the port's ``BandedLU``;
* ``solve_host`` works at P = 1 (one chunk, no reduced system); the JAX
  package's sweeps an empty reduced system there and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg.banded import (
    _downcast,
    _matmul_precision,
    _np_dtype,
    _sweeps_host,
    _thomas_factor,
    is_symmetric_csc,
    spike_tips_device,
    thomas_factor_device,
    thomas_factor_device_sym,
    thomas_sweeps,
    thomas_sweeps_adjoint,
    thomas_sweeps_sym,
)
from ..ops.matvec import _cast_grad, _wants_grad
from .mesh import Mesh, all_gather, replicate

__all__ = ["DistBandedLU"]


class _SpikeSolve(torch.autograd.Function):
    """The per-position block solutions of ``DistBandedLU.solve_blocks``,
    differentiable in the right-hand sides: with g_p = dL/dx_p,
    dL/dbb_p = (A^{-H} g)_p by ``_solve_adjoint`` on conj(g), conjugated
    back, through the kept factors and spikes."""

    @staticmethod
    def forward(ctx, lu, *bbs):
        with torch.inference_mode():
            xs = lu._solve(list(bbs))
        ctx.lu, ctx.dtypes = lu, [b.dtype for b in bbs]
        # copies made outside inference mode: autograd can return them
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        with torch.inference_mode():
            lam = ctx.lu._solve_adjoint([g.conj() for g in gs])
        return (None, *(_cast_grad(x.conj().clone(), dt)
                        for x, dt in zip(lam, ctx.dtypes)))


REDUCED_STORES = ("auto", "replicated", "sharded")


def _thomas_factor_stacks(D, E, F, dtype):
    """Block-Thomas factor of explicitly dense (nb, s, s) stacks (host; the
    small reduced interface system)."""
    nb = D.shape[0]
    ehat = np.zeros((nb,) + D.shape[1:], dtype=dtype)
    sinv = np.empty_like(ehat)
    uhat = np.empty_like(ehat)
    Sinv_prev = None
    for k in range(nb):
        if k:
            Eh = E[k] @ Sinv_prev
            S = D[k] - Eh @ F[k - 1]
            ehat[k] = _downcast(Eh, dtype)
        else:
            S = D[0].copy()
        Sinv = np.linalg.inv(S)
        sinv[k] = _downcast(Sinv, dtype)
        uhat[k] = _downcast(Sinv @ F[k], dtype)
        Sinv_prev = Sinv
    return ehat, sinv, uhat


def _chunk_geometry(a, mesh, ordering, s):
    """Shared symbolic prologue of both constructors: mesh checks,
    ordering, permuted-coordinate entry streams, bandwidth, block size and
    chunk geometry.  Returns (mesh, axis, Pn, n, perm, r, c, bw, s, m,
    nb)."""
    from ..linalg import ordering as ordering_mod

    if mesh is None:
        mesh = Mesh()
    if len(mesh.axis_names) != 1:
        raise ValueError("DistBandedLU needs a 1-axis mesh")
    axis = mesh.axis_names[0]
    Pn = mesh.size
    n, mm = a.shape
    if n != mm:
        raise ValueError(f"requires a square matrix, got {a.shape}")
    if ordering is None:
        ordering = "natural"
    perm = np.asarray(ordering_mod.get_ordering(ordering, a))
    pinv = np.empty(n, dtype=np.int64)
    pinv[perm] = np.arange(n, dtype=np.int64)
    Ap, Ai, _ = a.np_arrays()
    cols = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(np.asarray(Ap)))
    r = pinv[np.asarray(Ai, dtype=np.int64)]
    c = pinv[cols]
    bw = int(np.abs(r - c).max()) if len(c) else 0
    if s is None:
        q = 128 if bw >= 96 else 8
        s = max(8, -(-max(bw, 1) // q) * q)
    if s < bw:
        raise ValueError(f"block size {s} < matrix bandwidth {bw}")
    m = -(-(-(-n // s)) // Pn)        # blocks per chunk
    nb = m * Pn
    if m < 2:
        raise ValueError(
            f"chunks need >= 2 blocks (n={n}, s={s}, P={Pn}); "
            "use fewer devices or the single-chip BandedLU")
    if (np.abs(r // s - c // s) > 1).any():
        raise ValueError(f"bandwidth exceeds block size {s}")
    return mesh, axis, Pn, n, perm, r, c, bw, s, m, nb


class DistBandedLU:
    """SPIKE-partitioned block-tridiagonal factorization over a mesh.

    Parameters
    ----------
    a : CSC (square, banded after ``ordering``)
    mesh : ``parallel.Mesh`` (None: every visible CUDA device), P = its size
    ordering : 'rcm' (default), None/'natural', a permutation array, or a
        callable; must make ``a`` banded
    s : block size (default: bandwidth rounded up lane-friendly)
    dtype : factor dtype (default: the values' dtype)

    ``__call__(b)`` takes and returns host numpy, (n,) or (n, B)."""

    def __init__(self, a, mesh: Mesh | None = None, ordering="rcm",
                 s: int | None = None, dtype=None):
        from ..ops.slicing import submatrix

        (mesh, axis, Pn, n, perm, _, _, bw, s, m,
         nb) = _chunk_geometry(a, mesh, ordering, s)
        # the host factor reads the PERMUTED canonical CSC (its symmetry
        # check and per-chunk streams)
        ap = a if np.array_equal(perm, np.arange(n)) else submatrix(
            a, perm, perm)
        Ap, Ai, Ax = ap.np_arrays()
        dtype = np.asarray(Ax).dtype if dtype is None else _np_dtype(dtype)
        wide = np.complex128 if np.iscomplexobj(Ax) else np.float64

        cols = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(np.asarray(Ap)))
        rows = np.asarray(Ai).astype(np.int64)
        vals = np.asarray(Ax)
        kb_r, kb_c = rows // s, cols // s
        ch_r, ch_c = kb_r // m, kb_c // m

        ehat = np.empty((nb, s, s), dtype=dtype)
        sinv = np.empty((nb, s, s), dtype=dtype)
        uhat = np.empty((nb, s, s), dtype=dtype)
        Wsp = np.zeros((Pn, m * s, s), dtype=dtype)   # left spikes
        Vsp = np.zeros((Pn, m * s, s), dtype=dtype)   # right spikes
        # reduced interface blocks collected per chunk
        Wt = np.zeros((Pn, s, s), dtype=wide)
        Wb = np.zeros((Pn, s, s), dtype=wide)
        Vt = np.zeros((Pn, s, s), dtype=wide)
        Vb = np.zeros((Pn, s, s), dtype=wide)

        interior = ch_r == ch_c
        # chunk-diagonal blocks of a symmetric matrix are symmetric: the
        # per-chunk Thomas factors can take the symmetric fast path
        sym = is_symmetric_csc(n, Ap, Ai, Ax) if ap.canonical else False
        for p in range(Pn):
            sel = interior & (ch_c == p)
            r_l = rows[sel] - p * m * s
            c_l = cols[sel] - p * m * s
            n_loc = max(min(n - p * m * s, m * s), 0)
            eh, si, uh = _thomas_factor(
                n_loc, s, m, r_l, c_l, vals[sel], dtype, wide, sym=sym)
            ehat[p * m:(p + 1) * m] = eh
            sinv[p * m:(p + 1) * m] = si
            uhat[p * m:(p + 1) * m] = uh
            # coupling blocks to the neighbours
            rhs = np.zeros((m, s, s), dtype=wide)
            if p > 0:
                selB = (kb_r == p * m) & (kb_c == p * m - 1)
                Bp = np.zeros((s, s), dtype=wide)
                Bp[rows[selB] % s, cols[selB] % s] = vals[selB]
                rhs[0] = Bp
                W = _sweeps_host(eh, si, uh, rhs)       # (m, s, s)
                Wsp[p] = W.reshape(m * s, s).astype(dtype)
                Wt[p], Wb[p] = W[0], W[-1]
            if p < Pn - 1:
                selC = (kb_r == (p + 1) * m - 1) & (kb_c == (p + 1) * m)
                Cp = np.zeros((s, s), dtype=wide)
                Cp[rows[selC] % s, cols[selC] % s] = vals[selC]
                rhs[:] = 0.0
                rhs[-1] = Cp
                V = _sweeps_host(eh, si, uh, rhs)
                Vsp[p] = V.reshape(m * s, s).astype(dtype)
                Vt[p], Vb[p] = V[0], V[-1]

        # reduced system over z_p = [x_p^b ; x_{p+1}^t], p = 0..P-2:
        #   diag  [[I,       V_p^b ], [W_{p+1}^t, I]]
        #   sub   [[W_p^b, 0], [0, 0]]
        #   super [[0, 0], [0, V_{p+1}^t]]
        eye = np.eye(s, dtype=wide)
        nR = Pn - 1
        Dr = np.zeros((nR, 2 * s, 2 * s), dtype=wide)
        Er = np.zeros((nR, 2 * s, 2 * s), dtype=wide)
        Fr = np.zeros((nR, 2 * s, 2 * s), dtype=wide)
        for p in range(nR):
            Dr[p, :s, :s] = eye
            Dr[p, :s, s:] = Vb[p]
            Dr[p, s:, :s] = Wt[p + 1]
            Dr[p, s:, s:] = eye
            if p > 0:
                Er[p, :s, :s] = Wb[p]
            if p < nR - 1:
                Fr[p, s:, s:] = Vt[p + 1]
        r_eh, r_si, r_uh = _thomas_factor_stacks(Dr, Er, Fr, dtype)
        self._set(mesh, axis, n, s, bw, m, perm,
                  (ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh))

    def _set(self, mesh, axis, n, s, bw, m, perm, host):
        self.mesh, self.axis = mesh, axis
        self.n, self.s, self.bw, self.m, self.P = n, s, bw, m, mesh.size
        self.perm = perm
        #: host (ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh), or None for
        #: an object factored on the devices
        self._h = host
        self.dtype = None if host is None else host[1].dtype
        #: per position (ehat, sinv, uhat, w, v) of the host factor, or
        #: (ehat | None, sinv, uhat, Bc, Cc) of the device factor
        self._pos = None
        #: the reduced factor stacks: {device: (r_eh, r_si, r_uh)}
        #: replicated, or per position (1, 2s, 2s) slices when sharded
        self._red = None
        self._r_sharded = False
        self._sym = False
        self._cplx_perm = self._cplx_n = None

    @classmethod
    def _from_host(cls, host, perm, n, s, bw, m, mesh):
        """An object from host factor state (``utils.interop``)."""
        obj = object.__new__(cls)
        obj._set(mesh, mesh.axis_names[0], n, s, bw, m,
                 np.asarray(perm, dtype=np.int64),
                 tuple(np.asarray(h) for h in host))
        return obj

    # -- device state ---------------------------------------------------------
    def _device_stacks(self):
        """The host factor on the positions (uploaded at the first call)."""
        if self._pos is None:
            ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh = self._h
            m = self.m

            def t(a, dev):
                return torch.as_tensor(np.ascontiguousarray(a), device=dev)

            self._pos = [
                tuple(t(h[p * m:(p + 1) * m], dev) for h in (ehat, sinv,
                                                             uhat))
                + (t(Wsp[p], dev), t(Vsp[p], dev))
                for p, dev in enumerate(self.mesh.devices)]
            self._red = {dev: tuple(t(h, dev) for h in (r_eh, r_si, r_uh))
                         for dev in self.mesh.distinct}
        return self._pos

    def _reduced(self, dev):
        """(r_eh, r_si, r_uh) on ``dev``: the replicated stacks, or the
        sharded slices gathered for this solve."""
        if not self._r_sharded:
            return self._red[dev]
        nR = self.P - 1
        return tuple(torch.cat([sl[i].to(dev) for sl in self._red])[:nR]
                     for i in range(3))

    # -- device solve --------------------------------------------------------
    def _boundary_rhs(self, gs):
        """The reduced right-hand side r = [g_p^b ; g_{p+1}^t] (P - 1, 2s,
        B), once per distinct device, from an all_gather of the
        boundary blocks."""
        allg = all_gather([torch.stack([g[0], g[-1]]) for g in gs])
        return {a.device: torch.cat([a[:-1, 1], a[1:, 0]], dim=1)
                for a in allg}

    def _neighbours(self, z, p, like):
        """(x_{p-1}^b, x_{p+1}^t) from the reduced solution, zero at the
        ends."""
        s = self.s
        zero = torch.zeros_like(like)
        return (z[p - 1, :s] if p > 0 else zero,
                z[p, s:] if p < self.P - 1 else zero)

    def _solve_spikes(self, bbs):
        """Solve of a host-factored object: sweeps, reduced solve, the
        explicit spikes' correction."""
        pos = self._device_stacks()
        m, s = self.m, self.s
        gs = [thomas_sweeps(eh, si, uh, bb)
              for (eh, si, uh, _, _), bb in zip(pos, bbs)]
        if self.P == 1:
            return gs
        z = {dev: thomas_sweeps(*self._reduced(dev), r)
             for dev, r in self._boundary_rhs(gs).items()}
        out = []
        for p, ((_, _, _, w, v), g) in enumerate(zip(pos, gs)):
            x_prev_b, x_next_t = self._neighbours(z[g.device], p, g[0])
            with _matmul_precision("highest"):
                dt = g.dtype
                corr = w.to(dt) @ x_prev_b + v.to(dt) @ x_next_t  # (m s, B)
            out.append((g.reshape(m * s, -1) - corr).reshape(m, s, -1))
        return out

    def _solve_recompute(self, bbs):
        """Solve of a device-factored object: no stored spikes; after the
        reduced solve the spike correction is a second local sweep of the
        boundary coupling."""
        m, s, Pn = self.m, self.s, self.P

        def sweep(fac, rhs):
            eh, si, uh = fac[:3]
            if eh is None:
                return thomas_sweeps_sym(si, uh, rhs)
            return thomas_sweeps(eh, si, uh, rhs)

        gs = [sweep(fac, bb) for fac, bb in zip(self._pos, bbs)]
        if Pn == 1:
            return gs
        rs = self._boundary_rhs(gs)
        nR = Pn - 1
        nB = gs[0].shape[-1]
        if nB % Pn == 0 and nB >= Pn:
            # the reduced solve split over right-hand-side columns: position
            # p solves columns [p bloc, (p + 1) bloc)
            bloc = nB // Pn
            red = {dev: self._reduced(dev) for dev in rs}
            zs = [thomas_sweeps(*red[g.device],
                                rs[g.device][..., p * bloc:(p + 1) * bloc])
                  for p, g in enumerate(gs)]
            z = {zg.device: zg.movedim(0, 2).reshape(nR, 2 * s, nB)
                 for zg in all_gather(zs)}
        else:
            z = {dev: thomas_sweeps(*self._reduced(dev), r)
                 for dev, r in rs.items()}
        out = []
        for p, (fac, g) in enumerate(zip(self._pos, gs)):
            Bc, Cc = fac[3], fac[4]
            x_prev_b, x_next_t = self._neighbours(z[g.device], p, g[0])
            rhs2 = torch.zeros_like(g)
            with _matmul_precision("highest"):
                torch.mm(Bc.to(g.dtype), x_prev_b, out=rhs2[0])
                rhs2[m - 1].addmm_(Cc.to(g.dtype), x_next_t)
            out.append(g - sweep(fac, rhs2))
        return out

    def solve_blocks(self, bbs):
        """Solve in block space: one (m, s, B) tensor per position ->
        the same.  Differentiable in ``bbs`` (``_SpikeSolve``, the adjoint
        SPIKE solve) when one requires a gradient; any other call runs
        under inference mode."""
        if _wants_grad(*bbs):
            return list(_SpikeSolve.apply(self, *bbs))
        with torch.inference_mode():
            return self._solve(bbs)

    def _solve(self, bbs):
        if self._h is not None:
            return self._solve_spikes(bbs)
        return self._solve_recompute(bbs)

    def _local_adjoint(self, p, rhs):
        """T_p^{-T} rhs through position p's factors (a plain transpose)."""
        pos = self._device_stacks() if self._h is not None else self._pos
        return thomas_sweeps_adjoint(*pos[p][:3], rhs)

    def _solve_adjoint(self, gs):
        """x = A^{-T} g in block space, the transpose of each solve step in
        reverse order: the spike correction's transpose gathers into the
        reduced system's right-hand side (the explicit spikes' W_p^T, V_p^T
        products, or, for a device factor, a local adjoint sweep of g_p
        read at its first and last blocks through B_p^T, C_p^T), the
        reduced system solved transposed, its solution added at the chunk
        boundaries, then the local adjoint sweeps."""
        m, s, Pn = self.m, self.s, self.P
        if Pn > 1:
            parts = []
            for p, g in enumerate(gs):
                with _matmul_precision("highest"):
                    if self._h is not None:
                        _, _, _, w, v = self._device_stacks()[p]
                        gf = g.reshape(m * s, -1)
                        top = -(w.to(g.dtype).mT @ gf)
                        bot = -(v.to(g.dtype).mT @ gf)
                    else:
                        q = self._local_adjoint(p, g)
                        Bc, Cc = (c.to(q.dtype) for c in self._pos[p][3:])
                        top, bot = -(Bc.mT @ q[0]), -(Cc.mT @ q[m - 1])
                parts.append(torch.stack([top, bot]))
            # z_p = [x_p^b ; x_{p+1}^t]: position p + 1's top (its left
            # coupling) and position p's bottom (its right coupling)
            zbar = {a.device: torch.cat([a[1:, 0], a[:-1, 1]], dim=1)
                    for a in all_gather(parts)}
            rbar = {dev: thomas_sweeps_adjoint(*self._reduced(dev), zb)
                    for dev, zb in zbar.items()}
            gs = [g.clone() for g in gs]
            for p, g in enumerate(gs):
                r = rbar[g.device]
                if p < Pn - 1:
                    g[m - 1] += r[p, :s]
                if p > 0:
                    g[0] += r[p - 1, s:]
        return [self._local_adjoint(p, g) for p, g in enumerate(gs)]

    @torch.inference_mode()
    def blocks(self, b):
        """Permute and pad an (n,) / (n, B) host right-hand side into one
        (m, s, B) tensor per position, on its device."""
        b = np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        nbs = self.m * self.P * self.s
        bp = np.zeros((nbs, b.shape[1]), dtype=self.dtype)
        bp[: self.n] = b[self.perm]
        bb = bp.reshape(self.P, self.m, self.s, -1)
        return [torch.as_tensor(bb[p], device=dev)
                for p, dev in enumerate(self.mesh.devices)]

    def unblocks(self, xs):
        """Per-position (m, s, B) -> (n, B) host numpy, the inverse
        permutation applied."""
        xf = np.concatenate([x.cpu().numpy().reshape(-1, x.shape[-1])
                             for x in xs])[: self.n]
        out = np.empty_like(xf)
        out[self.perm] = xf
        return out

    def __call__(self, b):
        if self._cplx_n is not None:
            return self._solve_complex(b)
        squeeze = np.ndim(b) == 1
        x = self.unblocks(self.solve_blocks(self.blocks(b)))
        return x[:, 0] if squeeze else x

    def _solve_complex(self, b):
        """Complex right-hand side through the real interleaved embedding
        that ``factor_device`` factored for a complex matrix."""
        from ..ops.construct import complex_rhs_to_real, real_x_to_complex

        b2, squeeze = complex_rhs_to_real(b, self._cplx_perm)
        x2 = self.unblocks(self.solve_blocks(self.blocks(b2)))
        return real_x_to_complex(x2, self._cplx_perm, squeeze)

    def solve(self, b):
        """x = A^{-1} b: alias of ``__call__``."""
        return self(b)

    # -- device factorization ------------------------------------------------
    @classmethod
    @torch.inference_mode()
    def factor_device(cls, a, mesh: Mesh | None = None, ordering="rcm",
                      s: int | None = None, dtype=None,
                      reduced_store: str = "auto"):
        """SPIKE factorization with the numeric work on the positions'
        devices (see the module docstring): the host does the ordering and
        the index maps, each position assembles, factors and reduces its
        chunk, the reduced interface system is factored on the first
        device (``spike_reduced_factor``) and stored per
        ``reduced_store``: 'replicated' (once per distinct device; also
        'auto') or 'sharded' (one block a position, gathered for each
        solve).  ``dtype`` defaults to float32."""
        from ..linalg.spike_stream import spike_reduced_factor

        if reduced_store not in REDUCED_STORES:
            raise ValueError(f"unknown reduced_store {reduced_store!r}; "
                             f"have {REDUCED_STORES}")
        if np.iscomplexobj(np.asarray(a.np_arrays()[2])):
            # order the COMPLEX matrix (the interleaving maps bw to
            # 2 bw + 1), then factor the real 2n-system
            from ..linalg import ordering as ordering_mod
            from ..ops.construct import (complex_embed_block_size,
                                         real_equivalent)
            from ..ops.slicing import submatrix

            perm_c = np.asarray(ordering_mod.get_ordering(
                "natural" if ordering is None else ordering, a))
            ap = (a if np.array_equal(perm_c, np.arange(a.n))
                  else submatrix(a, perm_c, perm_c))
            dk = cls.factor_device(
                real_equivalent(ap), mesh=mesh, ordering=None,
                s=complex_embed_block_size(s), dtype=dtype,
                reduced_store=reduced_store)
            dk._cplx_perm = perm_c
            dk._cplx_n = a.n
            return dk

        (mesh, axis, Pn, n, perm, r, c, bw, s, m,
         nb) = _chunk_geometry(a, mesh, ordering, s)
        Ap, Ai, Ax = a.np_arrays()
        dtype = np.dtype(np.float32) if dtype is None else _np_dtype(dtype)
        # symmetry is invariant under the symmetric permutation A[p, p]:
        # check the original canonical arrays
        sym = bool(a.canonical
                   and is_symmetric_csc(n, np.asarray(Ap), np.asarray(Ai),
                                        np.asarray(Ax)))
        vals = np.asarray(Ax, dtype=dtype)
        kb_r, kb_c = r // s, c // s
        d = kb_r - kb_c
        lr, lc = (r % s).astype(np.int64), (c % s).astype(np.int64)
        ch = kb_r // m                          # owning chunk (block row)
        loc = (kb_r - ch * m) * (s * s) + lr * s + lc
        m0 = d == 0
        fin = (d == -1) & ((kb_c % m) != 0)     # interior F (lives at kb_r)
        fout = (d == -1) & ((kb_c % m) == 0)    # C_p coupling blocks
        ein = (d == 1) & ((kb_r % m) != 0)      # interior E
        eout = (d == 1) & ((kb_r % m) == 0)     # B_p coupling blocks
        blk = lr * s + lc                       # within an (s, s) block
        # a unit diagonal on the padded tail rows, in the chunk owning
        # each one's block
        padr = np.arange(n, nb * s, dtype=np.int64)
        pch = (padr // s) // m
        ploc = (padr // s - pch * m) * (s * s) + (padr % s) * (s + 1)

        def assemble(idx, val, dev, shape):
            out = torch.zeros(int(np.prod(shape)),
                              dtype=torch.from_numpy(val[:0]).dtype,
                              device=dev)
            return out.index_add_(
                0, torch.as_tensor(idx, dtype=torch.int64, device=dev),
                torch.as_tensor(val, device=dev)).view(shape)

        pos, tips = [], []
        for p, dev in enumerate(mesh.devices):
            own = ch == p
            pads = pch == p
            sel = m0 & own
            D = assemble(np.concatenate([loc[sel], ploc[pads]]),
                         np.concatenate([vals[sel], np.ones(
                             int(pads.sum()), dtype=dtype)]),
                         dev, (m, s, s))
            F = assemble(loc[fin & own], vals[fin & own], dev, (m, s, s))
            Bc = assemble(blk[eout & own], vals[eout & own], dev, (s, s))
            Cc = assemble(blk[fout & own], vals[fout & own], dev, (s, s))
            if sym:
                si, uh = thomas_factor_device_sym(D, F)
                eh = None
            else:
                E = assemble(loc[ein & own], vals[ein & own], dev,
                             (m, s, s))
                eh, si, uh = thomas_factor_device(D, E, F)
                del E
            del D, F
            tips.append(torch.stack(spike_tips_device(si, uh, Bc, Cc,
                                                      ehat=eh)))
            pos.append((eh, si, uh, Bc, Cc))

        obj = object.__new__(cls)
        obj._set(mesh, axis, n, s, bw, m, perm, None)
        obj.dtype = dtype
        obj._pos = pos
        obj._sym = sym
        obj._r_sharded = reduced_store == "sharded"
        if Pn > 1:
            dev0 = mesh.devices[0]
            T = torch.stack([t.to(dev0) for t in tips])      # (P, 4, s, s)
            del tips
            red = spike_reduced_factor(T[:, 0], T[:, 1], T[:, 2], T[:, 3], s)
            del T
            if obj._r_sharded:
                # one block a position, padded to P blocks
                padded = [torch.cat([h, h.new_zeros((1,) + h.shape[1:])])
                          for h in red]
                obj._red = [tuple(h[p:p + 1].to(dev, copy=True)
                                  for h in padded)
                            for p, dev in enumerate(mesh.devices)]
            else:
                per = [replicate(h, mesh.devices) for h in red]
                obj._red = {dev: tuple(h[dev] for h in per)
                            for dev in mesh.distinct}
        return obj

    # -- host twin ------------------------------------------------------------
    def solve_host(self, b):
        """numpy replay of the SPIKE solve (for verification)."""
        if self._h is None:
            raise ValueError(
                "no host factor state: this object was built by "
                "factor_device (stacks live on the mesh devices) — use "
                "the host constructor DistBandedLU(a, ...) for a "
                "host-replayable twin")
        ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh = self._h
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        m, s, Pn = self.m, self.s, self.P
        dt = np.result_type(sinv.dtype, b.dtype)
        bp = np.zeros((m * Pn * s, b.shape[1]), dtype=dt)
        bp[: self.n] = b[self.perm]
        B = b.shape[1]
        g = np.empty((Pn, m, s, B), dtype=dt)
        for p in range(Pn):
            g[p] = _sweeps_host(ehat[p * m:(p + 1) * m],
                                sinv[p * m:(p + 1) * m],
                                uhat[p * m:(p + 1) * m],
                                bp.reshape(Pn, m, s, B)[p])
        if Pn > 1:
            r = np.concatenate([g[:-1, -1], g[1:, 0]], axis=1)  # (P-1, 2s, B)
            z = _sweeps_host(r_eh, r_si, r_uh, r)
        x = np.empty_like(g)
        for p in range(Pn):
            corr = np.zeros((m * s, B), dtype=dt)
            if p > 0:
                corr += Wsp[p] @ z[p - 1, :s]
            if p < Pn - 1:
                corr += Vsp[p] @ z[p, s:]
            x[p] = (g[p].reshape(m * s, B) - corr).reshape(m, s, B)
        xf = x.reshape(-1, B)[: self.n]
        out = np.empty_like(xf)
        out[self.perm] = xf
        return out[:, 0] if squeeze else out
