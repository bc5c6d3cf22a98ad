"""Streamed SPIKE: a banded factor and solve of one large system on one
card, chunk by chunk, as the JAX package's ``csparse3_tpu/linalg/
spike_stream.py``.

The block rows of the ordered matrix are cut into P chunks of m blocks of
s rows.  Each solve visits every chunk twice and keeps none of the chunk
factors between visits (chunk rematerialization):

  pass 1 (per chunk): assemble the chunk's (m, s, s) block-tridiagonal
      stacks on the device from its entry streams (one ``index_add_`` per
      stack), factor them (``thomas_factor_device(_sym)``), compute the
      four (s, s) spike tips (``spike_tips_device``; first solve only,
      then kept) and sweep the chunk's right-hand side: g_p.
  reduced: factor the (P - 1)-block interface system of the tips
      (``spike_reduced_factor``; first solve only, then kept) and solve it
      for the unknowns at the chunk boundaries.
  pass 2 (per chunk): assemble and factor the chunk again and sweep the
      boundary coupling: x_p = g_p - delta_p.

The device holds one chunk's stacks at a time (three to six (m, s, s)
stacks while it is factored) plus the tips, the reduced factor and the
swept right-hand sides.  Symmetric input takes the E-free forms, general
input the (D, E, F) forms; complex input is solved through the real
interleaved embedding (``ops.construct.real_equivalent``), as in the JAX
package.

The per-chunk programs of the JAX package (jitted) are plain functions
over the port's device recurrences here, each step one torch call.  The
entry streams of each chunk are kept as they are, not padded to a common
length.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.matvec import _wants_grad
from .banded import (_matmul_precision, _normal, _np_dtype, is_symmetric_csc,
                     spike_tips_device, thomas_factor_device,
                     thomas_factor_device_sym, thomas_sweeps,
                     thomas_sweeps_sym)

__all__ = ["StreamedSPIKE", "spike_reduced_factor"]


def spike_reduced_factor(Wt, Wb, Vt, Vb, s):
    """Block-Thomas factor of the SPIKE reduced system from the (P, s, s)
    tip stacks: its blocks D_p = [[I, Vb_p], [Wt_{p+1}, I]] couple by one
    quadrant, so each step costs one (s, s) inverse and a few (s, s)
    products in place of a (2s, 2s) inverse.  Returns the (P - 1, 2s, 2s)
    stacks (ehat, sinv, uhat) for ``thomas_sweeps``.

    Differentiable in the four tip stacks when one requires a gradient:
    autograd then records the same steps, their quadrants joined by
    ``torch.cat`` in place of writes into the stacks."""
    if _wants_grad(Wt, Wb, Vt, Vb):
        return _reduced_factor_taped(*_normal(Wt, Wb, Vt, Vb), s)
    with torch.inference_mode():
        return _reduced_factor(Wt, Wb, Vt, Vb, s)


def _reduced_step(k, Wt, Wb, Vt, Vb, S12p, eye):
    """One step's quadrants: (S11, S12, ZC, Z) of the Schur complement's
    inverse."""
    Bq, Cq = Vb[k], Wt[k + 1]
    if k:
        Bq = Bq - Wb[k] @ S12p @ Vt[k]
    Z = torch.linalg.inv_ex(eye - Cq @ Bq, check_errors=False)[0]
    ZC = Z @ Cq
    return torch.addmm(eye, Bq, ZC), -(Bq @ Z), ZC, Z


def _reduced_factor(Wt, Wb, Vt, Vb, s):
    nR = Wt.shape[0] - 1
    opts = dict(dtype=Wt.dtype, device=Wt.device)
    eye = torch.eye(s, **opts)
    r_eh = torch.zeros((nR, 2 * s, 2 * s), **opts)
    r_si = torch.empty((nR, 2 * s, 2 * s), **opts)
    r_uh = torch.zeros((nR, 2 * s, 2 * s), **opts)
    S11p = S12p = None
    with _matmul_precision("highest"):
        for k in range(nR):
            S11, S12, ZC, Z = _reduced_step(k, Wt, Wb, Vt, Vb, S12p, eye)
            r_si[k, :s, :s] = S11
            r_si[k, :s, s:] = S12
            r_si[k, s:, :s] = -ZC
            r_si[k, s:, s:] = Z
            if k:
                torch.mm(Wb[k], S11p, out=r_eh[k, :s, :s])
                torch.mm(Wb[k], S12p, out=r_eh[k, :s, s:])
            if k < nR - 1:
                torch.mm(S12, Vt[k + 1], out=r_uh[k, :s, s:])
                torch.mm(Z, Vt[k + 1], out=r_uh[k, s:, s:])
            S11p, S12p = S11, S12
    return r_eh, r_si, r_uh


def _reduced_factor_taped(Wt, Wb, Vt, Vb, s):
    nR = Wt.shape[0] - 1
    eye = torch.eye(s, dtype=Wt.dtype, device=Wt.device)
    zero = torch.zeros_like(eye)

    def block(q11, q12, q21, q22):
        return torch.cat([torch.cat([q11, q12], 1), torch.cat([q21, q22], 1)])

    r_eh, r_si, r_uh = [], [], []
    S11p = S12p = None
    with _matmul_precision("highest"):
        for k in range(nR):
            S11, S12, ZC, Z = _reduced_step(k, Wt, Wb, Vt, Vb, S12p, eye)
            r_si.append(block(S11, S12, -ZC, Z))
            r_eh.append(block(Wb[k] @ S11p, Wb[k] @ S12p, zero, zero) if k
                        else block(zero, zero, zero, zero))
            r_uh.append(block(zero, S12 @ Vt[k + 1], zero, Z @ Vt[k + 1])
                        if k < nR - 1 else block(zero, zero, zero, zero))
            S11p, S12p = S11, S12
    return torch.stack(r_eh), torch.stack(r_si), torch.stack(r_uh)


class StreamedSPIKE:
    """Single-card streamed SPIKE factor and solve of a square banded
    system (see the module docstring).

    ``P`` chunks (the memory knob: a chunk's transient stacks are ~3-6
    m s^2 values, m = ceil(ceil(n / s) / P)); ``ordering`` (None or
    'natural' keeps A's order); ``s`` the block size (default from the
    bandwidth, as ``BandedLU`` picks it); ``dtype`` of the device work;
    ``device`` (None: ``config.default_device()``, the CUDA card).
    ``solve(b)`` takes and returns host numpy, (n,) or (n, B)."""

    def __init__(self, a, P: int = 8, ordering="rcm", s: int | None = None,
                 dtype=np.float32, device=None):
        from . import ordering as ordering_mod

        n, mm = a.shape
        if n != mm:
            raise ValueError(f"requires a square matrix, got {a.shape}")
        self.device = resolve_device(device, a)
        Ap, Ai, Ax = a.np_arrays()
        perm = np.asarray(ordering_mod.get_ordering(
            "natural" if ordering is None else ordering, a))
        if np.iscomplexobj(np.asarray(Ax)):
            from ..ops.construct import (complex_embed_block_size,
                                         real_equivalent)
            from ..ops.slicing import submatrix

            ap = (a if np.array_equal(perm, np.arange(n))
                  else submatrix(a, perm, perm))
            self._inner = StreamedSPIKE(
                real_equivalent(ap), P=P, ordering=None,
                s=complex_embed_block_size(s), dtype=dtype,
                device=self.device)
            self._cplx_perm = perm
            self.n = n
            return
        self._inner = None
        self._cplx_perm = None
        sym = bool(a.canonical and is_symmetric_csc(
            n, np.asarray(Ap), np.asarray(Ai), np.asarray(Ax)))
        pinv = np.empty(n, dtype=np.int64)
        pinv[perm] = np.arange(n, dtype=np.int64)
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
        nblk = -(-n // s)
        m = -(-nblk // P)
        if m < 2:
            raise ValueError(
                f"chunks need >= 2 blocks (n={n}, s={s}, P={P})")
        if (np.abs(r // s - c // s) > 1).any():
            raise ValueError(f"bandwidth exceeds block size {s}")
        nb = m * P
        self.n, self.s, self.bw, self.m, self.P = n, s, bw, m, P
        self.perm = perm
        self.dtype = _np_dtype(dtype)
        self._sym = sym
        vals = np.asarray(Ax, dtype=self.dtype)
        kb_r, kb_c = r // s, c // s
        d = kb_r - kb_c
        lr, lc = (r % s).astype(np.int64), (c % s).astype(np.int64)
        ch = kb_r // m                         # owning chunk (by block row)

        # flat destinations within a chunk's (m, s, s) stack
        loc = (kb_r - ch * m) * (s * s) + lr * s + lc
        m0 = d == 0
        mF = (d == -1) & ((kb_c % m) != 0)     # interior F (lives at kb_r)
        fout = (d == -1) & ((kb_c % m) == 0)   # C_p coupling blocks
        mE = (d == 1) & ((kb_r % m) != 0)      # interior E (general form)
        eout = (d == 1) & ((kb_r % m) == 0)    # B_p coupling blocks

        idxD, valD, idxF, valF, idxE, valE = [], [], [], [], [], []
        for p in range(P):
            own = ch == p
            idxD.append(loc[m0 & own])
            valD.append(vals[m0 & own])
            idxF.append(loc[mF & own])
            valF.append(vals[mF & own])
            if not sym:
                idxE.append(loc[mE & own])
                valE.append(vals[mE & own])
        # a unit diagonal on the padded tail rows, each in the chunk that
        # owns its block (the pad blocks can span several trailing chunks)
        padr = np.arange(n, nb * s, dtype=np.int64)
        if len(padr):
            pk = padr // s
            pch = pk // m
            ploc = (pk - pch * m) * (s * s) + (padr % s) * (s + 1)
            for p in np.unique(pch):
                selp = pch == p
                idxD[p] = np.concatenate([idxD[p], ploc[selp]])
                valD[p] = np.concatenate(
                    [valD[p], np.ones(int(selp.sum()), dtype=self.dtype)])
        assert m * s * s < 2**31, "chunk stack exceeds int32 addressing"
        dev = self.device

        def upload(ix, vx):
            return [(torch.as_tensor(i, dtype=torch.int64, device=dev),
                     torch.as_tensor(v, device=dev)) for i, v in zip(ix, vx)]

        self._D = upload(idxD, valD)
        self._F = upload(idxF, valF)
        self._E = None if sym else upload(idxE, valE)

        # B_p / C_p: the (s, s) blocks coupling chunk p to its neighbours
        # (B_p = C_{p-1}^T for symmetric input)
        Cc = np.zeros((P, s, s), dtype=self.dtype)
        np.add.at(Cc, (kb_r[fout] // m, lr[fout], lc[fout]), vals[fout])
        self._C = torch.as_tensor(Cc, device=dev)
        self._B = None
        if not sym:
            Bcc = np.zeros((P, s, s), dtype=self.dtype)
            np.add.at(Bcc, (kb_r[eout] // m, lr[eout], lc[eout]),
                      vals[eout])
            self._B = torch.as_tensor(Bcc, device=dev)
        self._tips = None       # (P, 4, s, s) after the first pass 1
        self._red = None        # reduced factor stacks

    # -- one chunk ---------------------------------------------------------
    def _assemble(self, stream):
        idx, val = stream
        m, s = self.m, self.s
        out = torch.zeros(m * s * s, dtype=val.dtype, device=val.device)
        return out.index_add_(0, idx, val).view(m, s, s)

    def _factor(self, p):
        """The chunk's factor stacks: (sinv, uhat) symmetric, (ehat, sinv,
        uhat) general; the assembled stacks are freed on return."""
        if self._sym:
            return thomas_factor_device_sym(self._assemble(self._D[p]),
                                            self._assemble(self._F[p]))
        return thomas_factor_device(self._assemble(self._D[p]),
                                    self._assemble(self._E[p]),
                                    self._assemble(self._F[p]))

    def _sweep(self, fac, bb):
        if self._sym:
            return thomas_sweeps_sym(*fac, bb)
        return thomas_sweeps(*fac, bb)

    def _Bp(self, p):
        if p == 0:
            return self._C.new_zeros((self.s, self.s))
        if self._B is not None:
            return self._B[p]
        return self._C[p - 1].mT

    def _pass1(self, p, bb, tips):
        """Factor chunk p, append its tips to ``tips`` (when given) and
        return its locally swept right-hand side g_p."""
        fac = self._factor(p)
        if tips is not None:
            sinv, uhat = fac[-2], fac[-1]
            ehat = None if self._sym else fac[0]
            tips.append(torch.stack(spike_tips_device(
                sinv, uhat, self._Bp(p), self._C[p], ehat=ehat)))
        return self._sweep(fac, bb)

    def _pass2(self, p, g, x_prev_b, x_next_t):
        """Factor chunk p again and sweep the boundary coupling:
        g_p - delta_p."""
        fac = self._factor(p)
        rhs2 = torch.zeros_like(g)
        with _matmul_precision("highest"):
            torch.mm(self._Bp(p), x_prev_b, out=rhs2[0])
            rhs2[-1].addmm_(self._C[p], x_next_t)
        return g - self._sweep(fac, rhs2)

    # -- solve ---------------------------------------------------------------
    def _unpermute(self, xf, squeeze):
        res = np.empty_like(xf)
        res[self.perm] = xf
        return res[:, 0] if squeeze else res

    @torch.inference_mode()
    def solve(self, b):
        """x = A^{-1} b for host b (n,) or (n, B): two streamed passes over
        the chunks; host numpy out."""
        if self._inner is not None:
            from ..ops.construct import complex_rhs_to_real, real_x_to_complex

            b2, squeeze = complex_rhs_to_real(b, self._cplx_perm)
            return real_x_to_complex(self._inner.solve(b2), self._cplx_perm,
                                     squeeze)
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        n, s, m, Pn = self.n, self.s, self.m, self.P
        nbs = m * Pn * s
        bp = np.zeros((nbs, b.shape[1]), dtype=self.dtype)
        bp[:n] = b[self.perm]
        bb = torch.as_tensor(bp, device=self.device).view(Pn, m, s, -1)

        # ---- pass 1: the tips (first solve only) and the swept g_p ------
        tips = [] if self._tips is None and Pn > 1 else None
        gs = [self._pass1(p, bb[p], tips) for p in range(Pn)]
        if Pn == 1:
            # one chunk: no interfaces, g is the solution
            xf = gs[0].reshape(nbs, -1)[:n].cpu().numpy()
            return self._unpermute(xf, squeeze)
        if tips is not None:
            T = torch.stack(tips)                     # (P, 4, s, s)
            self._tips = T
            self._red = spike_reduced_factor(T[:, 0], T[:, 1], T[:, 2],
                                             T[:, 3], s)

        # ---- the reduced interface system ---------------------------------
        gts = torch.stack([g[0] for g in gs])         # (P, s, B)
        gbs = torch.stack([g[-1] for g in gs])
        r = torch.cat([gbs[:-1], gts[1:]], dim=1)     # (P - 1, 2s, B)
        z = thomas_sweeps(*self._red, r)
        xb, xt = z[:, :s], z[:, s:]
        zero = torch.zeros_like(gts[0])

        # ---- pass 2: refactor and correct at the boundaries ---------------
        out = torch.cat([
            self._pass2(p, gs[p], xb[p - 1] if p > 0 else zero,
                        xt[p] if p < Pn - 1 else zero).reshape(m * s, -1)
            for p in range(Pn)])
        return self._unpermute(out[:n].cpu().numpy(), squeeze)

    __call__ = solve
