"""Distributed Krylov solves over a mesh.

The JAX package's ``csparse3_tpu/parallel/solve.py``, ported:

* ``BlockJacobi`` — each position LU-factors its diagonal block on the
  host (``linalg.splu``) and applies it as the device solve plan on its
  device: an exact LU solve of the block-diagonal part of A.
* ``DiagJacobi`` — point Jacobi, one vector per position.
* ``dist_cg`` / ``dist_bicgstab`` — the preconditioned Krylov loops over
  per-position vectors: the matrix action is ``spmv_local`` (the halo
  ring or the all-gather), an inner product is the S partial dots summed
  by ``psum``, and a scalar is held once per distinct device.

The JAX package's ``lax.while_loop`` is a Python loop here, with one host
read of the stop test per iteration, as the port's single-device ``cg``.

Deviations from the JAX package, by design:

* the block plans are kept per position, each at its own size; the JAX
  package pads them to one stacked shape so that one SPMD program serves
  every shard.  So each plan may take its dense tail
  (``SparseLU.solve_plan('auto')``), which the
  stacked level-plan layout of the JAX package cannot: on the RCM-ordered
  B' + 3I at 100k buses, 8 blocks, its factors' 1,974 levels become 29,
  and the 8 block solves take 29.6 ms on an H100 against 1,753.6 ms for
  the level plans (``chip_smoke.py``'s parallel phase);
* ``DiagJacobi`` preconditions: the JAX package's ``_dist_solve`` passes
  only a ``BlockJacobi`` into its loop and drops a ``DiagJacobi``, which
  then leaves the iterations unpreconditioned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import construct
from ..types import CSC
from .mesh import psum
from .partition import RowPartition, _entry_streams_np
from .spmv import spmv_local

__all__ = ["BlockJacobi", "DiagJacobi", "dist_cg", "dist_bicgstab"]

_TINY = 1e-300


class BlockJacobi:
    """Per-position LU solves of the diagonal blocks: M^{-1} =
    diag(A_00^{-1}, ...).  ``lus`` holds one host ``SparseLU`` a
    position; the device plans (``SparseLU.solve_plan('auto')``, with a
    dense tail where the factor has one) are made at the first use on
    each device and kept."""

    def __init__(self, mloc, lus):
        self.mloc = mloc
        self.lus = list(lus)

    @classmethod
    def build(cls, a: CSC, part: RowPartition, ordering="amd", tol=1.0):
        """Host: factor each position's diagonal block."""
        from ..linalg import splu

        S, mloc, m = part.S, part.mloc, part.m
        rows, cols, vals = _entry_streams_np(a)
        shard = rows // mloc
        lus = []
        for s in range(S):
            lo, hi = s * mloc, (s + 1) * mloc
            keep = (shard == s) & (cols >= lo) & (cols < hi)
            br = rows[keep] - lo
            bc = cols[keep] - lo
            bv = vals[keep]
            # unit diagonal on rows past m (padding) so the block stays
            # nonsingular
            padded = np.arange(max(0, min(hi, S * mloc) - max(lo, m)))
            if len(padded):
                start = max(lo, m) - lo
                br = np.concatenate([br, padded + start])
                bc = np.concatenate([bc, padded + start])
                bv = np.concatenate([bv, np.ones(len(padded),
                                                 dtype=bv.dtype)])
            block = construct.from_triplets(br, bc, bv, (mloc, mloc),
                                            device="cpu")
            lus.append(splu(block, ordering=ordering, tol=tol))
        return cls(mloc, lus)

    def apply_local(self, bs):
        """Per-position M^{-1} b: ``bs`` one (mloc,) tensor a position."""
        return [lu.solve_plan("auto", device=b.device)(b)
                for lu, b in zip(self.lus, bs)]


class DiagJacobi:
    """Point-Jacobi preconditioner: M^{-1} = diag(A)^{-1}, zero diagonal
    entries taken as 1.

    The memory-light companion to ``BlockJacobi``: per-position direct
    factors fill at ~n_loc x bandwidth, this stores one vector.  ``dinv``
    is the host (S, mloc) array; its rows are placed on the position
    devices at the first use."""

    def __init__(self, dinv):
        self.dinv = np.asarray(dinv)
        self._placed = {}

    @classmethod
    def build(cls, a: CSC, part: RowPartition):
        S, mloc, m = part.S, part.mloc, part.m
        rows, cols, vals = _entry_streams_np(a)
        on = rows == cols
        d = np.zeros(min(a.m, a.n), dtype=vals.dtype)
        np.add.at(d, rows[on], vals[on])
        dp = np.ones(S * mloc, dtype=d.dtype)
        dp[:m] = np.where(d != 0, d, 1.0)
        return cls((1.0 / dp).reshape(S, mloc))

    def apply_local(self, bs):
        key = tuple(b.device for b in bs)
        if key not in self._placed:
            # normal tensors, also under inference mode: a call that
            # autograd records saves them
            with torch.inference_mode(False):
                self._placed[key] = [torch.as_tensor(self.dinv[s], device=d)
                                     for s, d in enumerate(key)]
        return [b * dv for b, dv in zip(bs, self._placed[key])]


def _identity(bs):
    return bs


# ---------------------------------------------------------------------------
# distributed Krylov loops over per-position vectors
# ---------------------------------------------------------------------------

def _dot(us, vs):
    """sum(conj(u) v) over the mesh: the partial dots summed by ``psum``;
    a dict {device: 0-d tensor}."""
    parts = [torch.vdot(u.reshape(-1), v.reshape(-1)) for u, v in zip(us, vs)]
    return {t.device: t for t in psum(parts)}


def _rmap(fn, *reps):
    """``fn`` of replicated values, once per distinct device."""
    return {d: fn(*(r[d] for r in reps)) for d in reps[0]}


def _axpy(a, xs, ys):
    """[y + a x] position by position, a replicated scalar."""
    return [y + a[y.device] * x for x, y in zip(xs, ys)]


def _cg(A, M, b, x, tol, maxiter):
    r = [bi - ai for bi, ai in zip(b, A(x))]
    z = M(r)

    def dot(u, v):
        return _rmap(lambda t: t.real, _dot(u, v))

    d0 = next(iter(dot(b, b).values()))
    stop2 = (max(float(d0) ** 0.5, _TINY) * tol) ** 2
    p, rz, rr = z, dot(r, z), dot(r, r)
    it = 0
    while it < maxiter and float(next(iter(rr.values()))) > stop2:
        Ap = A(p)
        alpha = _rmap(torch.div, rz, dot(p, Ap))
        x = _axpy(alpha, p, x)
        r = _axpy(_rmap(torch.neg, alpha), Ap, r)
        z = M(r)
        rz_new = dot(r, z)
        p = _axpy(_rmap(torch.div, rz_new, rz), p, z)
        rz, rr = rz_new, dot(r, r)
        it += 1
    return x, next(iter(rr.values())).sqrt(), it


def _bicgstab(A, M, b, x, tol, maxiter):
    r = [bi - ai for bi, ai in zip(b, A(x))]
    rhat = r
    d0 = next(iter(_dot(b, b).values())).real
    stop2 = (max(float(d0) ** 0.5, _TINY) * tol) ** 2
    one = {d: torch.ones((), dtype=r[0].dtype, device=d)
           for d in dict.fromkeys(t.device for t in r)}
    rho = alpha = omega = one
    p = v = [torch.zeros_like(t) for t in r]
    rr = _rmap(lambda t: t.real, _dot(r, r))
    it = 0
    while it < maxiter and float(next(iter(rr.values()))) > stop2:
        rho_new = _dot(rhat, r)
        beta = _rmap(lambda rn, ro, al, om: (rn / ro) * (al / om),
                     rho_new, rho, alpha, omega)
        p = [ri + beta[ri.device] * (pi - omega[ri.device] * vi)
             for ri, pi, vi in zip(r, p, v)]
        phat = M(p)
        v = A(phat)
        alpha = _rmap(torch.div, rho_new, _dot(rhat, v))
        s = _axpy(_rmap(torch.neg, alpha), v, r)
        shat = M(s)
        t = A(shat)
        omega = _rmap(torch.div, _dot(t, s), _dot(t, t))
        x = [xi + alpha[xi.device] * ph + omega[xi.device] * sh
             for xi, ph, sh in zip(x, phat, shat)]
        r = _axpy(_rmap(torch.neg, omega), t, s)
        rho = rho_new
        rr = _rmap(lambda t: t.real, _dot(r, r))
        it += 1
    return x, next(iter(rr.values())).sqrt(), it


@torch.inference_mode()
def _dist_solve(loop, part, b, mesh, axis, prec, x0, tol, maxiter):
    mesh.check_axis(axis)
    dev0 = mesh.devices[0]
    b = torch.as_tensor(part.pad_vector(b), device=dev0)
    dt = torch.promote_types(b.dtype, part.dtype)
    b = b.to(dt)
    x0 = (torch.zeros_like(b) if x0 is None else torch.as_tensor(
        part.pad_vector(x0), device=dev0).to(dt))
    bs, xs = mesh.scatter(b, part.mloc), mesh.scatter(x0, part.mloc)

    def A(vs):
        return spmv_local(part, vs, mesh)

    M = _identity if prec is None else prec.apply_local
    x, res, it = loop(A, M, bs, xs, tol, maxiter)
    return (part.trim_vector(torch.cat([xi.to(dev0) for xi in x])),
            res.to(dev0), it)


def dist_cg(part, b, mesh, axis="rows", prec=None, x0=None, tol=1e-10,
            maxiter=1000):
    """Distributed (preconditioned) conjugate gradients for SPD systems.
    ``prec``: None, a ``BlockJacobi`` or a ``DiagJacobi``.  Returns (x (m,)
    on the mesh's first device, residual norm (0-d tensor), iterations)."""
    return _dist_solve(_cg, part, b, mesh, axis, prec, x0, tol, maxiter)


def dist_bicgstab(part, b, mesh, axis="rows", prec=None, x0=None,
                  tol=1e-10, maxiter=1000):
    """Distributed BiCGSTAB for general (non-symmetric) systems.  Returns
    (x, residual norm, iterations) as ``dist_cg``."""
    return _dist_solve(_bicgstab, part, b, mesh, axis, prec, x0, tol,
                       maxiter)
