"""Banded (block-tridiagonal) direct solves: the block-Thomas recurrence.

The JAX package's ``csparse3_tpu/linalg/banded.py``, ported.  For an
RCM-ordered, diagonally dominant system (the power-flow B', B'', the Newton
Jacobian, B + 3I), chunk rows into blocks of s >= bandwidth: A is then block
tridiagonal (D_k, E_k, F_k) and factors by the block-Thomas recurrence

    S_k = D_k - E_k S_{k-1}^{-1} F_{k-1}

storing Ehat_k = E_k S_{k-1}^{-1}, S_k^{-1} and Uhat_k = S_k^{-1} F_k.  A
solve is then two sequential sweeps of dense (s, s) @ (s, B) products, nb =
ceil(n / s) steps each:

    y_k = b_k - Ehat_k y_{k-1}                 (forward)
    x_k = S_k^{-1} y_k - Uhat_k x_{k+1}       (backward)

in place of the level loops of a sparse triangular solve (a few dozen
blocks against hundreds of levels at 10k buses).

* ``BandedLU``          factors on the host (numpy, float64 math), solves on
                        the device; ``solve_host`` is the numpy twin.
* ``BandedRefactor``    values -> factored ``BandedLU``, on the device:
                        one scatter into the block stacks, then
                        ``thomas_factor_device``.
* ``BandedSolvePlan``   block-bidiagonal sweeps over the L / U factors of a
                        no-row-exchange sparse LU (``splu(A, 'rcm', tol=0)``).
* ``ComplexBandedSolve`` what ``BandedLU.factor_device`` returns for a
                        complex matrix.

The recurrences are Python loops over the blocks, each step one or two
torch calls writing into a preallocated (nb, s, B) output (the JAX package's
``lax.scan``); the shapes are fixed, so a solve is a candidate for CUDA
graph capture.  Products run with TF32 off unless the caller asks for less
(``precision``): rounding compounds through the nb-step recurrence.

The solves are differentiable as the JAX package's ``lax.scan`` is: in the
right-hand side, and, for a plan a ``BandedRefactor`` made from values that
require a gradient, in those values (``_BlockSolve``: the backward is the
transposed sweeps through the same factors, ``thomas_sweeps_adjoint`` and
``BandedSolvePlan.solve_blocks_adjoint``).  The device recurrences are
differentiable in every float input, as the JAX package's scans are:
``thomas_sweeps`` / ``thomas_sweeps_sym`` through ``_Sweeps`` (the adjoint
sweeps through the same factors), ``thomas_factor_device(_sym)`` and
``spike_tips_device`` by autograd over out-of-place twins of their steps.
A call with no input that requires a gradient runs under inference mode.

Deviations from the JAX package, by design:

* complex stacks upload and solve on the device like real ones; the JAX
  package keeps them on the host, and its ``factor_device`` factors the
  real 2n x 2n embedding of a complex matrix.  Here the complex block
  stacks are factored on the device, and the ``BandedRefactor`` returned
  beside the plan takes the complex values of A's own pattern (the JAX
  package's takes only values of the embedding);
* ``precision='high'`` and ``'default'`` both allow TF32 products (10-bit
  mantissa).  The JAX package's are 3-pass and 1-pass bfloat16 products;
* the pytree methods and the debug timer switch are not ported.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import resolve_device
from ..ops.matvec import (_cast_grad, _recorded, _save, _saved,
                          _wants_grad)
from ..types import CSC
from ..utils.profiling import span

__all__ = ["BandedLU", "BandedRefactor", "BandedSolvePlan",
           "ComplexBandedSolve", "bandwidth", "is_symmetric_csc",
           "spike_tips_device", "thomas_factor_device",
           "thomas_factor_device_sym", "thomas_sweeps",
           "thomas_sweeps_adjoint", "thomas_sweeps_sym"]

PRECISIONS = ("highest", "high", "default")


# ---------------------------------------------------------------------------
# host helpers (numpy, the JAX package's, copied)
# ---------------------------------------------------------------------------

def bandwidth(Fp, Fi):
    """Max |row - col| over the CSC entries."""
    Fp = np.asarray(Fp)
    Fi = np.asarray(Fi)
    n = len(Fp) - 1
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
    if len(cols) == 0:
        return 0
    return int(np.abs(Fi.astype(np.int64) - cols).max())


def _block_size(bw, s):
    """``s`` or, when None, the block size the JAX package picks for
    bandwidth ``bw``: a multiple of 128 once the bandwidth reaches 96, else
    a multiple of 8.  Raises when s < bw."""
    if s is None:
        q = 128 if bw >= 96 else 8
        s = max(8, -(-max(bw, 1) // q) * q)
    if s < bw:
        raise ValueError(f"block size {s} < matrix bandwidth {bw}")
    return int(s)


def _np_dtype(dtype):
    """numpy dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, dtype=_np_dtype(dtype))).dtype


def _inv(blocks):
    """Batched inverse computed in float64 / complex128 and cast back to
    the stack's dtype (numpy's float32 inversion is far slower than its
    float64 one)."""
    dt = blocks.dtype
    wide = np.complex128 if np.iscomplexobj(blocks) else np.float64
    return _downcast(np.linalg.inv(blocks.astype(wide, copy=False)), dt)


def _downcast(a, dtype):
    """astype, with the values that are subnormal in float32 flushed to 0
    first when the cast narrows: factor fill-in decays into that range, and
    casts of subnormals are slow on some hosts.  Values below ~1.2e-38 are
    far beneath float32 solve precision."""
    if np.dtype(dtype).itemsize < a.dtype.itemsize:
        tiny = np.finfo(np.float32).tiny
        parts = (a.real, a.imag) if np.iscomplexobj(a) else (a,)
        for p in parts:
            np.copyto(p, 0.0, where=np.abs(p) < tiny, casting="unsafe")
    return a.astype(dtype, copy=False)


def _dense_blocks(n, Fp, Fi, Fx, s, lower, dtype=None):
    """(nb, s, s) diagonal blocks and (nb, s, s) off-diagonal blocks of a
    banded triangular CSC, zero-padded to nb*s rows; the padded tail gets
    a unit diagonal."""
    nb = -(-n // s)
    N = nb * s
    if dtype is None:
        dtype = Fx.dtype
    diag = np.zeros((nb, s, s), dtype=dtype)
    off = np.zeros((nb, s, s), dtype=dtype)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
    rows = np.asarray(Fi).astype(np.int64)
    vals = _downcast(np.asarray(Fx).copy(), dtype)
    kb_r, kb_c = rows // s, cols // s
    same = kb_r == kb_c
    diag[kb_r[same], rows[same] % s, cols[same] % s] = vals[same]
    adj = (kb_r == kb_c + 1) if lower else (kb_r == kb_c - 1)
    off[kb_r[adj], rows[adj] % s, cols[adj] % s] = vals[adj]
    bad = ~(same | adj)
    if bad.any():
        raise ValueError(
            f"factor bandwidth exceeds block size {s}; "
            f"{int(bad.sum())} entries outside the block bidiagonal")
    for i in range(n, N):
        diag[i // s, i % s, i % s] = 1.0
    return diag, off


def _tridiag_blocks(n, Ap, Ai, Ax, s, dtype):
    """(nb,s,s) diagonal D, subdiagonal E and superdiagonal F blocks of a
    banded square CSC, zero-padded to nb*s rows with a unit diagonal on
    the padded tail.  E[k] couples block k to k-1 (E[0] = 0); F[k]
    couples block k to k+1 (F[nb-1] = 0)."""
    nb = -(-n // s)
    D = np.zeros((nb, s, s), dtype=dtype)
    E = np.zeros((nb, s, s), dtype=dtype)
    F = np.zeros((nb, s, s), dtype=dtype)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(np.asarray(Ap)))
    rows = np.asarray(Ai).astype(np.int64)
    vals = np.asarray(Ax).astype(dtype, copy=False)
    kb_r, kb_c = rows // s, cols // s
    same = kb_r == kb_c
    D[kb_r[same], rows[same] % s, cols[same] % s] = vals[same]
    sub = kb_r == kb_c + 1
    E[kb_r[sub], rows[sub] % s, cols[sub] % s] = vals[sub]
    sup = kb_r == kb_c - 1
    F[kb_r[sup], rows[sup] % s, cols[sup] % s] = vals[sup]
    bad = ~(same | sub | sup)
    if bad.any():
        raise ValueError(
            f"matrix bandwidth exceeds block size {s}; "
            f"{int(bad.sum())} entries outside the block tridiagonal")
    for i in range(n, nb * s):
        D[i // s, i % s, i % s] = 1.0
    return D, E, F


def is_symmetric_csc(n, Ap, Ai, Ax) -> bool:
    """Exact structural and numeric symmetry of a canonical CSC (host)."""
    from ..ops.construct import transpose

    t = transpose(CSC(n, n, np.asarray(Ap), np.asarray(Ai), np.asarray(Ax),
                      canonical=True, device="cpu"))
    Tp, Ti, Tx = t.np_arrays()
    return (np.array_equal(np.asarray(Tp, dtype=np.int64),
                           np.asarray(Ap, dtype=np.int64))
            and np.array_equal(np.asarray(Ti, dtype=np.int64),
                               np.asarray(Ai, dtype=np.int64))
            and np.array_equal(np.asarray(Tx), np.asarray(Ax)))


def _thomas_factor(n, s, nb, rows, cols, vals, dtype, wide, sym=False):
    """Streaming block-Thomas factorization of the block-tridiagonal
    system given by 0-based COO entries (host, ``wide`` math).

    Returns (ehat, sinv, uhat) stacks of shape (nb, s, s) in ``dtype``:
    Ehat_k = E_k S_{k-1}^{-1}, S_k^{-1}, Uhat_k = S_k^{-1} F_k with
    S_k = D_k - Ehat_k F_{k-1}.  Rows n..nb*s get a unit diagonal (pad).
    Only the output stacks are materialized; the recurrence state is
    rolling (s, s) buffers.

    ``sym=True`` (caller-verified SYMMETRIC input, real or complex): every
    Schur complement S_k is then symmetric and E_k = F_{k-1}^T, so
    Ehat_k = (Sinv_{k-1} F_{k-1})^T = Uhat_{k-1}^T: the E scatter and one
    product per block drop out.  ``np.linalg.LinAlgError`` signals a
    singular S_k.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals).astype(wide, copy=False)
    kb_r, kb_c = rows // s, cols // s
    if (np.abs(kb_r - kb_c) > 1).any():
        nbad = int((np.abs(kb_r - kb_c) > 1).sum())
        raise ValueError(
            f"matrix bandwidth exceeds block size {s}; "
            f"{nbad} entries outside the block tridiagonal")
    order = np.argsort(kb_c, kind="stable")
    kb_c_s = kb_c[order]
    starts = np.searchsorted(kb_c_s, np.arange(nb + 1))
    lr, lc = (rows % s)[order], (cols % s)[order]
    dr = (kb_r - kb_c)[order]  # -1 (super of prev), 0 (diag), +1 (sub)
    vs = vals[order]

    ehat = np.zeros((nb, s, s), dtype=dtype)
    sinv = np.empty((nb, s, s), dtype=dtype)
    uhat = np.empty((nb, s, s), dtype=dtype)
    # block column k of the CSC holds: D_k (d=0), E_{k+1} (d=+1, rows
    # one block down) and F_{k-1} (d=-1, rows one block up)
    Dk = np.zeros((s, s), dtype=wide)
    Ek = np.zeros((s, s), dtype=wide)      # E_k, stashed at col k-1
    Enext = np.zeros((s, s), dtype=wide)
    Fk = np.zeros((s, s), dtype=wide)      # F_k, read ahead at col k+1
    Fprev = np.zeros((s, s), dtype=wide)
    Sinv_prev = None
    Uprev = None                           # wide Uhat_{k-1} (sym path)
    pad0 = n // s  # first block containing padded rows
    for k in range(nb):
        lo, hi = starts[k], starts[k + 1]
        r, c, d, v = lr[lo:hi], lc[lo:hi], dr[lo:hi], vs[lo:hi]
        Dk[:] = 0.0
        m0 = d == 0
        Dk[r[m0], c[m0]] = v[m0]
        if not sym:
            Enext[:] = 0.0
            m1 = d == 1
            Enext[r[m1], c[m1]] = v[m1]
        Fk[:] = 0.0
        if k + 1 < nb:
            lo2, hi2 = starts[k + 1], starts[k + 2]
            m2 = dr[lo2:hi2] == -1
            Fk[lr[lo2:hi2][m2], lc[lo2:hi2][m2]] = vs[lo2:hi2][m2]
        if k >= pad0:
            # unit diagonal on padded rows so S_k stays nonsingular
            i0 = max(n - k * s, 0)
            idx = np.arange(i0, s)
            Dk[idx, idx] = 1.0
        if k:
            if sym:
                # Eh = E_k Sinv_{k-1} = (Sinv_{k-1} F_{k-1})^T = Uprev^T
                S = Dk - Uprev.T @ Fprev
                ehat[k] = uhat[k - 1].T  # downcast(Uprev)^T, exactly
            else:
                Eh = Ek @ Sinv_prev
                S = Dk - Eh @ Fprev
                ehat[k] = _downcast(Eh, dtype)
        else:
            S = Dk.copy()
        Sinv = np.linalg.inv(S)
        sinv[k] = _downcast(Sinv, dtype)
        Uk = Sinv @ Fk
        uhat[k] = _downcast(Uk, dtype)
        Sinv_prev = Sinv
        Uprev = Uk
        Fprev, Fk = Fk, Fprev
        if not sym:
            Ek, Enext = Enext, Ek
    return ehat, sinv, uhat


def _sweeps_host(ehat, sinv, uhat, bb):
    """numpy twin of ``thomas_sweeps``."""
    nb = bb.shape[0]
    y = np.empty_like(bb)
    y[0] = bb[0]
    for k in range(1, nb):
        y[k] = bb[k] - ehat[k] @ y[k - 1]
    x = np.empty_like(y)
    x[nb - 1] = sinv[nb - 1] @ y[nb - 1]
    for k in range(nb - 2, -1, -1):
        x[k] = sinv[k] @ y[k] - uhat[k] @ x[k + 1]
    return x


# ---------------------------------------------------------------------------
# device recurrences (torch)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _matmul_precision(precision):
    """float32 products at ``precision``, whatever the caller's global
    setting: 'highest' turns TF32 off, 'high' and 'default' allow it
    (float64 and complex128 products are unaffected).  Restores the
    caller's setting on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have "
                         f"{PRECISIONS}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _block_ops(t):
    """(mm, addmm, addmm_) for the per-block operands of a stack ``t``:
    (nb, s, *) stacks hold one matrix a block; (nb, K, s, *) stacks hold
    one per scenario, and their blocks go through the batched forms."""
    if t.ndim == 4:
        return torch.bmm, torch.baddbmm, torch.Tensor.baddbmm_
    return torch.mm, torch.addmm, torch.Tensor.addmm_


def _common(bb, *stacks):
    """The stacks and the right-hand sides in their common dtype."""
    dt = torch.promote_types(stacks[0].dtype, bb.dtype)
    return bb.to(dt), [m.to(dt) for m in stacks]


def thomas_sweeps(ehat, sinv, uhat, bb, precision="highest"):
    """Block-Thomas solve on the stacks' device: bb (nb, s, B) -> x blocks
    (nb, s, B), in the common dtype of the stacks and ``bb``.

    Forward y_k = b_k - Ehat_k y_{k-1} (one ``addmm_`` per block), backward
    x_k = S_k^{-1} y_k - Uhat_k x_{k+1} (one ``mm`` and one ``addmm_``).
    ``precision``: 'highest' (full float32, the default), 'high' or
    'default' (both TF32; see the module docstring).  Differentiable in
    every input (``_Sweeps``) when one requires a gradient."""
    return _solve_sweeps(ehat, sinv, uhat, bb, precision)


def _solve_sweeps(ehat, sinv, uhat, bb, precision):
    """``thomas_sweeps`` (``ehat`` None: ``thomas_sweeps_sym``): through
    ``_Sweeps`` when an input requires a gradient, else under inference
    mode."""
    with span("banded.sweeps", blocks=sinv.shape[0], s=sinv.shape[-1],
              sym=ehat is None):
        if _wants_grad(ehat, sinv, uhat, bb):
            return _Sweeps.apply(ehat, sinv, uhat, bb, precision)
        with torch.inference_mode():
            return _sweeps(ehat, sinv, uhat, bb, precision)[1]


def _sweeps(ehat, sinv, uhat, bb, precision):
    """(y, x): the forward sweep's blocks and the solution; ``ehat`` None
    reads Ehat_k as Uhat_{k-1}^T (the symmetric form)."""
    stacks = (sinv, uhat) if ehat is None else (sinv, uhat, ehat)
    bb, (sinv, uhat, *ehat) = _common(bb, *stacks)
    _, _, addmm_ = _block_ops(bb)
    with _matmul_precision(precision):
        y = bb.clone()
        ys, uh = y.unbind(0), uhat.unbind(0)
        eh = ehat[0].unbind(0) if ehat else None
        for k in range(1, len(ys)):
            ek = uh[k - 1].mT if eh is None else eh[k]
            addmm_(ys[k], ek, ys[k - 1], alpha=-1)
        return y, _backward(sinv, uhat, y)


def _backward(sinv, uhat, y):
    # the per-block views come from one unbind each: cheaper on the host
    # than one index per block and step
    mm, _, addmm_ = _block_ops(y)
    x = torch.empty_like(y)
    xs, ys, si, uh = x.unbind(0), y.unbind(0), sinv.unbind(0), uhat.unbind(0)
    nb = len(xs)
    mm(si[nb - 1], ys[nb - 1], out=xs[nb - 1])
    for k in range(nb - 2, -1, -1):
        mm(si[k], ys[k], out=xs[k])
        addmm_(xs[k], uh[k], xs[k + 1], alpha=-1)
    return x


@torch.inference_mode()
def thomas_sweeps_adjoint(ehat, sinv, uhat, bb, precision="highest"):
    """x = A^{-T} b through the factors ``thomas_sweeps`` reads: A = L U
    with L unit block lower bidiagonal (Ehat_k below the diagonal) and U =
    diag(S) (I + Uhat above it), so A^T = U^T L^T and

        z_k = b_k - Uhat_{k-1}^T z_{k-1}            (forward, up U^T)
        x_k = Sinv_k^T z_k - Ehat_{k+1}^T x_{k+1}   (backward, down L^T)

    bb (nb, s, B) -> (nb, s, B), or (nb, K, s, 1) for batched stacks; the
    transpose is plain (A^{-H} b is its conjugate on conj(b)).  ``ehat``
    None is the symmetric form (Ehat_{k+1}^T = Uhat_k)."""
    return _adjoint_sweeps(ehat, sinv, uhat, bb, precision)[1]


def _adjoint_sweeps(ehat, sinv, uhat, bb, precision):
    """(z, x) of ``thomas_sweeps_adjoint``: the sweep up U^T and the
    solution."""
    stacks = (sinv, uhat) if ehat is None else (sinv, uhat, ehat)
    bb, (sinv, uhat, *ehat) = _common(bb, *stacks)
    mm, _, addmm_ = _block_ops(bb)
    with _matmul_precision(precision):
        z = bb.clone()
        zs, uh = z.unbind(0), uhat.unbind(0)
        for k in range(1, len(zs)):
            addmm_(zs[k], uh[k - 1].mT, zs[k - 1], alpha=-1)
        x = torch.empty_like(z)
        xs, si = x.unbind(0), sinv.unbind(0)
        eh = ehat[0].unbind(0) if ehat else None
        nb = len(xs)
        mm(si[nb - 1].mT, zs[nb - 1], out=xs[nb - 1])
        for k in range(nb - 2, -1, -1):
            mm(si[k].mT, zs[k], out=xs[k])
            addmm_(xs[k], uh[k] if eh is None else eh[k + 1].mT, xs[k + 1],
                   alpha=-1)
    return z, x


class _Sweeps(torch.autograd.Function):
    """x = ``thomas_sweeps(ehat, sinv, uhat, bb)`` (``ehat`` None: the
    symmetric form), differentiable in every float input, as the JAX
    package's ``lax.scan`` sweeps.  With g = dL/dx, the adjoint sweeps of
    conj(g) through the same factors give z (up U^T) and lam = A^{-H} g;
    with y the forward sweep's blocks (kept):

        dL/dbb = lam,  dL/dSinv_k = z_k y_k^H,  dL/dUhat_k = -z_k x_{k+1}^H,
        dL/dEhat_k = -lam_k y_{k-1}^H

    (z and lam conjugated back), and in the symmetric form Ehat_k's
    gradient goes to Uhat_{k-1} transposed.  Each is one batched product
    over the whole stack."""

    @staticmethod
    def forward(ctx, ehat, sinv, uhat, bb, precision):
        y, x = _sweeps(ehat, sinv, uhat, bb, precision)
        ctx.precision = precision
        ctx.dtypes = [None if t is None else t.dtype
                      for t in (ehat, sinv, uhat, bb)]
        _save(ctx, sinv, uhat, y, x, *(() if ehat is None else (ehat,)))
        return x

    @staticmethod
    def backward(ctx, g):
        sinv, uhat, y, x, *ehat = _saved(ctx)
        ehat = ehat[0] if ehat else None
        with torch.no_grad(), _matmul_precision(ctx.precision):
            z, lam = _adjoint_sweeps(ehat, sinv, uhat, g.conj(),
                                     ctx.precision)
            z, lam = z.conj(), lam.conj()
            gsi = z @ y.mH
            zero = gsi.new_zeros((1,) + gsi.shape[1:])
            guh = torch.cat([-(z[:-1] @ x[1:].mH), zero])
            geh = torch.cat([zero, -(lam[1:] @ y[:-1].mH)])
            if ehat is None:
                guh[:-1] += geh[1:].mT
        grads = (None if ehat is None else geh, gsi, guh, lam)
        return (*(None if gr is None or not need else _cast_grad(gr, dt)
                  for gr, dt, need in zip(grads, ctx.dtypes,
                                          ctx.needs_input_grad)), None)


class _BlockSolve(torch.autograd.Function):
    """xx = A^{-1} bb in block space through ``plan`` (a ``BandedLU`` or a
    ``BandedSolvePlan``: its ``_sweeps``), differentiable in bb and, for a
    plan that a ``BandedRefactor`` made from values that require a
    gradient (``plan.values``), in those values.  With g = dL/dxx and lam =
    A^{-H} g (``plan._sweeps_adjoint``, the transposed sweeps through the
    same factors): dL/dbb = lam, and dL/dvalues = -lam[r] conj(xx[c]) at
    each entry's row and column in block space (``plan._pattern``)."""

    @staticmethod
    def forward(ctx, plan, bb, values, precision):
        with torch.inference_mode():
            xx = plan._sweeps(bb, precision)
        xx = xx.clone()
        ctx.plan, ctx.precision, ctx.bb_dtype = plan, precision, bb.dtype
        ctx.save_for_backward(xx)
        return xx

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        xx, = ctx.saved_tensors
        with torch.inference_mode():
            lam = plan._sweeps_adjoint(g.conj(), ctx.precision).conj()
        lam = lam.clone()
        gb = gv = None
        if ctx.needs_input_grad[1]:
            gb = _cast_grad(lam, ctx.bb_dtype)
        if ctx.needs_input_grad[2]:
            r, c = plan._pattern
            if plan.batched:  # (nb, K, s, 1): scenario k on values k
                K = xx.shape[1]
                lam = lam[..., 0].transpose(0, 1).reshape(K, -1)
                xx = xx[..., 0].transpose(0, 1).reshape(K, -1)
                gv = -(lam[:, r] * xx[:, c].conj())
            else:
                lam = lam.reshape(-1, lam.shape[-1])
                xx = xx.reshape(-1, xx.shape[-1])
                gv = -(lam[r] * xx[c].conj()).sum(-1)
            gv = _cast_grad(gv, plan.values.dtype)
        return None, gb, gv, None


def thomas_sweeps_sym(sinv, uhat, bb, precision="highest"):
    """``thomas_sweeps`` for factors from ``thomas_factor_device_sym``: the
    forward sweep reads Ehat_k as Uhat_{k-1}^T (a plain transpose, also for
    complex symmetric input).  Differentiable as ``thomas_sweeps``."""
    return _solve_sweeps(None, sinv, uhat, bb, precision)


def spike_tips_device(sinv, uhat, Bp, Cp, ehat=None, precision="highest"):
    """The first and last (s, s) blocks of the SPIKE spikes of one chunk,
    without forming the spikes.  With T the chunk's block-tridiagonal
    matrix (factored into ``sinv``, ``uhat`` and, for general input,
    ``ehat``), W = T^{-1} [B; 0; ..; 0] and V = T^{-1} [0; ..; 0; C]:

      W: y_0 = B,  y_k = -Ehat_k y_{k-1}                 (forward)
         x_{m-1} = Sinv_{m-1} y_{m-1},  x_k = Sinv_k y_k - Uhat_k x_{k+1}
      V: x_{m-1} = Sinv_{m-1} C,        x_k = -Uhat_k x_{k+1}

    ``ehat=None`` is the symmetric form (Ehat_k = Uhat_{k-1}^T).  Memory:
    one (m, s, s) stack for the forward chain y, and the backward
    recurrences carry one (s, s) block each (two (s, s) buffers in turn)
    and keep no per-step outputs: those would be two more (m, s, s) stacks,
    20 GB at 1M buses and s = 2560.  Returns (Wt, Wb, Vt, Vb).

    Differentiable in every input when one requires a gradient: autograd
    then records the same recurrences (``_spike_tips_taped``)."""
    if _wants_grad(sinv, uhat, Bp, Cp, ehat):
        return _spike_tips_taped(sinv, uhat, Bp, Cp, ehat, precision)
    with torch.inference_mode():
        return _spike_tips(sinv, uhat, Bp, Cp, ehat, precision)


def _spike_tips(sinv, uhat, Bp, Cp, ehat, precision):
    m = sinv.shape[0]
    with _matmul_precision(precision):
        y = torch.empty_like(sinv)
        y[0] = Bp
        for k in range(1, m):
            ek = uhat[k - 1].mT if ehat is None else ehat[k]
            torch.mm(ek, y[k - 1], out=y[k])
            y[k].neg_()
        Wb = sinv[m - 1] @ y[m - 1]
        Wt = Wb
        buf = (torch.empty_like(Wb), torch.empty_like(Wb))
        for k in range(m - 2, -1, -1):
            torch.mm(sinv[k], y[k], out=buf[k % 2])
            Wt = buf[k % 2].addmm_(uhat[k], Wt, alpha=-1)
        del y
        Vb = sinv[m - 1] @ Cp
        Vt = Vb
        buf = (torch.empty_like(Vb), torch.empty_like(Vb))
        for k in range(m - 2, -1, -1):
            Vt = torch.mm(uhat[k], Vt, out=buf[k % 2]).neg_()
    return Wt, Wb, Vt, Vb


def _normal(*tensors):
    """``tensors`` usable in a computation autograd records: an inference
    tensor (a stack made under inference mode) is copied, None kept."""
    return [t.clone() if t is not None and t.is_inference() else t
            for t in tensors]


def _spike_tips_taped(sinv, uhat, Bp, Cp, ehat, precision):
    """``spike_tips_device`` in out-of-place steps that autograd follows
    (it keeps each step's block for the backward, as the JAX package's
    scan does)."""
    sinv, uhat, Bp, Cp, ehat = _normal(sinv, uhat, Bp, Cp, ehat)
    m = sinv.shape[0]
    with _matmul_precision(precision):
        y = [Bp]
        for k in range(1, m):
            ek = uhat[k - 1].mT if ehat is None else ehat[k]
            y.append(-(ek @ y[k - 1]))
        Wb = Wt = sinv[m - 1] @ y[m - 1]
        for k in range(m - 2, -1, -1):
            Wt = sinv[k] @ y[k] - uhat[k] @ Wt
        Vb = Vt = sinv[m - 1] @ Cp
        for k in range(m - 2, -1, -1):
            Vt = -(uhat[k] @ Vt)
    return Wt, Wb, Vt, Vb


def _inverse_into(S, out, info):
    # inv_ex does not check the result, so it does not wait for the device;
    # a singular block gives non-finite values, as the JAX package's inverse
    torch.linalg.inv_ex(S, check_errors=False, out=(out, info))


def thomas_factor_device(D, E, F):
    """Block-Thomas factorization on the stacks' device: (nb, s, s)
    block-tridiagonal stacks -> (ehat, sinv, uhat) plan stacks, in full
    precision.  Per block: Ehat_k = E_k S_{k-1}^{-1}, S_k = D_k - Ehat_k
    F_{k-1}, its inverse (``torch.linalg.inv_ex``), Uhat_k = S_k^{-1} F_k.
    E[0] must be zero; Ehat_0 is zero.  (nb, K, s, s) stacks (any strides)
    factor K matrices of one block layout at once, each step one batched
    call; the plan stacks come out contiguous.

    Differentiable in D, E and F when one requires a gradient: autograd
    then records the same steps (``_thomas_factor_taped``), as the JAX
    package's ``lax.scan``."""
    if _wants_grad(D, E, F):
        return _thomas_factor_taped(D, E, F)
    with torch.inference_mode():
        return _thomas_factor_device(D, E, F)


def _thomas_factor_device(D, E, F):
    nb = D.shape[0]
    mm, addmm, _ = _block_ops(D)
    opts = dict(dtype=D.dtype, device=D.device)
    ehat = torch.zeros(D.shape, **opts)
    sinv = torch.empty(D.shape, **opts)
    uhat = torch.empty(D.shape, **opts)
    info = torch.empty(D.shape[1:-2], dtype=torch.int32, device=D.device)
    with _matmul_precision("highest"):
        for k in range(nb):
            if k:
                mm(E[k], sinv[k - 1], out=ehat[k])
                S = addmm(D[k], ehat[k], F[k - 1], alpha=-1)
            else:
                S = D[0]
            _inverse_into(S, sinv[k], info)
            mm(sinv[k], F[k], out=uhat[k])
    return ehat, sinv, uhat


def thomas_factor_device_sym(D, F):
    """Symmetric-input ``thomas_factor_device``: E_k = F_{k-1}^T and every
    S_k is symmetric, so Ehat_k = Uhat_{k-1}^T and the E stack and one
    product per block drop out.  Returns (sinv, uhat); pair with
    ``thomas_sweeps_sym``.  Differentiable in D and F as
    ``thomas_factor_device``."""
    if _wants_grad(D, F):
        return _thomas_factor_taped(D, None, F)
    with torch.inference_mode():
        return _thomas_factor_device_sym(D, F)


def _thomas_factor_device_sym(D, F):
    nb = D.shape[0]
    sinv = torch.empty_like(D)
    uhat = torch.empty_like(D)
    info = torch.empty((), dtype=torch.int32, device=D.device)
    with _matmul_precision("highest"):
        for k in range(nb):
            S = (torch.addmm(D[k], uhat[k - 1].mT, F[k - 1], alpha=-1)
                 if k else D[0])
            _inverse_into(S, sinv[k], info)
            torch.mm(sinv[k], F[k], out=uhat[k])
    return sinv, uhat


def _thomas_factor_taped(D, E, F):
    """The factorization in out-of-place steps that autograd follows (the
    in-place forms write into preallocated stacks, which it cannot): the
    blocks are stacked at the end.  ``E`` None is the symmetric form and
    returns (sinv, uhat)."""
    D, E, F = _normal(D, E, F)
    eh, si, uh = [torch.zeros_like(D[0])], [], []
    with _matmul_precision("highest"):
        for k in range(D.shape[0]):
            if not k:
                S = D[0]
            elif E is None:
                S = D[k] - uh[k - 1].mT @ F[k - 1]
            else:
                eh.append(E[k] @ si[k - 1])
                S = D[k] - eh[k] @ F[k - 1]
            si.append(torch.linalg.inv_ex(S, check_errors=False)[0])
            uh.append(si[k] @ F[k])
    if E is None:
        return torch.stack(si), torch.stack(uh)
    return torch.stack(eh), torch.stack(si), torch.stack(uh)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _permuted(a, ordering):
    """(perm, A[perm, perm]) for a square CSC."""
    from . import ordering as ordering_mod

    n, m = a.shape
    if n != m:
        raise ValueError(f"square matrix required, got {a.shape}")
    perm = np.asarray(ordering_mod.get_ordering(
        "natural" if ordering is None else ordering, a))
    if np.array_equal(perm, np.arange(n)):
        return perm, a
    from ..ops.slicing import submatrix

    return perm, submatrix(a, perm, perm)


class BandedLU:
    """Direct block-tridiagonal ("block Thomas") factorization of a banded
    matrix: factor once on the host, solve many right-hand sides on the
    device.

    ``BandedLU(a, ordering='rcm', s=None, dtype=None, device=None)`` orders
    ``a`` (``linalg.ordering``), picks the block size s >= bandwidth
    (``ValueError`` if a given s is smaller) and factors with float64 (or
    complex128) math into ``dtype`` stacks (default: the values' dtype).
    Pivoting is within blocks only (LAPACK inverses of each S_k), so use it
    on diagonally dominant or well-conditioned banded systems;
    ``np.linalg.LinAlgError`` signals a singular block.

    The stacks stay host numpy until the first device solve, then upload
    once to ``device`` (None: ``config.default_device()``, resolved then).
    ``solve_host`` never uploads.
    """

    def __init__(self, a, ordering="rcm", s: int | None = None, dtype=None,
                 device=None):
        n = a.shape[0]
        with span("setup.banded_factor", n=n) as sp:
            perm, ap = _permuted(a, ordering)
            Ap, Ai, Ax = ap.np_arrays()
            bw = bandwidth(Ap, Ai)
            s = _block_size(bw, s)
            sp.note(s=s, bw=bw)
            dtype = Ax.dtype if dtype is None else _np_dtype(dtype)
            wide = np.complex128 if np.iscomplexobj(Ax) else np.float64
            nb = -(-n // s)
            cols = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(np.asarray(Ap)))
            sym = is_symmetric_csc(n, Ap, Ai, Ax) if ap.canonical else False
            ehat, sinv, uhat = _thomas_factor(n, s, nb, Ai, cols, Ax, dtype,
                                              wide, sym=sym)
        self._set(n, s, bw, (ehat, sinv, uhat, perm), None, device)

    def _set(self, n, s, bw, host, dev, device):
        self.n, self.s, self.bw = n, s, bw
        #: the values a ``BandedRefactor`` factored, when they require a
        #: gradient, and their entries' (row, column) in block space
        self.values = self._pattern = None
        #: host (ehat, sinv, uhat, perm) numpy, or None for a plan factored
        #: on the device
        self._h = host
        #: the same on the device, uploaded at the first device access
        self._dev = dev
        self._device = device

    @classmethod
    def _from_stacks(cls, ehat, sinv, uhat, perm, n, s, bw, device=None):
        """A plan from its stacks: numpy arrays (kept on the host until the
        first device solve, on ``device``) or tensors on one device."""
        obj = object.__new__(cls)
        stacks = (ehat, sinv, uhat, perm)
        if isinstance(sinv, torch.Tensor):
            obj._set(n, s, bw, None, stacks, sinv.device)
        else:
            obj._set(n, s, bw, tuple(np.asarray(m) for m in stacks), None,
                     device)
        return obj

    @property
    def device(self) -> torch.device:
        if self._dev is not None:
            return self._dev[1].device
        return resolve_device(self._device)

    @property
    def dtype(self) -> torch.dtype:
        return (self._dev[1].dtype if self._dev is not None
                else _torch_dtype(self._h[1].dtype))

    def stacks(self):
        """(ehat, sinv, uhat, perm) on the device, uploaded at the first
        call and kept."""
        if self._dev is None:
            dev = self.device
            self._dev = tuple(torch.as_tensor(np.ascontiguousarray(m),
                                              device=dev) for m in self._h)
        return self._dev

    @property
    def perm(self):
        """The ordering on the device (uploaded with the stacks)."""
        return self.stacks()[3]

    def perm_host(self) -> np.ndarray:
        return (self._h[3] if self._h is not None
                else self._dev[3].cpu().numpy())

    @property
    def nblocks(self) -> int:
        return -(-self.n // self.s)

    @property
    def batched(self) -> bool:
        """True for a plan over K matrices of one block layout (a
        ``BandedRefactor`` of (K, nnz) values): (nb, K, s, s) stacks, and
        solves of b (K, n), row k against matrix k."""
        return (self._dev is not None and self._dev[1].ndim == 4)

    def blocks(self, b):
        """Permute and zero-pad an (n,) / (n, B) right-hand side (numpy or a
        tensor) into (nb, s, B) block form on the device; for a ``batched``
        plan b (K, n) into (nb, K, s, 1).  Chained solvers stay in block
        space and call ``solve_blocks``."""
        perm = self.stacks()[3]
        b = torch.as_tensor(b, device=perm.device)
        n, s, nb = self.n, self.s, self.nblocks
        dt = torch.promote_types(self.dtype, b.dtype)
        with _recorded(b):
            if self.batched:
                bp = torch.zeros((b.shape[0], nb * s), dtype=dt,
                                 device=perm.device)
                bp[:, :n] = b[:, perm]
                return bp.view(-1, nb, s).transpose(0, 1)[
                    ..., None].contiguous()
            if b.ndim == 1:
                b = b[:, None]
            bp = torch.zeros((nb * s, b.shape[1]), dtype=dt,
                             device=perm.device)
            bp[:n] = b[perm]
            return bp.view(nb, s, -1)

    def unblocks(self, xx):
        """Inverse of ``blocks``: (nb, s, B) -> (n, B), and (nb, K, s, 1)
        -> (K, n)."""
        perm = self.stacks()[3]
        with _recorded(xx):
            if self.batched:
                zf = xx[..., 0].transpose(0, 1).reshape(
                    xx.shape[1], -1)[:, : self.n]
                return torch.empty_like(zf).index_copy_(1, perm, zf)
            zf = xx.reshape(self.nblocks * self.s, -1)[: self.n]
            return torch.empty_like(zf).index_copy_(0, perm, zf)

    def solve_blocks(self, bb, precision="highest"):
        """Solve in block space: (nb, s, B) -> (nb, s, B).  Differentiable
        (``_BlockSolve``) in bb and in ``values`` when either requires a
        gradient; any other call runs under inference mode."""
        if _wants_grad(bb, self.values):
            return _BlockSolve.apply(self, bb, self.values, precision)
        return self._sweeps(bb, precision)

    def _sweeps(self, bb, precision):
        ehat, sinv, uhat, _ = self.stacks()
        return thomas_sweeps(ehat, sinv, uhat, bb, precision=precision)

    def _sweeps_adjoint(self, gg, precision):
        ehat, sinv, uhat, _ = self.stacks()
        return thomas_sweeps_adjoint(ehat, sinv, uhat, gg,
                                     precision=precision)

    def __call__(self, b):
        """x = A^{-1} b on the device, b of shape (n,) or (n, B); (K, n)
        for a ``batched`` plan.  Differentiable in b and, for a plan from a
        ``BandedRefactor`` of values that require a gradient, in them."""
        x = self.unblocks(self.solve_blocks(self.blocks(b)))
        return x[:, 0] if np.ndim(b) == 1 and not self.batched else x

    def solve_host(self, b):
        """Host solve, the numpy twin of the device sweeps (float64 math
        over the stored stacks)."""
        if self._h is None:
            raise ValueError("no host stacks: this plan was factored on the "
                             "device")
        Ehat, invS, Uhat, perm = self._h
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        nb, s = invS.shape[0], self.s
        dt = np.result_type(invS.dtype, b.dtype)
        bp = np.zeros((nb * s, b.shape[1]), dtype=dt)
        bp[: self.n] = b[perm]
        x = _sweeps_host(Ehat, invS, Uhat, bp.reshape(nb, s, -1))
        xf = x.reshape(nb * s, -1)[: self.n]
        out = np.empty_like(xf)
        out[perm] = xf
        return out[:, 0] if squeeze else out

    def refactor_plan(self, a):
        """Device numeric refactorization on this plan's device: freeze its
        block layout and permutation, then factor NEW values of the same
        pattern (``BandedRefactor``)."""
        return BandedRefactor(self, a)

    @classmethod
    def factor_device(cls, a, ordering="rcm", s: int | None = None,
                      dtype=None, device=None):
        """Factor ``a`` with the numeric work on the device: the host does
        the ordering, bandwidth and block index map; the recurrence runs
        as ``thomas_factor_device`` and the stacks are born on the device.

        Returns ``(lu, rf)``: the solvable plan and the ``BandedRefactor``
        that produced it, reusable for new values of ``a``'s pattern.  A
        complex ``a`` is factored in complex arithmetic and ``lu`` is a
        ``ComplexBandedSolve``; ``rf`` takes complex values."""
        rf = BandedRefactor.from_matrix(a, ordering=ordering, s=s,
                                        dtype=dtype, device=device)
        lu = rf(a.np_arrays()[2])
        if lu.dtype.is_complex:
            return ComplexBandedSolve(lu), rf
        return lu, rf


class ComplexBandedSolve:
    """Complex-facing solve of ``BandedLU.factor_device`` on a complex
    matrix: complex right-hand sides in the caller's order, complex
    solutions on the device.  The JAX package's wraps the factored real
    2n-system of the split-complex embedding; here ``lu`` is the complex
    ``BandedLU`` itself."""

    def __init__(self, lu: BandedLU):
        self.lu = lu
        self.n = lu.n

    @property
    def perm_c(self) -> np.ndarray:
        """The complex-level ordering."""
        return self.lu.perm_host()

    def solve(self, b):
        return self.lu(b)

    __call__ = solve


class BandedRefactor:
    """values -> factored ``BandedLU``, on the device.

    Built once from a factored ``BandedLU`` and the matrix it factored, or
    from the matrix alone (``from_matrix``).  ``__call__(data)`` takes the
    CSC ``data`` of the same pattern (new values), adds it into zeroed
    block-tridiagonal stacks through a static index map, puts the unit
    diagonal on the padded rows and runs ``thomas_factor_device``; it
    returns a solvable ``BandedLU`` whose stacks live on the device.
    """

    def __init__(self, plan: BandedLU, a):
        self._build(plan.n, plan.s, plan.nblocks, plan.bw, plan.perm_host(),
                    plan.dtype, a, plan.device)

    @classmethod
    def from_matrix(cls, a, ordering="rcm", s: int | None = None,
                    dtype=None, device=None):
        """Symbolic-only construction: ordering, bandwidth and the block
        index map on the host (O(nnz) integer numpy), uploaded to
        ``device`` (None: ``config.default_device()``); every numeric
        factorization then runs there.  ``dtype`` defaults to the values'
        dtype."""
        from . import ordering as ordering_mod

        n, m = a.shape
        if n != m:
            raise ValueError(f"square matrix required, got {a.shape}")
        perm = np.asarray(ordering_mod.get_ordering(
            "natural" if ordering is None else ordering, a))
        pinv = np.empty(n, dtype=np.int64)
        pinv[perm] = np.arange(n, dtype=np.int64)
        Ap, Ai, Ax = a.np_arrays()
        cols = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(np.asarray(Ap)))
        bw = int(np.abs(pinv[np.asarray(Ai, dtype=np.int64)]
                        - pinv[cols]).max()) if len(cols) else 0
        s = _block_size(bw, s)
        dtype = _torch_dtype(Ax.dtype if dtype is None else dtype)
        obj = object.__new__(cls)
        obj._build(n, s, -(-n // s), bw, perm, dtype, a,
                   resolve_device(device))
        return obj

    def _build(self, n, s, nb, bw, perm, dtype, a, device):
        Ap, Ai, _ = a.np_arrays()
        pinv = np.empty(n, dtype=np.int64)
        pinv[perm] = np.arange(n, dtype=np.int64)
        cols = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(np.asarray(Ap)))
        r = pinv[np.asarray(Ai, dtype=np.int64)]
        c = pinv[cols]
        # each entry's row and column in block space, for the gradient
        self._rc = torch.as_tensor(np.stack([r, c]), device=device)
        kb_r, kb_c = r // s, c // s
        d = kb_r - kb_c
        if (np.abs(d) > 1).any():
            raise ValueError("pattern exceeds the plan's block tridiagonal")
        # the stacks as one flat buffer [D | E | F]; D_k, E_k and F_k all
        # live at the entry's ROW block kb_r
        which = np.where(d == 0, 0, np.where(d == 1, 1, 2))
        idx = which * (nb * s * s) + kb_r * (s * s) + (r % s) * s + (c % s)
        pad = np.arange(n, nb * s, dtype=np.int64)
        pad_idx = (pad // s) * (s * s) + (pad % s) * s + (pad % s)
        self._idx = torch.as_tensor(idx, device=device)
        self._pad_idx = torch.as_tensor(pad_idx, device=device)
        self._perm = torch.as_tensor(np.asarray(perm, dtype=np.int64),
                                     device=device)
        self._dtype = dtype
        self._aux = (n, s, nb, bw)

    @property
    def device(self) -> torch.device:
        return self._idx.device

    def __call__(self, data) -> BandedLU:
        """A factored ``BandedLU`` of ``data`` (nnz,); for ``data`` (K,
        nnz), one matrix per scenario, a ``batched`` one whose (nb, K, s,
        s) stacks hold all K, factored block by block together.  When
        ``data`` requires a gradient (and grad mode is on), the plan keeps
        it, and its solves are differentiable in it."""
        data = torch.as_tensor(data, device=self.device)
        with torch.inference_mode():
            lu = self._factor(data)
        if _wants_grad(data):
            lu.values, lu._pattern = data, tuple(self._rc)
        return lu

    def _factor(self, data) -> BandedLU:
        n, s, nb, bw = self._aux
        data = data.to(self._dtype)
        lead = data.shape[:-1]
        buf = torch.zeros(lead + (3 * nb * s * s,), dtype=self._dtype,
                          device=self.device)
        buf.index_add_(-1, self._idx, data)
        # the padded rows hold no entry: their unit diagonal is a fill
        buf.index_fill_(-1, self._pad_idx, 1)
        if lead:
            # (K, 3, nb, s, s) -> three (nb, K, s, s) views: a factor step
            # takes block k of every scenario at once
            D, E, F = buf.view(-1, 3, nb, s, s).permute(1, 2, 0, 3, 4)
        else:
            D, E, F = buf.view(3, nb, s, s)
        eh, si, uh = thomas_factor_device(D, E, F)
        return BandedLU._from_stacks(eh, si, uh, self._perm, n, s, bw)

    # drop-in for linalg.RefactorPlan's interface
    refactor = __call__


class BandedSolvePlan:
    """x = A^{-1} b by block-bidiagonal L / U sweeps on the device.

    Built from the host factors of a no-row-exchange factorization
    (``SparseLU`` with ordering='rcm', tol=0): the inverses of L's and U's
    diagonal blocks (``linv``, ``uinv``, inverted on the host in float64)
    and their off-diagonal blocks (``lsub``, ``usup``), uploaded at build to
    ``device`` (None: ``config.default_device()``).  Raises ``ValueError``
    when the factors are not banded enough for the block size.
    """

    def __init__(self, host, s: int | None = None, dtype=None, device=None):
        n = host.n
        bw = max(bandwidth(host.Lp, host.Li), bandwidth(host.Up, host.Ui))
        if s is None:
            s = max(8, -(-bw // 8) * 8)
        if s < bw:
            raise ValueError(f"block size {s} < factor bandwidth {bw}")
        dtype = host.Lx.dtype if dtype is None else _np_dtype(dtype)
        Ld, Lo = _dense_blocks(n, host.Lp, host.Li, host.Lx, s, lower=True,
                               dtype=dtype)
        Ud, Uo = _dense_blocks(n, host.Up, host.Ui, host.Ux, s, lower=False,
                               dtype=dtype)
        dev = resolve_device(device)

        def up(m):
            return torch.as_tensor(np.ascontiguousarray(m), device=dev)

        self.n = n
        self.s = s
        self.linv = up(_inv(Ld))
        self.lsub = up(Lo)
        self.uinv = up(_inv(Ud))
        self.usup = up(Uo)
        self.perm_r = up(np.asarray(host.perm_r, dtype=np.int64))
        self.perm_c = up(np.asarray(host.perm_c, dtype=np.int64))

    @property
    def device(self) -> torch.device:
        return self.linv.device

    @property
    def nblocks(self) -> int:
        return int(self.linv.shape[0])

    #: a plan over host factors: no values to differentiate
    values = None
    batched = False

    def blocks(self, b):
        """Permute (perm_r) and zero-pad an (n,) / (n, B) right-hand side
        into block form (nb, s, B) on the plan's device."""
        b = torch.as_tensor(b, device=self.device)
        if b.ndim == 1:
            b = b[:, None]
        n, s, nb = self.n, self.s, self.nblocks
        dt = torch.promote_types(self.linv.dtype, b.dtype)
        with _recorded(b):
            bp = torch.zeros((nb * s, b.shape[1]), dtype=dt,
                             device=self.device)
            bp[:n] = b[self.perm_r]
            return bp.view(nb, s, -1)

    def solve_blocks(self, bb):
        """Solve in block space, (nb, s, B) -> (nb, s, B), in full
        precision: per block of L one ``addmm_`` and one ``mm``
        (x_k = Linv_k (b_k - Lsub_k x_{k-1})), then likewise up U.
        Differentiable in bb (``_BlockSolve``, whose backward is
        ``solve_blocks_adjoint``) when it requires a gradient."""
        if _wants_grad(bb):
            return _BlockSolve.apply(self, bb, None, "highest")
        return self._sweeps(bb)

    @torch.inference_mode()
    def _sweeps(self, bb, precision="highest"):
        bb, stacks = _common(bb, self.linv, self.lsub, self.uinv, self.usup)
        linv, lsub, uinv, usup = (m.unbind(0) for m in stacks)
        nb = bb.shape[0]
        with _matmul_precision("highest"):
            w = bb.clone()
            y = torch.empty_like(w)
            ws, ys = w.unbind(0), y.unbind(0)
            for k in range(nb):
                if k:
                    ws[k].addmm_(lsub[k], ys[k - 1], alpha=-1)
                torch.mm(linv[k], ws[k], out=ys[k])
            # back substitution, into w (no longer read)
            for k in range(nb - 1, -1, -1):
                if k < nb - 1:
                    ys[k].addmm_(usup[k], ws[k + 1], alpha=-1)
                torch.mm(uinv[k], ys[k], out=ws[k])
        return w

    @torch.inference_mode()
    def solve_blocks_adjoint(self, gg):
        """(LU)^{-T} gg in block space through the same blocks: up U^T,
        v_k = Uinv_k^T (g_k - Usup_{k-1}^T v_{k-1}), then down L^T, w_k =
        Linv_k^T (v_k - Lsub_{k+1}^T w_{k+1}).  The transpose is plain."""
        gg, stacks = _common(gg, self.linv, self.lsub, self.uinv, self.usup)
        linv, lsub, uinv, usup = (m.unbind(0) for m in stacks)
        nb = gg.shape[0]
        with _matmul_precision("highest"):
            v = gg.clone()
            w = torch.empty_like(v)
            vs, ws = v.unbind(0), w.unbind(0)
            for k in range(nb):
                if k:
                    vs[k].addmm_(usup[k - 1].mT, ws[k - 1], alpha=-1)
                torch.mm(uinv[k].mT, vs[k], out=ws[k])
            for k in range(nb - 1, -1, -1):
                if k < nb - 1:
                    ws[k].addmm_(lsub[k + 1].mT, vs[k + 1], alpha=-1)
                torch.mm(linv[k].mT, ws[k], out=vs[k])
        return v

    def _sweeps_adjoint(self, gg, precision):
        return self.solve_blocks_adjoint(gg)

    def unblocks(self, z):
        """Inverse of ``blocks`` on the solution side (perm_c)."""
        with _recorded(z):
            zf = z.reshape(self.nblocks * self.s, -1)[: self.n]
            return torch.empty_like(zf).index_copy_(0, self.perm_c, zf)

    def __call__(self, b):
        x = self.unblocks(self.solve_blocks(self.blocks(b)))
        return x[:, 0] if np.ndim(b) == 1 else x
