"""Single-device iterative (Krylov) solvers, as the JAX package's
``csparse3_tpu/linalg/iterative.py``: conjugate gradients, BiCGSTAB,
restarted GMRES, the Jacobi and exact-LU preconditioners, and mixed-
precision iterative refinement.

Every solver takes the matrix as a callable ``A(v) -> A v`` (an
``SpMVPlan``, a ``DIAPlan`` / ``SymDIAPlan``, whose product on a CUDA
tensor is the DIA kernel, or any function) and a preconditioner
``M(r) -> M^{-1} r``, and works on tensors on their device.  The JAX
package's loops are ``lax.while_loop`` / ``scan`` state machines; here they
are Python loops over device tensors, and the stop test of each iteration
(each GMRES cycle) is one host read of a scalar, as in
``NewtonPowerFlow.run``.  Everything else stays on the device, the GMRES
Hessenberg matrix and its Givens rotations included.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops.matvec import _recorded

__all__ = ["cg", "bicgstab", "gmres", "jacobi_prec", "ilu0_prec", "refine"]

_TINY = 1e-300


def _noop(x):
    return x


def _vdot(u, v):
    """sum(conj(u) * v) over every entry (``jnp.vdot``), a 0-d tensor."""
    return torch.vdot(u.reshape(-1), v.reshape(-1))


def _start(A, b, x0):
    b = torch.as_tensor(b)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(
        x0, device=b.device).to(b.dtype)
    return b, x, b - A(x)


@torch.inference_mode()
def cg(A, b, x0=None, M=None, tol=1e-10, maxiter=1000):
    """Preconditioned conjugate gradients for SPD / HPD systems.

    A, M: callables v -> A v and r -> M^{-1} r.  Stops when ||r|| <=
    tol * ||b|| or after ``maxiter`` iterations.  Returns (x, residual
    norm (0-d tensor), iterations)."""
    M = M or _noop
    b, x, r = _start(A, b, x0)

    def dot(u, v):
        return _vdot(u, v).real

    stop2 = (max(float(dot(b, b)) ** 0.5, _TINY) * tol) ** 2
    z = M(r)
    p, rz, rr = z, dot(r, z), dot(r, r)
    it = 0
    while it < maxiter and float(rr) > stop2:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz, rr = rz_new, dot(r, r)
        it += 1
    return x, rr.sqrt(), it


@torch.inference_mode()
def bicgstab(A, b, x0=None, M=None, tol=1e-10, maxiter=1000):
    """Preconditioned BiCGSTAB for general square systems.  Returns (x,
    residual norm (0-d tensor), iterations)."""
    M = M or _noop
    b, x, r = _start(A, b, x0)
    rhat = r
    stop2 = (max(float(_vdot(b, b).real) ** 0.5, _TINY) * tol) ** 2
    one = torch.ones((), dtype=r.dtype, device=r.device)
    rho = alpha = omega = one
    p = v = torch.zeros_like(r)
    rr = _vdot(r, r).real
    it = 0
    while it < maxiter and float(rr) > stop2:
        rho_new = _vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _vdot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = _vdot(t, s) / _vdot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        rr = _vdot(r, r).real
        it += 1
    return x, rr.sqrt(), it


def _givens(a, b):
    """(c, s, r) with [[conj(c), conj(s)], [-s, c]] @ [a, b] = [r, 0] and
    the matrix unitary; (1, 0, a) when a = b = 0."""
    h = torch.sqrt(a.abs() ** 2 + b.abs() ** 2)
    safe = torch.where(h > 0, h, torch.ones_like(h))
    c = torch.where(h > 0, a / safe, torch.ones_like(a))
    s = torch.where(h > 0, b / safe, torch.zeros_like(b))
    return c, s, h.to(a.dtype)


@torch.inference_mode()
def gmres(A, b, x0=None, M=None, tol=1e-10, restart=30, maxiter=100):
    """Restarted GMRES(m), left preconditioned, with modified Gram-Schmidt
    Arnoldi.

    Each cycle takes ``restart`` Arnoldi steps into a (restart + 1, n)
    basis on the device, then solves the small least-squares problem
    min ||beta e1 - H y|| by Givens rotations applied to each new column
    of H as it is made (device 0-d tensors, no host read), and recomputes
    the true residual.  Stops when ||b - A x|| <= tol * ||b|| or after
    ``maxiter`` cycles.  Returns (x, residual norm (0-d tensor), cycles)."""
    M = M or _noop
    b, x, r0 = _start(A, b, x0)
    n, m = b.shape[0], int(restart)
    bnrm = max(float(torch.linalg.vector_norm(b)), _TINY)
    dt = b.dtype

    def cycle(x):
        r = M(b - A(x))
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros((m + 1, n), dtype=dt, device=b.device)
        R = torch.zeros((m + 1, m), dtype=dt, device=b.device)
        cs = torch.zeros(m, dtype=dt, device=b.device)
        sn = torch.zeros(m, dtype=dt, device=b.device)
        g = torch.zeros(m + 1, dtype=dt, device=b.device)
        g[0] = beta
        V[0] = r / torch.clamp(beta, min=_TINY)
        for j in range(m):
            w = M(A(V[j]))
            h = torch.zeros(m + 1, dtype=dt, device=b.device)
            for i in range(j + 1):
                hij = _vdot(V[i], w)
                w = w - hij * V[i]
                h[i] = hij
            hnorm = torch.linalg.vector_norm(w)
            h[j + 1] = hnorm
            V[j + 1] = w / torch.clamp(hnorm, min=_TINY)
            # the rotations so far, then a new one that zeroes h[j + 1]
            for i in range(j):
                hi, hi1 = h[i].clone(), h[i + 1].clone()
                h[i] = cs[i].conj() * hi + sn[i].conj() * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            c, s, rr = _givens(h[j], h[j + 1])
            cs[j], sn[j] = c, s
            h[j], h[j + 1] = rr, 0
            gj = g[j].clone()
            g[j] = c.conj() * gj
            g[j + 1] = -s * gj
            R[:, j] = h
        # R y = g[:m]; a zero pivot (the Krylov space closed early) takes
        # y_j = 0, the least-squares solution of least norm
        Rm = R[:m]
        d = torch.diagonal(Rm)
        live = d != 0
        Rm = Rm + torch.diag(torch.where(live, torch.zeros_like(d),
                                         torch.ones_like(d)))
        rhs = torch.where(live, g[:m], torch.zeros_like(g[:m]))
        y = torch.linalg.solve_triangular(Rm, rhs[:, None], upper=True)[:, 0]
        x = x + V[:m].T @ y
        return x, torch.linalg.vector_norm(b - A(x))

    res = torch.linalg.vector_norm(r0)
    it = 0
    while it < maxiter and float(res) > tol * bnrm:
        x, res = cycle(x)
        it += 1
    return x, res, it


# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

def jacobi_prec(a, device=None):
    """Diagonal (Jacobi) preconditioner of a CSC matrix on ``device``
    (None: where ``a`` was placed, else ``config.default_device()``, the
    CUDA card): r -> r / diag(A), zero diagonal entries taken as 1."""
    from ..ops.reductions import diagonal

    d = diagonal(a.to(resolve_device(device, a)))
    dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d,
                                                 torch.ones_like(d)),
                       torch.ones_like(d))
    return lambda r: dinv * r


def ilu0_prec(a, ordering="natural", device=None):
    """Exact LU of ``a`` applied as the device level-scheduled solve plan
    on ``device`` (None: ``config.default_device()``): for moderate fill
    the complete factorization serves as the preconditioner, as in the JAX
    package."""
    from .lu import splu

    return splu(a, ordering=ordering).solve_plan(device=device)


def refine(solve, matvec, b, iters: int = 2):
    """Mixed-precision iterative refinement: x = solve(b), then ``iters``
    sweeps of x += solve(b - A x).

    The LAPACK dsgesv pattern: factor in a low precision (an f32
    ``BandedLU``), compute the residual in the working precision that
    ``matvec`` and ``b`` set (f64), and each sweep multiplies the error by
    O(eps_factor * kappa(A)) down to the working precision's floor.  The
    residual must be in the higher precision: refining an all-f32 chain
    only adds f32 rounding.  ``solve`` / ``matvec`` are any callables; b is
    (n,) or (n, k).  The corrections are cast to b's dtype.  Differentiable
    in b, as the JAX package's scan, when b requires a gradient and the
    callables are (the plans are); else under inference mode."""
    b = torch.as_tensor(b)
    with _recorded(b):
        x = solve(b).to(b.dtype)
        for _ in range(int(iters)):
            x = x + solve(b - matvec(x)).to(b.dtype)
        return x
