"""Supernodal device LU refactorization: dense panels, batched per level.

The JAX package's ``csparse3_tpu/linalg/supernodal.py``.  The level-
scheduled ``RefactorPlan`` re-executes the elimination DAG one entry at a
time; this plan groups columns with identical L structure into supernodes
and re-executes the factorization as a topological sweep of dense panel
operations, batched over the supernodes of each level of the supernodal
elimination tree:

    gather   the (r, w) L panel and the (w, r) U panel values
    factor   the (w, w) diagonal block, no pivoting
    solve    L21 = B U11^{-1},  U12 = L11^{-1} C
    update   W = L21 @ U12, scatter-added into the ancestors

Pivot order is FROZEN from the host factorization (the contract of
``RefactorPlan``): this needs a no-row-exchange host factor
(``splu(..., tol=0)``) of a structurally symmetric pattern, which power-
system matrices give.

The host build is the JAX package's numpy, copied; the device work is
torch ops.  The plan factors in the floating dtype of the values it is
given (the JAX package, with x64 on, promotes float32 values to the host
factors' float64).  Its products run without TF32: the port leaves
``torch.backends.cuda.matmul.allow_tf32`` at its default, False, as the
JAX package runs its fronts at ``default_matmul_precision('highest')``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..ops.matvec import _cast_grad, _wants_grad
from .lu_host import HostLU
from .refactor import attach_solve_templates, retarget_solve_plan

__all__ = ["SupernodalRefactor"]


def _pattern_symmetric(n, Lp, Li, Up, Ui) -> bool:
    """pattern(U) == pattern(L)^T (the no-pivot structurally-symmetric
    invariant this schedule relies on)."""
    if len(Li) != len(Ui):
        return False
    colsL = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
    colsU = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
    kL = np.sort(colsL * (n + 1) + Li)          # L entries (row, col)
    kU = np.sort(Ui * (n + 1) + colsU)          # U entries transposed
    return np.array_equal(kL, kU)


def _sub_product_(C, A, B):
    """C -= A @ B in place, for (nb, r, c) stacks (one ``baddbmm_``) or
    stacks with more leading axes, such as one per scenario (``matmul``):
    ``baddbmm_`` takes 3-D operands only, and a strided (K, nb, r, c) view
    cannot be flattened to 3-D without a copy that the in-place update
    would be lost in."""
    if C.ndim == 3:
        return C.baddbmm_(A, B, alpha=-1)
    return C.sub_(A @ B)


def _lu_nopiv_unblocked_(M):
    """In-place no-pivot LU of a batch of (w, w) blocks (Doolittle), with
    any leading axes: the strict lower triangle becomes the L multipliers,
    the upper triangle U.  Step k scales column k below the pivot and
    updates the trailing block by the rank-1 product, the JAX loop's
    arithmetic."""
    w = M.shape[-1]
    for k in range(w - 1):
        M[..., k + 1:, k].div_(M[..., k, k:k + 1])
        M[..., k + 1:, k + 1:].addcmul_(M[..., k + 1:, k:k + 1],
                                        M[..., k:k + 1, k + 1:], value=-1)
    return M


_LU_PANEL = 32


def _lu_nopiv_(M, panel: int = _LU_PANEL):
    """In-place blocked no-pivot LU of (..., nb, w, w) (any strides): the
    unblocked loop on each (panel, panel) diagonal block, then two batched
    triangular solves and one batched product per panel (right-looking)."""
    w = M.shape[-1]
    if w <= panel:
        return _lu_nopiv_unblocked_(M)
    for k0 in range(0, w, panel):
        k1 = min(k0 + panel, w)
        Mkk = _lu_nopiv_unblocked_(M[..., k0:k1, k0:k1])
        if k1 < w:
            below, right = M[..., k1:, k0:k1], M[..., k0:k1, k1:]
            # L21 Ukk = below;  Lkk U12 = right (Lkk unit lower)
            L21 = torch.linalg.solve_triangular(Mkk, below, upper=True,
                                                left=False)
            U12 = torch.linalg.solve_triangular(Mkk, right, upper=False,
                                                unitriangular=True)
            below.copy_(L21)
            right.copy_(U12)
            _sub_product_(M[..., k1:, k1:], L21, U12)
    return M


def _front_adjoint(M, L21, U12, gM, gL21, gU12, gS=None, perm=None):
    """The adjoint of one batch of dense fronts, (..., nb, .) stacks.

    Forward: M = L\\U packed (L unit lower) with D[perm] = L U (D = L U
    without ``perm``), L21 = B U^{-1}, U12 = L^{-1} C[perm] and S = F22 -
    L21 U12.  Given the gradients gM, gL21, gU12 and gS (None: 0) of those
    outputs, returns (gD, gB, gC); F22's is gS itself.  Batched triangular
    solves and products, conjugate transposes (torch's convention for
    complex values); the pivot order is a constant, as in
    ``jax.lax.linalg.lu``'s derivative.  With X = L^{-1} dD U^{-1}, dL = L
    tril_{-1}(X) and dU = triu(X) U, hence

      gD = L^{-H} (tril_{-1}(L^H gL) + triu(gU U^H)) U^{-H}."""
    if gS is not None:
        gL21 = gL21 - gS @ U12.mH
        gU12 = gU12 - L21.mH @ gS
    Mh = M.mH
    gB = torch.linalg.solve_triangular(Mh, gL21, upper=False, left=False)
    gC = torch.linalg.solve_triangular(Mh, gU12, upper=True,
                                       unitriangular=True)
    gL = (gM - gC @ U12.mH).tril(-1)
    gU = (gM - L21.mH @ gB).triu()
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    inner = ((M.tril(-1) + eye).mH @ gL).tril(-1) + (gU @ M.triu().mH).triu()
    gD = torch.linalg.solve_triangular(Mh, inner, upper=True,
                                       unitriangular=True)
    gD = torch.linalg.solve_triangular(Mh, gD, upper=False, left=False)
    if perm is not None:
        gD = _unpermute_rows(gD, perm)
        gC = _unpermute_rows(gC, perm)
    return gD, gB, gC


def _unpermute_rows(g, perm):
    """The gradient of D from that of D[perm] (rows scattered back)."""
    return torch.empty_like(g).scatter_(
        -2, perm[..., None].expand(perm.shape + g.shape[-1:]), g)


def _dense_lu_nopiv(D, panel: int = _LU_PANEL):
    """Batched no-pivot LU of (nb, w, w) blocks: returns M with the strict
    lower triangle = L multipliers and the upper triangle = U.  Torch ops
    on any device (``torch.linalg.lu_factor(pivot=False)`` exists only on
    CUDA)."""
    return _lu_nopiv_(D.clone(), panel)


def _graded_ok(w, z):
    """CHOLMOD-style graded amalgamation schedule: merged width w is
    acceptable when the padded-panel zero fraction z stays under the
    width-dependent budget."""
    return ((w <= 4 and z <= 0.85) or (w <= 8 and z <= 0.6)
            or (w <= 16 and z <= 0.4) or z <= 0.25)


def _fundamental_partition(n, Lp, Li):
    """Fundamental supernode boundaries + the column etree parents.

    Returns (fstarts, parent, cnt): fstarts includes the n sentinel;
    parent[j] = first off-diagonal row of column j (n = root); a
    boundary falls wherever struct(col j) != struct(col j-1) minus the
    pivot row."""
    cnt = np.diff(Lp)
    parent = np.full(n, n, dtype=np.int64)
    for j in range(n):
        if cnt[j] > 1:
            parent[j] = Li[Lp[j] + 1]
    fstarts = [0]
    for j in range(1, n):
        fundamental = (parent[j - 1] == j and cnt[j] == cnt[j - 1] - 1)
        if not fundamental:
            fstarts.append(j)
    fstarts.append(n)
    return fstarts, parent, cnt


def _values_dtype(new_data, plan_dtype):
    """The dtype a plan factors in: the values' own floating dtype, else
    the host factors'."""
    return new_data.dtype if new_data.is_floating_point() else plan_dtype


class _PanelFactor(torch.autograd.Function):
    """X of ``plan``'s panel loop, differentiable in the values.  The
    forward is the loop; it keeps the final X, which holds every level's
    factored panels (a level writes its own snodes' cells once, and later
    levels scatter only into higher ones).  The backward walks the levels
    in reverse with G = dL/dX: the Schur scatter passes G[pT] through as
    the fronts' gS, the writes hand G[pLw] / G[pUw] to (M, L21, U12) and
    clear them, ``_front_adjoint`` gives the panels' gradient, which the
    gathers add back at pL / pU.  The constant slots and the padded
    columns get no gradient; dL/dvalues = G[a_dst]."""

    @staticmethod
    def forward(ctx, plan, new_data):
        X = plan._factor_(plan._assembled(new_data))
        ctx.plan, ctx.d_dtype = plan, new_data.dtype
        ctx.save_for_backward(X)
        return X

    @staticmethod
    def backward(ctx, gX):
        plan = ctx.plan
        X, = ctx.saved_tensors
        nz = plan.lnz + plan.unz
        G = gX.clone(memory_format=torch.contiguous_format)
        G[nz:] = 0                    # the constant slots and the sink
        for (pL, pLw, pU, pUw, pT, colmask), w in zip(
                reversed(plan.levels), reversed(plan.level_widths)):
            P = X[pL]
            Q = X[pU]
            gP, gQ = G[pLw], G[pUw]
            gS = G[pT]
            G[pLw.reshape(-1)] = 0
            G[pUw.reshape(-1)] = 0
            gD, gB, gC = _front_adjoint(
                plan._diag_block(P, Q, colmask, w), P[:, w:, :],
                Q[:, :, w:], gP[:, :w, :].tril(-1) + gQ[:, :, :w].triu(),
                gP[:, w:, :], gQ[:, :, w:], gS)
            G.index_add_(0, pL.reshape(-1),
                         torch.cat([gD.tril(-1), gB], dim=1).reshape(-1))
            G.index_add_(0, pU.reshape(-1),
                         torch.cat([gD.triu(), gC], dim=2).reshape(-1))
        return None, _cast_grad(G[plan.a_dst], ctx.d_dtype)


class SupernodalRefactor(nn.Module):
    """values -> (Lx, Ux) (and a SolvePlan) on ``device`` (None:
    ``config.default_device()``, the CUDA card), via batched dense
    supernodal panels.

    Built once from a no-row-exchange host factorization and the matrix it
    factored.  ``refactor(new_data)`` returns a level-scheduled
    ``SolvePlan`` like ``RefactorPlan.refactor`` (the solve plumbing is
    shared).
    """

    def __init__(self, host: HostLU, a_csc, relax: int = 1, device=None):
        """``relax`` caps the amalgamated supernode width (1, the default,
        keeps fundamental supernodes only)."""
        super().__init__()
        device = resolve_device(device)
        n = host.n
        Lp = np.asarray(host.Lp, dtype=np.int64)
        Li = np.asarray(host.Li, dtype=np.int64)
        Up = np.asarray(host.Up, dtype=np.int64)
        Ui = np.asarray(host.Ui, dtype=np.int64)
        if not _pattern_symmetric(n, Lp, Li, Up, Ui):
            raise ValueError(
                "supernodal refactorization needs a structurally "
                "symmetric factor pattern (no-row-exchange factorization "
                "of a structurally symmetric matrix); use RefactorPlan")
        lnz, unz = len(Li), len(Ui)
        colsL = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
        colsU = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
        key = n + 1
        keysL = colsL * key + Li
        keysU = colsU * key + Ui

        def posL(r, c):
            k = np.asarray(c) * key + r
            p = np.searchsorted(keysL, k)
            if not np.array_equal(keysL[np.minimum(p, lnz - 1)], k):
                raise AssertionError(
                    "supernodal schedule referenced an absent L entry "
                    "(pattern not symmetric-fill-closed)")
            return p

        def posU(r, c):
            k = np.asarray(c) * key + r
            p = np.searchsorted(keysU, k)
            if not np.array_equal(keysU[np.minimum(p, unz - 1)], k):
                raise AssertionError(
                    "supernodal schedule referenced an absent U entry "
                    "(pattern not symmetric-fill-closed)")
            return lnz + p

        # Tolerant twins for relaxed (amalgamated) panels: an absent
        # position gathers from D0 (reads 0) / scatters to TRASH.  Safe
        # because fill-closure makes every contribution to an absent
        # position exactly zero: L(r,k)!=0 and U(k,c)!=0 would force
        # (r,c) into the pattern.
        def posL_opt(r, c):
            k = np.asarray(c) * key + r
            p = np.minimum(np.searchsorted(keysL, k), lnz - 1)
            return p, keysL[p] == k

        def posU_opt(r, c):
            k = np.asarray(c) * key + r
            p = np.minimum(np.searchsorted(keysU, k), unz - 1)
            return lnz + p, keysU[p] == k

        # ---- supernode partition: fundamental pass ---------------------
        fstarts, parent, cnt = _fundamental_partition(n, Lp, Li)

        # ---- relaxed amalgamation: greedily merge CONTIGUOUS fundamental
        # snodes while the merged dense panel stays mostly nonzero
        starts = [0]
        srows = []
        if relax and relax > 1 and len(fstarts) > 2:
            cur_a, cur_b = fstarts[0], fstarts[1]
            cur_R = Li[Lp[cur_a]:Lp[cur_a + 1]]
            cur_ent = int(Lp[cur_b] - Lp[cur_a])
            for k in range(1, len(fstarts) - 1):
                a2, b2 = fstarts[k], fstarts[k + 1]
                R2 = Li[Lp[a2]:Lp[a2 + 1]]
                w_new = int(b2 - cur_a)
                R_new = np.union1d(cur_R, R2)
                ent_new = cur_ent + int(Lp[b2] - Lp[a2])
                z = 1.0 - ent_new / max(len(R_new) * w_new, 1)
                if w_new <= relax and _graded_ok(w_new, z):
                    cur_b, cur_R, cur_ent = b2, R_new, ent_new
                else:
                    starts.append(int(a2))
                    srows.append(cur_R)
                    cur_a, cur_b, cur_R = a2, b2, R2
                    cur_ent = int(Lp[b2] - Lp[a2])
            srows.append(cur_R)
        else:
            starts = fstarts[:-1]
            srows = [Li[Lp[s]:Lp[s + 1]] for s in starts]
        starts.append(n)
        ns_total = len(starts) - 1
        snode_of = np.empty(n, dtype=np.int64)
        for s in range(ns_total):
            snode_of[starts[s]:starts[s + 1]] = s

        # Level schedule over UPDATE TARGETS: snode s scatters into every
        # column/row index in its off-block rows, so each of those snodes
        # must sit at a strictly higher level.
        lev = np.zeros(ns_total, dtype=np.int64)
        for s in range(ns_total):
            w = starts[s + 1] - starts[s]
            off = srows[s][w:]
            if len(off):
                np.maximum.at(lev, snode_of[off], lev[s] + 1)
        # ---- A assembly map (same storage convention as RefactorPlan) --
        pinv = np.empty(n, dtype=np.int64)
        pinv[np.asarray(host.perm_r)] = np.arange(n)
        qinv = np.empty(n, dtype=np.int64)
        qinv[np.asarray(host.perm_c)] = np.arange(n)
        ip, rows, _ = a_csc.np_arrays()
        acols = np.repeat(np.arange(n), np.diff(np.asarray(ip)))
        k_of = qinv[acols]
        pr = pinv[np.asarray(rows, dtype=np.int64)]
        up = pr <= k_of
        a_dst = np.empty(len(pr), dtype=np.int64)
        a_dst[up] = posU(pr[up], k_of[up])
        a_dst[~up] = posL(pr[~up], k_of[~up])

        D0 = lnz + unz + 1   # constant 0 slot (safe gather source)
        TRASH = lnz + unz + 2  # scatter sink (never read)

        def dev(a, dtype=torch.int64):
            return torch.as_tensor(a, dtype=dtype, device=device)

        # ---- per-level padded index stacks -----------------------------
        levels = []
        level_widths = []
        for L in range(int(lev.max()) + 1 if ns_total else 0):
            sids = [s for s in range(ns_total) if lev[s] == L]
            w_max = max(starts[s + 1] - starts[s] for s in sids)
            # sub-diagonal rows align at w_max in the padded panel, so the
            # padded height is w_max + max over snodes of (r_s - w_s)
            u_max = max(max(len(srows[s]) - (starts[s + 1] - starts[s])
                            for s in sids), 1)
            nb = len(sids)
            pL = np.full((nb, w_max + u_max, w_max), D0, dtype=np.int64)
            pLw = np.full((nb, w_max + u_max, w_max), TRASH,
                          dtype=np.int64)
            pU = np.full((nb, w_max, w_max + u_max), D0, dtype=np.int64)
            pUw = np.full((nb, w_max, w_max + u_max), TRASH,
                          dtype=np.int64)
            pT = np.full((nb, u_max, u_max), TRASH, dtype=np.int64)
            colmask = np.zeros((nb, w_max), dtype=bool)
            for b, s in enumerate(sids):
                j1, j2 = starts[s], starts[s + 1]
                w = j2 - j1
                R = srows[s]
                r = len(R)
                colmask[b, :w] = True

                def _row_slot(i):
                    return np.where(i < w, i, w_max + (i - w))

                for jj in range(w):
                    c = j1 + jj
                    sub = Li[Lp[c]:Lp[c + 1]]
                    loc = _row_slot(np.searchsorted(R, sub))
                    pos = Lp[c] + np.arange(len(sub))
                    pL[b, loc, jj] = pos
                    pLw[b, loc, jj] = pos
                    tgt = R[R >= c]
                    loci = _row_slot(np.searchsorted(R, tgt))
                    pu, oku = posU_opt(np.full(len(tgt), c), tgt)
                    pU[b, jj, loci[oku]] = pu[oku]
                    pUw[b, jj, loci[oku]] = pu[oku]
                if r > w:
                    rr = R[w:]
                    RI, CK = np.broadcast_arrays(rr[:, None], rr[None, :])
                    below = RI > CK
                    pLt, okL = posL_opt(RI, CK)
                    pUt, okU = posU_opt(RI, CK)
                    tpos = np.where(below, np.where(okL, pLt, TRASH),
                                    np.where(okU, pUt, TRASH))
                    pT[b, :r - w, :r - w] = tpos
            levels.append((dev(pL), dev(pLw), dev(pU), dev(pUw), dev(pT),
                           dev(colmask, torch.bool)))
            level_widths.append(w_max)
        self.n = n
        self.lnz, self.unz = lnz, unz
        self.dtype = torch.as_tensor(host.Lx[:0]).dtype
        self.nsnodes = ns_total
        self.nlevels = len(levels)
        self.levels = levels
        self.level_widths = tuple(level_widths)
        self.register_buffer("a_dst", dev(a_dst))
        self.register_buffer("l_unit", dev(posL(np.arange(n), np.arange(n))))
        self.register_buffer("perm_r", dev(np.asarray(host.perm_r)))
        self.register_buffer("perm_c", dev(np.asarray(host.perm_c)))
        attach_solve_templates(self, host, device, a_csc)

    def _assembled(self, new_data):
        """X before the panel loop: A's values at their cells, L's unit
        diagonal, the constant slots; X[nz + 2] is the scatter sink."""
        dtype = _values_dtype(new_data, self.dtype)
        nz = self.lnz + self.unz
        X = torch.zeros(nz + 3, dtype=dtype, device=new_data.device)
        X[nz] = 1                                  # D1
        X[self.l_unit] = 1
        X.index_add_(0, self.a_dst, new_data.to(dtype))
        return X

    def _diag_block(self, P, Q, colmask, w):
        """The (nb, w, w) fully-summed block of a level's panels: the
        diagonal block appears in both panels, its upper part from the U
        rows, its strict lower from the L columns; padded columns get a
        unit diagonal so the block stays nonsingular."""
        return (Q[:, :, :w].triu() + P[:, :w, :].tril(-1)
                + torch.diag_embed((~colmask).to(P.dtype)))

    def _factor_(self, X):
        """The panel loop, in place on X."""
        nz = self.lnz + self.unz
        for (pL, pLw, pU, pUw, pT, colmask), w in zip(
                self.levels, self.level_widths):
            P = X[pL]                     # (nb, r, w)
            Q = X[pU]                     # (nb, w, r)
            M = _lu_nopiv_(self._diag_block(P, Q, colmask, w))
            B = P[:, w:, :]               # (nb, r-w, w)
            C = Q[:, :, w:]               # (nb, w, r-w)
            L21 = torch.linalg.solve_triangular(M, B, upper=True, left=False)
            U12 = torch.linalg.solve_triangular(M, C, upper=False,
                                                unitriangular=True)
            eye = torch.eye(w, dtype=X.dtype, device=X.device)
            X[pLw.reshape(-1)] = torch.cat(
                [M.tril(-1) + eye, L21], dim=1).reshape(-1)
            X[pUw.reshape(-1)] = torch.cat([M.triu(), U12],
                                           dim=2).reshape(-1)
            X.index_add_(0, pT.reshape(-1), (L21 @ U12).reshape(-1),
                         alpha=-1)
            # keep the constant slots clean for the next level
            X[nz] = 1
            X[nz + 1] = 0
        return X

    def factor_values(self, new_data):
        """(Lx, Ux) for the original pattern with ``new_data`` values.
        Differentiable (``_PanelFactor``) in ``new_data`` when it requires
        a gradient; every other call runs under inference mode."""
        new_data = torch.as_tensor(new_data, device=self.a_dst.device)
        nz = self.lnz + self.unz
        if _wants_grad(new_data):
            X = _PanelFactor.apply(self, new_data)
            return X[: self.lnz], X[self.lnz: nz]
        with torch.inference_mode():
            X = self._factor_(self._assembled(new_data))
            return X[: self.lnz], X[self.lnz: nz]

    def refactor(self, new_data, with_diag: bool = False):
        """SolvePlan with fresh numeric factors (same contract as
        RefactorPlan.refactor, gradients included; the slab retargeting is
        shared)."""
        Lx, Ux = self.factor_values(new_data)
        return retarget_solve_plan(self, Lx, Ux, with_diag, values=new_data)
